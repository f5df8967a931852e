"""Port of tacotron_tpu.models."""
