"""Port of tacotron_tpu.utils."""
