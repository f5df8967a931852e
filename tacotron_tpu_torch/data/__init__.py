"""Port of tacotron_tpu.data."""
