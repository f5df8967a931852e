"""Port of tacotron_tpu.ops."""
