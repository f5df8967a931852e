"""Port of tacotron_tpu.dsp."""
