"""Port of tacotron_tpu.cli: ``python -m tacotron_tpu_torch.cli.synthesize``."""
