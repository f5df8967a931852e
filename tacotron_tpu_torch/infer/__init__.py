"""Port of tacotron_tpu.infer."""

from tacotron_tpu_torch.infer.synthesize import Synthesizer

__all__ = ["Synthesizer"]
