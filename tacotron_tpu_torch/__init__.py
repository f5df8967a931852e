"""tacotron_tpu_torch — the PyTorch/CUDA port of tacotron_tpu for one NVIDIA
H100 (Hopper, sm_90a).

Plain tensor code is PyTorch; the TPU kernels on the synthesis and
training paths are hand-written CUDA kernels (``csrc/``) with plain PyTorch
versions beside them. Entry points default to the GPU (``device=None``) and raise without
one; pass ``device="cpu"`` for the plain versions.
"""

from tacotron_tpu_torch.config import PRESETS, Config, get_config

__version__ = "0.1.0"
__all__ = ["Config", "get_config", "PRESETS", "__version__"]
