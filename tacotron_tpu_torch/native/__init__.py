"""Native (C++) host runtime: the batch assembler, bound with ctypes and
built with g++ at first use into ``build/tacotron_tpu_torch/``."""

from tacotron_tpu_torch.native.binding import NativeBatcher, load_batcher

__all__ = ["NativeBatcher", "load_batcher"]
