"""Port of tacotron_tpu.data: the same names."""

from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.data.buckets import BucketSpec, make_buckets, assign_bucket
from tacotron_tpu_torch.data.loader import DataLoader, Batch
from tacotron_tpu_torch.data import ljspeech

__all__ = [
    "Vocab",
    "BucketSpec",
    "make_buckets",
    "assign_bucket",
    "DataLoader",
    "Batch",
    "ljspeech",
]
