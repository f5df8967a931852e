"""Port of tacotron_tpu.utils (metrics and profiling)."""

from tacotron_tpu_torch.utils.metrics import SummaryWriter, alignment_scores, plot_alignment

__all__ = ["SummaryWriter", "alignment_scores", "plot_alignment"]
