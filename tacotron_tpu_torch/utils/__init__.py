"""Port of tacotron_tpu.utils: metrics, profiling, roofline accounting and
the TF1 checkpoint converter."""

from tacotron_tpu_torch.utils import profiling, roofline, tf1_converter
from tacotron_tpu_torch.utils.metrics import SummaryWriter, alignment_scores, plot_alignment
from tacotron_tpu_torch.utils.roofline import KernelRoofline, train_step_flops

__all__ = ["SummaryWriter", "alignment_scores", "plot_alignment", "profiling", "roofline",
           "tf1_converter", "KernelRoofline", "train_step_flops"]
