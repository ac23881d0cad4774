"""Observability of the port (counterpart of obs/): the MoE layers'
expert-emotion counts and MaxVio logs, confusion-matrix plots, and the
first-party TensorBoard event writer (a copy of the JAX package's)."""

from .logging import (collect_moe_metrics, reset_moe_metrics,
                      save_expert_emotion, plot_expert_emotion_heatmaps,
                      MaxVioLog, plot_confusion_matrix,
                      compare_confusion_matrices)
from .tensorboard import SummaryWriter

__all__ = ["collect_moe_metrics", "reset_moe_metrics", "save_expert_emotion",
           "plot_expert_emotion_heatmaps", "MaxVioLog",
           "plot_confusion_matrix", "compare_confusion_matrices",
           "SummaryWriter"]
