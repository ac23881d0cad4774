"""MoE observability: expert-emotion attribution, MaxVio load-balance logs,
confusion-matrix plots (counterpart of obs/logging.py).

The JAX package reads the counters out of flax's "metrics" collection;
here they live in the MoE modules themselves (ops/moe.py): a training
forward records each layer's ``expert_counts`` and ``maxvio``, and an eval
forward called with ``count_emotions=True`` (models/amt.py) records them
too and adds its selections per (dominant emotion, expert) to
``expert_emotion_counts``. :func:`collect_moe_metrics` walks the model's
MoE modules into the JAX package's ``{layer_path: {metric: array}}``,
under the JAX package's layer paths ("enc_3/ffn", "dec_3/ffn"), so the
sorted order, and so the numbering of ``experts_emotion_count{i}.json``,
is the JAX package's. Every other function takes the model or that dict,
and renders host-side as the JAX package's does (matplotlib imported only
by the plots).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

from ..core.constants import EMOTION_CLASSES

MOE_METRICS = ("expert_counts", "maxvio", "expert_emotion_counts")


def _jax_path(name: str) -> str:
    """A module path of the port ("encoder_layers.3.ffn") as the JAX
    model's ("enc_3/ffn")."""
    name = re.sub(r"^encoder_layers\.(\d+)", r"enc_\1", name)
    name = re.sub(r"^decoder_layers\.(\d+)", r"dec_\1", name)
    return name.replace(".", "/")


def _moe_layers(model):
    from ..ops.moe import MoELayer
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, MoELayer)]


def collect_moe_metrics(model) -> Dict[str, Dict[str, np.ndarray]]:
    """{layer_path: {metric_name: array}} of the model's MoE layers (the
    metrics they recorded; a layer that recorded none is left out). A
    dict passes through, so every function below takes either."""
    if isinstance(model, dict):
        return model
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, layer in _moe_layers(model):
        got = {k: getattr(layer, k).detach().float().cpu().numpy()
               for k in MOE_METRICS if getattr(layer, k) is not None}
        if got:
            out[_jax_path(name)] = got
    return out


def reset_moe_metrics(model) -> None:
    """Forget every MoE layer's recorded metrics and emotion counts."""
    for _, layer in _moe_layers(model):
        layer.reset_metrics()


def _emotion_layers(metrics_tree):
    return [(k, v["expert_emotion_counts"])
            for k, v in sorted(collect_moe_metrics(metrics_tree).items())
            if "expert_emotion_counts" in v]


def save_expert_emotion(metrics_tree, out_dir: str = "log",
                        basename: str = "experts_emotion_count") -> List[str]:
    """Dump per-layer (6, E) expert-emotion counts as JSON files, one per
    MoE layer (reference: log_experts.py:78-96 writes
    experts_emotion_count{i}.json)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (layer, counts) in enumerate(_emotion_layers(metrics_tree)):
        p = os.path.join(out_dir, f"{basename}{i}.json")
        with open(p, "w") as f:
            json.dump({"layer": layer,
                       "emotions": list(EMOTION_CLASSES),
                       "counts": counts.tolist()}, f, indent=2)
        paths.append(p)
    return paths


def plot_expert_emotion_heatmaps(metrics_tree, out_dir: str = "log",
                                 basename: str = "experts_emotion_plot"
                                 ) -> List[str]:
    """Per-layer heatmaps of expert usage by dominant emotion
    (reference: log_experts.py:98-138, seaborn -> matplotlib here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (layer, counts) in enumerate(_emotion_layers(metrics_tree)):
        row_sum = counts.sum(axis=1, keepdims=True)
        norm = np.divide(counts, np.maximum(row_sum, 1e-9))
        fig, ax = plt.subplots(figsize=(1.2 * counts.shape[1] + 2, 5))
        im = ax.imshow(norm, aspect="auto", cmap="viridis")
        ax.set_yticks(range(6), EMOTION_CLASSES)
        ax.set_xticks(range(counts.shape[1]),
                      [f"e{j}" for j in range(counts.shape[1])])
        ax.set_title(f"expert usage by emotion — {layer}")
        for r in range(norm.shape[0]):
            for c in range(norm.shape[1]):
                ax.text(c, r, f"{norm[r, c]:.2f}", ha="center", va="center",
                        color="w", fontsize=8)
        fig.colorbar(im)
        p = os.path.join(out_dir, f"{basename}{i}.png")
        fig.savefig(p, bbox_inches="tight", dpi=100)
        plt.close(fig)
        paths.append(p)
    return paths


class MaxVioLog:
    """Accumulate per-batch MaxVio values and save as .npy
    (reference: third_party/log_maxvio.py:12-55)."""

    def __init__(self):
        self.values: List[float] = []

    def update(self, metrics_tree) -> None:
        for _, v in sorted(collect_moe_metrics(metrics_tree).items()):
            if "maxvio" in v:
                self.values.append(float(v["maxvio"]))

    def save(self, path: str = "log/maxvio.npy") -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.save(path, np.asarray(self.values, np.float32))
        return path


def plot_confusion_matrix(cm: np.ndarray, labels=None, title: str = "",
                          out_path: Optional[str] = None,
                          normalize: bool = True):
    """Render one confusion matrix (reference: run_model_vevo.py:454-566
    saves chord/root/quality matrices as png+npy)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = cm.astype(np.float64)
    if normalize:
        m = m / np.maximum(m.sum(axis=1, keepdims=True), 1e-9)
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(m, cmap="Blues")
    ax.set_title(title)
    ax.set_xlabel("predicted")
    ax.set_ylabel("target")
    if labels is not None and len(labels) <= 20:
        ax.set_xticks(range(len(labels)), labels, rotation=90, fontsize=7)
        ax.set_yticks(range(len(labels)), labels, fontsize=7)
    fig.colorbar(im)
    if out_path:
        fig.savefig(out_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
        return out_path
    return fig


def compare_confusion_matrices(cm_a: np.ndarray, cm_b: np.ndarray,
                               labels=None, names=("run A", "run B"),
                               out_path: Optional[str] = None):
    """Side-by-side comparison of two runs' confusion matrices
    (reference: third_party/plot_conf_matrix.py:84-112)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(21, 6))
    for ax, m, name in zip(axes[:2], (cm_a, cm_b), names):
        mm = m / np.maximum(m.sum(axis=1, keepdims=True), 1e-9)
        ax.imshow(mm, cmap="Blues")
        ax.set_title(name)
    diff = (cm_a / np.maximum(cm_a.sum(1, keepdims=True), 1e-9)
            - cm_b / np.maximum(cm_b.sum(1, keepdims=True), 1e-9))
    im = axes[2].imshow(diff, cmap="RdBu", vmin=-1, vmax=1)
    axes[2].set_title(f"{names[0]} - {names[1]}")
    fig.colorbar(im, ax=axes[2])
    if out_path:
        fig.savefig(out_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
        return out_path
    return fig
