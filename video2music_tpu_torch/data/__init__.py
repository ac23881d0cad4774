"""Data pipeline of the port: copies of the JAX package's numpy-only
feature parsers, dataset and loader (the loader's device staging copies
batches to a torch device)."""

from .parsers import (parse_chord_lab, parse_emotion_lab, parse_scalar_lab,
                      parse_instrument_csv, load_semantic_npy)
from .dataset import (VevoDataset, create_vevo_datasets, make_sample,
                      mixup_samples, batches)
from .loader import PrefetchLoader, device_prefetch

__all__ = [
    "parse_chord_lab", "parse_emotion_lab", "parse_scalar_lab",
    "parse_instrument_csv", "load_semantic_npy",
    "VevoDataset", "create_vevo_datasets", "make_sample", "mixup_samples",
    "batches", "PrefetchLoader", "device_prefetch",
]
