"""Evaluation metrics of the port (counterpart of train/metrics.py): whole
(B, L) batches at once, with the JAX package's quirks (accuracy and hits@k
are 1.0 when every target is PAD; correspondence is -1.0 when no frame
passes the emotion filter; an emitted "N" counts as quality "maj")."""

from __future__ import annotations

import functools

import torch

from ..core import constants as C
from ..core.vocab import chord_to_root_attr_tables


def _masked_rate(hit, tgt):
    mask = (tgt != C.CHORD_PAD).float()
    denom = mask.sum()
    rate = (hit.float() * mask).sum() / denom.clamp(min=1.0)
    return torch.where(denom == 0, torch.ones_like(rate), rate)


def compute_vevo_accuracy(logits, tgt):
    """Masked top-1 accuracy. logits (B, L, CHORD_SIZE); tgt (B, L)."""
    return _masked_rate(logits.argmax(-1) == tgt, tgt)


def compute_hits_k(logits, tgt, k: int):
    """Hits@k: the target among the top-k logits, over non-PAD targets."""
    topk = logits.topk(k, dim=-1).indices
    return _masked_rate((topk == tgt[..., None]).any(-1), tgt)


@functools.lru_cache(maxsize=None)
def _quality_table(device: str) -> torch.Tensor:
    """chord id -> quality id in 0..13."""
    _, attr_tab = chord_to_root_attr_tables()
    return torch.as_tensor(attr_tab, device=device).long()


def compute_vevo_correspondence(logits, tgt, tgt_emotion, tgt_emotion_prob,
                                emotion_threshold: float = C.EMOTION_THRESHOLD):
    """Fraction of emitted chords whose quality the frame's dominant emotion
    allows; -1.0 when no frame passes the filter. logits (B, L, CHORD_SIZE)
    or (B, L) predictions; tgt_emotion (B, L, CHORD_SIZE);
    tgt_emotion_prob (B, L)."""
    del tgt
    pred = logits.argmax(-1) if logits.dim() >= 3 else logits
    quality = _quality_table(str(pred.device))[
        pred.clamp(0, C.CHORD_SIZE - 1)]
    is_pad_row = tgt_emotion[..., -1] == 1
    all_zero = (tgt_emotion[..., 0:14] == 0).all(-1)
    passes = ~is_pad_row & ~all_zero & (tgt_emotion_prob >= emotion_threshold)
    emittable = (pred != C.CHORD_END) & (pred != C.CHORD_PAD)
    # END / PAD predictions (quality ids 14, 15) are not emittable; clamp
    # their index, whose value is never read
    allowed = tgt_emotion[..., 0:14].gather(
        -1, quality.clamp(max=13)[..., None])[..., 0] == 1
    right = (passes & emittable & allowed).float()
    pt = passes.float().sum()
    rate = right.sum() / pt.clamp(min=1.0)
    return torch.where(pt == 0, torch.full_like(rate, -1.0), rate)
