"""Evaluation metrics of the port (counterpart of train/metrics.py): whole
(B, L) batches at once, with the JAX package's quirks (accuracy and hits@k
are 1.0 when every target is PAD; correspondence is -1.0 when no frame
passes the emotion filter; an emitted "N" counts as quality "maj"; the
root x attr reconstruction of separated heads applies a second softmax to
the product distribution before top-k), and the regression's per-batch
sums."""

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


@functools.lru_cache(maxsize=None)
def _root_attr_index(device: str):
    """chord id -> (root id, attr id): i in 1..156 -> (1 + (i-1)//13,
    1 + (i-1)%13); 0 -> (0, 0); END -> (ROOT_END, ATTR_END); PAD ->
    (ROOT_PAD, ATTR_PAD)."""
    ids = torch.arange(C.CHORD_SIZE)
    root = torch.where(ids == 0, 0, (ids - 1) // 13 + 1)
    attr = torch.where(ids == 0, 0, (ids - 1) % 13 + 1)
    root[C.CHORD_END], attr[C.CHORD_END] = C.CHORD_ROOT_END, C.CHORD_ATTR_END
    root[C.CHORD_PAD], attr[C.CHORD_PAD] = C.CHORD_ROOT_PAD, C.CHORD_ATTR_PAD
    return root.to(device), attr.to(device)


def root_attr_to_chord_logits(logits_root, logits_attr):
    """The 159-way distribution of separated root (15) and attr (16) heads:
    the product of the two softmaxes at each chord's (root, attr), then a
    second softmax over the products (the reference's double softmax).
    Returns probabilities (f32)."""
    root, attr = _root_attr_index(str(logits_root.device))
    p_root = torch.softmax(logits_root.float(), dim=-1)
    p_attr = torch.softmax(logits_attr.float(), dim=-1)
    return torch.softmax(p_root[..., root] * p_attr[..., attr], dim=-1)


def _root_attr_logits(logits_root, logits_attr):
    return torch.log(root_attr_to_chord_logits(logits_root, logits_attr)
                     + 1e-20)


def compute_vevo_accuracy_root_attr(logits_root, logits_attr, tgt):
    return compute_vevo_accuracy(_root_attr_logits(logits_root, logits_attr),
                                 tgt)


def compute_hits_k_root_attr(logits_root, logits_attr, tgt, k: int):
    return compute_hits_k(_root_attr_logits(logits_root, logits_attr), tgt,
                          k)


def compute_vevo_correspondence_root_attr(
        logits_root, logits_attr, tgt, tgt_emotion, tgt_emotion_prob,
        emotion_threshold: float = C.EMOTION_THRESHOLD):
    return compute_vevo_correspondence(
        _root_attr_logits(logits_root, logits_attr), tgt, tgt_emotion,
        tgt_emotion_prob, emotion_threshold)


def regression_eval(pred_ln_nd, note_density, loudness, inst_probs,
                    instrument):
    """Per-batch sums for the regression's epoch metrics: the squared
    errors of note density (prediction channel 0) and loudness (channel
    1), their count, and the instrument BCE (probabilities clipped to
    [1e-7, 1 - 1e-7]), all f32 scalars."""
    pred = pred_ln_nd.float()
    se_nd = ((pred[..., 0] - note_density) ** 2).sum()
    se_ln = ((pred[..., 1] - loudness) ** 2).sum()
    n = torch.tensor(float(note_density.numel()), device=pred.device)
    eps = 1e-7
    p = inst_probs.float().clamp(eps, 1 - eps)
    bce = -(instrument * torch.log(p)
            + (1 - instrument) * torch.log1p(-p)).mean()
    return {"se_note_density": se_nd, "se_loudness": se_ln, "count": n,
            "bce_instrument": bce}
