"""Loss functions of the port (counterpart of ops/losses.py): plain
PyTorch functions of (logits, targets) returning f32 scalars, with the JAX
package's semantics (torch's CrossEntropyLoss with ignore_index and label
smoothing, the reference's TopK auxiliary pair averaged over its active
terms, unmasked BCE-with-logits for the emotion target).

``reduce``: a sharded step's sum over its data group (parallel/comm.py
``reduce_from``, differentiable). Each mean is then the global batch's:
the rank's numerator and count are summed over the group before the
division, so every rank holds the unsharded loss and its part of the
gradient (which the step sums over the group)."""

from __future__ import annotations

import torch
from torch.nn import functional as F


def _global(num, den, reduce):
    return (num, den) if reduce is None else (reduce(num), reduce(den))


def _masked_mean(per_token, targets, ignore_index: int, reduce=None):
    mask = (targets != ignore_index).float()
    num, den = _global((per_token * mask).sum(), mask.sum(), reduce)
    return num / den.clamp(min=1.0)


def _onehot(targets, vocab_size: int):
    return F.one_hot(targets.clamp(0, vocab_size - 1).long(),
                     vocab_size).float()


def cross_entropy(logits, targets, *, ignore_index: int,
                  label_smoothing: float = 0.0, reduce=None):
    """Mean over non-ignored targets of (1-eps)*NLL + eps*mean(-log p).
    logits (..., V); targets (...) int."""
    V = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    tgt = targets.clamp(0, V - 1).long()
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll \
            + label_smoothing * -logp.mean(dim=-1)
    return _masked_mean(nll, targets, ignore_index, reduce)


def smooth_cross_entropy(logits, targets, *, vocab_size: int,
                         label_smoothing: float, ignore_index: int,
                         reduce=None):
    """The reference's SmoothCrossEntropyLoss: q' = (1-eps)*onehot + eps/V,
    ignored rows zeroed, mean over the non-ignored count."""
    logp = F.log_softmax(logits.float(), dim=-1)
    q = (1.0 - label_smoothing) * _onehot(targets, vocab_size) \
        + label_smoothing / vocab_size
    mask = (targets != ignore_index).float()
    ce = -(q * mask[..., None] * logp).sum(-1)
    num, den = _global(ce.sum(), mask.sum(), reduce)
    return num / den.clamp(min=1.0)


def topk_auxiliary_loss(logits, targets, *, k: int, weight: float,
                        vocab_size: int, ignore_index: int, reduce=None):
    """relu(mean(top-k softmax probs) - p_true), pad-masked mean, times
    ``weight``."""
    probs = torch.softmax(logits.float(), dim=-1)
    mean_topk = probs.topk(k, dim=-1).values.mean(-1)
    mask = (targets != ignore_index).float()
    true_score = (probs * _onehot(targets, vocab_size)
                  * mask[..., None]).sum(-1)
    loss = F.relu(mean_topk - true_score) * mask
    num, den = _global(loss.sum(), mask.sum(), reduce)
    return num / den.clamp(min=1.0) * weight


def combined_chord_loss(logits, targets, *, vocab_size: int,
                        ignore_index: int, label_smoothing: float = 0.1,
                        auxiliary: bool = False, reduce=None):
    """CE, or with ``auxiliary`` (CE + top-3 + top-5 auxiliary) divided by
    the number of terms above 1e-10."""
    ce = cross_entropy(logits, targets, ignore_index=ignore_index,
                       label_smoothing=label_smoothing, reduce=reduce)
    if not auxiliary:
        return ce
    a3 = topk_auxiliary_loss(logits, targets, k=3, weight=3.0,
                             vocab_size=vocab_size, ignore_index=ignore_index,
                             reduce=reduce)
    a5 = topk_auxiliary_loss(logits, targets, k=5, weight=5.0,
                             vocab_size=vocab_size, ignore_index=ignore_index,
                             reduce=reduce)
    count = sum((t > 1e-10).float() for t in (ce, a3, a5))
    return (ce + a3 + a5) / count.clamp(min=1.0)


def bce_with_logits(logits, targets, reduce=None):
    """torch's BCEWithLogitsLoss (mean over every element, not pad-masked,
    as the reference's emotion term)."""
    logits = logits.float()
    loss = logits.clamp(min=0) - logits * targets \
        + torch.log1p(torch.exp(-logits.abs()))
    if reduce is None:
        return loss.mean()
    num, den = _global(loss.sum(), loss.new_tensor(float(loss.numel())),
                       reduce)
    return num / den


def bce(probs, targets, eps: float = 1e-7):
    """torch's BCELoss on probabilities clipped to [eps, 1-eps]."""
    p = probs.float().clamp(eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p)).mean()


def smooth_l1(pred, target, beta: float = 1.0):
    """torch's SmoothL1Loss (mean)."""
    d = (pred.float() - target.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()
