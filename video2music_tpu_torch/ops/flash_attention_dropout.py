"""Attention with in-kernel hashed dropout for the training step
(counterpart of ops/pallas_attention_dropout.py: ``flash_attention_dropout``),
kernels csrc/flash_attention_dropout.cu (a forward and a backward).

The dropout mask is not drawn from a random stream: as in the TPU kernel
(``_drop_mask``), an entry (row, col) of head ``bh = b * H + h`` is kept iff
a murmur3-style hash of (seed, bh, row, col) in u32 arithmetic exceeds
``u32(rate * 0xFFFFFFFF)``, and kept entries scale by ``1 / (1 - rate)``.
So the backward replays the mask from the seed, the (B, H, L, S)
probabilities are never stored, and the port draws JAX's mask bit for bit.

``flash_attention_dropout`` is a ``torch.autograd.Function``: on CUDA
tensors the forward launches the forward kernel (which also saves each
row's softmax max and sum) and the backward the backward kernel, which
takes the forward's output as well (the bf16 kernel's D = rowsum(do *
out)); on CPU tensors both run the plain versions below. The seed is an int32 scalar,
a Python int or a tensor on the device, so a training step draws it there
without a host sync.
"""

from __future__ import annotations

import torch

from .. import kernels
from .flash_attention import NEG_INF

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for an int64 tensor x in [0, 2**32): the product is
    split in 16-bit halves of c so no intermediate leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def drop_threshold(rate: float) -> int:
    """u32(min(rate, 1) * 0xFFFFFFFF): the product in Python floats,
    truncated (the TPU kernel's ``jnp.uint32`` of it)."""
    return int(min(rate, 1.0) * 0xFFFFFFFF)


def dropout_mask(B: int, H: int, L: int, S: int, rate: float, seed,
                 device) -> torch.Tensor:
    """(B, H, L, S) float32 keep-mask scaled by 1/(1-rate), JAX's
    ``_drop_mask`` for every (b*H + h, row, col), in int64 masked to 32
    bits (torch's uint32 supports few operations on the CPU)."""
    seed = torch.as_tensor(seed, device=device).to(torch.int64).reshape(())
    rows = torch.arange(L, device=device, dtype=torch.int64).view(1, 1, L, 1)
    cols = torch.arange(S, device=device, dtype=torch.int64).view(1, 1, 1, S)
    bh = torch.arange(B * H, device=device, dtype=torch.int64).view(B, H, 1, 1)
    salt = ((seed & _M32) + _mul32(bh, 0xC2B2AE35)) & _M32
    x = _mul32(rows, 0x9E3779B1) ^ _mul32(cols, 0x85EBCA6B) ^ salt
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    keep = x > drop_threshold(rate)
    # kept entries: f32(1 / (1 - rate)), the JAX kernel's weak-typed scale
    return keep.to(torch.float32) * (1.0 / (1.0 - rate))


def _probs(q, k, bias, causal: bool):
    """f32 softmax(q k^T / sqrt(d) + bias), masked logits -1e9, the causal
    mask start-aligned (``_probs_block``)."""
    logits = torch.einsum("bhld,bhsd->bhls", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        L, S = logits.shape[-2:]
        rows = torch.arange(L, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        logits = logits.masked_fill(cols > rows, NEG_INF)
    return torch.softmax(logits, dim=-1)


def _mask_or_none(q, k, rate, seed):
    if rate <= 0.0:
        return None
    B, H, L, _ = q.shape
    return dropout_mask(B, H, L, k.shape[2], rate, seed, q.device)


def flash_attention_dropout_plain(q, k, v, *, bias=None, causal: bool = False,
                                  dropout_rate: float = 0.0, seed=0):
    """The forward in plain PyTorch (``_fwd_kernel``): f32 probabilities
    times the mask, rounded to v's dtype, the product with v in f32, the
    output in q's dtype. Differentiable by autograd (in f32 its gradients
    are the backward kernel's; see :func:`flash_attention_dropout_plain_bwd`
    for the kernel's exact f32 backward in every dtype)."""
    w = _probs(q, k, bias, causal)
    mask = _mask_or_none(q, k, dropout_rate, seed)
    if mask is not None:
        w = w * mask
    return torch.einsum("bhls,bhsd->bhld", w.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def flash_attention_dropout_plain_bwd(q, k, v, do, *, bias=None,
                                      causal: bool = False,
                                      dropout_rate: float = 0.0, seed=0):
    """The backward in plain PyTorch (``_bwd_kernel``), all f32 from the
    inputs upcast: dv = (w*mask)^T do, dw = (do v^T) * mask,
    dlogits = w * (dw - rowsum(dw * w)), dq = dlogits k * scale,
    dk = dlogits^T q * scale, dbias = dlogits; each cast to its input's
    dtype. Returns (dq, dk, dv, dbias or None)."""
    scale = q.shape[-1] ** -0.5
    w = _probs(q, k, bias, causal)
    mask = _mask_or_none(q, k, dropout_rate, seed)
    wd = w if mask is None else w * mask
    do_f = do.float()
    dv = torch.einsum("bhls,bhld->bhsd", wd, do_f)
    dw = torch.einsum("bhld,bhsd->bhls", do_f, v.float())
    if mask is not None:
        dw = dw * mask
    dlogits = w * (dw - (dw * w).sum(-1, keepdim=True))
    dq = torch.einsum("bhls,bhsd->bhld", dlogits, k.float()) * scale
    dk = torch.einsum("bhls,bhld->bhsd", dlogits, q.float()) * scale
    dbias = None if bias is None else dlogits.to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _drop_args(rate: float):
    return (drop_threshold(rate), 1.0 / (1.0 - rate) if rate > 0 else 1.0,
            int(rate > 0.0))


def _check(q, k, v, bias, seed, what):
    B, H, L, D = q.shape
    S = k.shape[2]
    code = kernels.dtype_code(q, what)
    kernels.require(k.shape == (B, H, S, D) and v.shape == k.shape, what,
                    f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not "
                    f"match q {tuple(q.shape)}")
    kernels.require_like({"k": k, "v": v}, q, what)
    kernels.require(q.is_contiguous(), what, "q must be contiguous")
    kernels.head_instance(D, what)
    kernels.require(isinstance(seed, torch.Tensor) and seed.numel() == 1
                    and seed.dtype == torch.int32 and seed.device == q.device,
                    what, "seed must be one int32 on q's device")
    if bias is not None:
        kernels.require(bias.shape == (B, H, L, S) and bias.is_contiguous()
                        and bias.dtype == torch.float32
                        and bias.device == q.device, what,
                        f"bias must be a contiguous float32 {(B, H, L, S)} "
                        f"tensor on {q.device}")
    return code


def _seed_tensor(seed, device):
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int32).reshape(1)
    return torch.tensor([seed], dtype=torch.int32, device=device)


def flash_attention_dropout_fwd(q, k, v, bias, seed, causal: bool,
                                rate: float):
    """The forward wrapper: (out, stats). CPU tensors: the plain forward,
    stats None. CUDA tensors: the forward kernel; stats (B, H, L, 2) f32
    holds each row's softmax max and sum of exponentials."""
    what = "flash_attention_dropout"
    if kernels.use_plain(q, what):
        return flash_attention_dropout_plain(
            q, k, v, bias=bias, causal=causal, dropout_rate=rate,
            seed=seed), None
    code = _check(q, k, v, bias, seed, what)
    B, H, L, D = q.shape
    Dp = kernels.head_instance(D, what)
    q, k, v = (kernels.aligned(kernels.pad_head(t, Dp)) for t in (q, k, v))
    out = torch.empty_like(q)
    stats = torch.empty(B, H, L, 2, device=q.device, dtype=torch.float32)
    status = kernels.library().v2m_attention_dropout_fwd(
        code, kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        kernels.ptr(bias), kernels.ptr(seed), kernels.ptr(out),
        kernels.ptr(stats), B * H, L, k.shape[2], Dp, int(causal),
        D ** -0.5, *_drop_args(rate), kernels.stream_of(q))
    kernels.check(status, what)
    flash_attention_dropout_fwd.launches += 1
    return (out if Dp == D else out[..., :D].contiguous()), stats


def flash_attention_dropout_bwd(q, k, v, bias, do, seed, stats, out,
                                causal: bool, rate: float):
    """The backward wrapper: (dq, dk, dv, dbias or None). CPU tensors: the
    plain backward (stats and out unused). CUDA tensors: the backward
    kernel, which replays the mask and recomputes the probabilities from
    the forward's stats; in bf16 it takes each row's rowsum(do * out) from
    the forward's output ``out``."""
    what = "flash_attention_dropout backward"
    if kernels.use_plain(q, what):
        return flash_attention_dropout_plain_bwd(
            q, k, v, do, bias=bias, causal=causal, dropout_rate=rate,
            seed=seed)
    code = _check(q, k, v, bias, seed, what)
    kernels.require_like({"do": do, "out": out}, q, what)
    B, H, L, D = q.shape
    kernels.require(do.shape == q.shape and out.shape == q.shape
                    and stats is not None and stats.shape == (B, H, L, 2),
                    what, "do and out must match q and stats come from the "
                    "forward kernel")
    Dp = kernels.head_instance(D, what)
    q, k, v, do, out = (kernels.aligned(kernels.pad_head(t, Dp))
                        for t in (q, k, v, do, out))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = None if bias is None else torch.empty_like(bias)
    dsum = torch.empty(B, H, L, device=q.device, dtype=torch.float32)
    status = kernels.library().v2m_attention_dropout_bwd(
        code, kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        kernels.ptr(bias), kernels.ptr(seed), kernels.ptr(do),
        kernels.ptr(stats), kernels.ptr(out), kernels.ptr(dq), kernels.ptr(dk),
        kernels.ptr(dv), kernels.ptr(dbias), kernels.ptr(dsum), B * H, L,
        k.shape[2], Dp, int(causal), D ** -0.5, *_drop_args(rate),
        kernels.stream_of(q))
    kernels.check(status, what)
    flash_attention_dropout_bwd.launches += 1
    if Dp != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv, dbias


flash_attention_dropout_fwd.launches = 0
flash_attention_dropout_bwd.launches = 0


class _AttentionDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, causal, rate):
        out, stats = flash_attention_dropout_fwd(q, k, v, bias, seed, causal,
                                                 rate)
        ctx.save_for_backward(q, k, v, bias, seed, stats, out)
        ctx.causal, ctx.rate = causal, rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seed, stats, out = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_dropout_bwd(
            q, k, v, bias, kernels.aligned(g), seed, stats, out, ctx.causal,
            ctx.rate)
        return dq, dk, dv, dbias, None, None, None


def _bias_f32(bias, q):
    if bias is None or q.device.type == "cpu":
        return bias
    return bias.to(device=q.device, dtype=torch.float32).contiguous()


def flash_attention_dropout(q, k, v, *, bias=None, causal: bool = False,
                            dropout_rate: float = 0.0, seed=0):
    """Training-path attention: softmax, dropout and the product with v in
    one kernel, the backward a kernel that replays the mask. q (B, H, L, D);
    k, v (B, H, S, D); bias: optional (B, H, L, S) additive logits bias
    (its gradient is returned); seed: int32 scalar (int or tensor). The
    causal mask is start-aligned and needs L == S."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(
            f"causal flash_attention_dropout requires L == S, got "
            f"L={q.shape[2]} S={k.shape[2]}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    return _AttentionDropout.apply(q, k, v, _bias_f32(bias, q),
                                   _seed_tensor(seed, q.device), bool(causal),
                                   float(dropout_rate))


def extract_dropped_probs(q, k, *, bias=None, causal: bool = False,
                          dropout_rate: float = 0.0, seed=0):
    """TEST ONLY: the (B, H, L, S) post-dropout probabilities (in q's
    dtype) that the forward draws, read by running the forward against
    identity values, head_dim columns at a time; on CUDA tensors that is
    the forward kernel, so its mask can be held against the plain one."""
    B, H, L, D = q.shape
    S = k.shape[2]
    seed = _seed_tensor(seed, q.device)
    bias = _bias_f32(bias, q)
    out = q.new_empty(B, H, L, S)
    for c0 in range(0, S, D):
        w = min(D, S - c0)
        eye = torch.zeros(S, D, dtype=q.dtype, device=q.device)
        idx = torch.arange(w, device=q.device)
        eye[c0 + idx, idx] = 1
        o, _ = flash_attention_dropout_fwd(
            q, k, eye.expand(B, H, S, D).contiguous(), bias, seed, causal,
            float(dropout_rate))
        out[..., c0:c0 + w] = o[..., :w]
    return out
