"""Fused full-sequence attention (counterpart of ops/pallas_attention.py:
``flash_attention``), kernel 1 of the port: csrc/flash_attention.cu.

``flash_attention`` runs :func:`flash_attention_plain` on CPU tensors and
launches the CUDA kernel on CUDA tensors. It is differentiable: the
backward recomputes through :func:`flash_attention_plain` under autograd,
as the JAX kernel's custom VJP recomputes through ``reference_attention``
(pallas_attention.py:103-129). Training with dropout takes
ops/flash_attention_dropout.py instead; this backward serves the rest.
"""

from __future__ import annotations

import torch

from .. import kernels

NEG_INF = -1e9


def flash_attention_plain(q, k, v, *, bias=None, causal: bool = False,
                          scale=None):
    """softmax(q k^T * scale + bias + causal) v in plain PyTorch, as
    ops/pallas_attention.py:reference_attention: f32 logits and softmax,
    masked logits -1e9, weights rounded to v's dtype before the product.
    q (B, H, L, D); k, v (B, H, S, D); bias (B, H, L, S), (1, H, L, S) (one
    bias for every batch row) or None; scale D**-0.5 unless given."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bhld,bhsd->bhls", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        L, S = logits.shape[-2:]
        rows = torch.arange(L, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        logits = logits.masked_fill(cols > rows + (S - L), NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhls,bhsd->bhld", w.float(), v.float()).to(q.dtype)


def _forward(q, k, v, bias, causal: bool, scale: float):
    what = "flash_attention"
    if kernels.use_plain(q, what):
        return flash_attention_plain(q, k, v, bias=bias, causal=causal,
                                     scale=scale)
    B, H, L, D = q.shape
    S = k.shape[2]
    code = kernels.dtype_code(q, what)
    kernels.require(k.shape == (B, H, S, D) and v.shape == k.shape, what,
                    f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not "
                    f"match q {tuple(q.shape)}")
    kernels.require(k.dtype == q.dtype and v.dtype == q.dtype, what,
                    "q, k and v must share one dtype")
    kernels.require(all(t.is_cuda and t.is_contiguous() for t in (q, k, v)),
                    what, "q, k and v must be contiguous CUDA tensors")
    Dp = kernels.head_instance(D, what)
    planes = B * H
    if bias is not None:
        kernels.require(bias.shape in ((B, H, L, S), (1, H, L, S)), what,
                        f"bias shape {tuple(bias.shape)} is neither "
                        f"{(B, H, L, S)} nor {(1, H, L, S)}")
        bias = bias.to(device=q.device, dtype=torch.float32).contiguous()
        planes = bias.shape[0] * H
    q, k, v = (kernels.aligned(kernels.pad_head(t, Dp)) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = kernels.library()
    status = lib.v2m_flash_attention(
        code, kernels.ptr(q), kernels.ptr(k), kernels.ptr(v),
        kernels.ptr(bias), planes, kernels.ptr(out), B * H, L, S, Dp,
        int(causal), scale, kernels.stream_of(q))
    kernels.check(status, what)
    flash_attention.launches += 1
    return out if Dp == D else out[..., :D].contiguous()


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.causal, ctx.scale = causal, scale
        return _forward(q, k, v, bias, causal, scale)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in saved]
            out = flash_attention_plain(*leaves[:3], bias=leaves[3],
                                        causal=ctx.causal, scale=ctx.scale)
            wanted = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(None if t is None else next(grads) for t in leaves), None,
                None)


def flash_attention(q, k, v, *, bias=None, causal: bool = False,
                    scale=None):
    """Fused attention. q (B, H, L, D); k, v (B, H, S, D) (same head count);
    bias: optional additive logits bias, (B, H, L, S) or (1, H, L, S) for
    one bias shared by every batch row (the kernel reads it in place);
    scale: the logits' factor, D**-0.5 unless given (MaxViT scales by its
    full channel width). The causal mask is start-aligned and needs
    L == S, as in the TPU kernel."""
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(
            f"causal flash_attention requires L == S, got L={q.shape[2]} "
            f"S={k.shape[2]} (use an explicit bias mask for L != S)")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _Attention.apply(q, k, v, bias, bool(causal), scale)


flash_attention.launches = 0
