"""Mamba selective scan (counterpart of ops/scan.py:selective_scan and
ops/pallas_scan.py:selective_scan_pallas), kernel 4 of the port:
csrc/selective_scan.cu.

``selective_scan`` runs :func:`selective_scan_plain` on CPU tensors and
launches the CUDA kernel on CUDA tensors. It is differentiable: the
backward recomputes through :func:`selective_scan_plain` under autograd
(the pattern of ops/flash_attention.py ``_Attention``), as the JAX model
differentiates its associative scan (the Pallas scan has no VJP); a
backward kernel is left to the training slice of the regression.

Also the scans of the other regression backbones, which reach no TPU
kernel: the Heinsen log-space scan of minGRU (``logcumsumexp``,
``heinsen_log_scan``) and the GRU / LSTM cell loops with torch's gate
order (``gru_scan``, ``lstm_scan``), the plain versions that
models/rnn.py's cuDNN stacks are held to.
"""

from __future__ import annotations

import torch

from .. import kernels

# csrc/selective_scan.cu kMaxState: 32 lanes x 32 states a lane
MAX_D_STATE = 1024


def selective_scan_plain(x, delta, A, B, C, D):
    """h[t] = exp(delta[t] A) h[t-1] + delta[t] B[t] x[t];
    y[t] = C[t] . h[t] + D x[t], in f32, walked over t in plain PyTorch.

    x, delta (b, L, ED); A (ED, N); B, C (b, L, N); D (ED,) -> y (b, L, ED)
    in x's dtype.
    """
    xf, df = x.float(), delta.float()
    dA = torch.exp(df[..., None] * A.float())                    # (b, L, ED, N)
    dBx = (df * xf)[..., None] * B.float()[:, :, None, :]        # (b, L, ED, N)
    h = torch.zeros_like(dA[:, 0])
    hs = []
    for t in range(x.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        hs.append(h)
    y = torch.einsum("blen,bln->ble", torch.stack(hs, dim=1), C.float())
    return (y + D.float() * xf).to(x.dtype)


def _forward(x, delta, A, B, C, D):
    what = "selective_scan"
    if kernels.use_plain(x, what):
        return selective_scan_plain(x, delta, A, B, C, D)
    b, L, ED = x.shape
    N = A.shape[-1]
    code = kernels.dtype_code(x, what)
    kernels.require(delta.shape == x.shape and A.shape == (ED, N)
                    and B.shape == (b, L, N) and C.shape == (b, L, N)
                    and D.shape == (ED,), what, "shape mismatch")
    kernels.require(all(t.dtype == x.dtype for t in (delta, B, C)), what,
                    "x, delta, B and C must share one dtype")
    kernels.require(all(t.is_cuda and t.is_contiguous()
                        for t in (x, delta, B, C)), what,
                    "x, delta, B and C must be contiguous CUDA tensors")
    kernels.require(1 <= N <= MAX_D_STATE, what,
                    f"d_state {N} outside 1..{MAX_D_STATE}: a channel's "
                    f"states are spread over the 32 lanes of a warp, "
                    f"{MAX_D_STATE // 32} a lane in registers")
    A32 = A.to(device=x.device, dtype=torch.float32).contiguous()
    D32 = D.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    lib = kernels.library()
    status = lib.v2m_selective_scan(
        code, kernels.ptr(x), kernels.ptr(delta), kernels.ptr(A32),
        kernels.ptr(B), kernels.ptr(C), kernels.ptr(D32), kernels.ptr(y),
        b, L, ED, N, kernels.stream_of(x))
    kernels.check(status, what)
    selective_scan.launches += 1
    return y


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, A, B, C, D):
        ctx.save_for_backward(x, delta, A, B, C, D)
        return _forward(x, delta, A, B, C, D)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = selective_scan_plain(*leaves)
            return torch.autograd.grad(y, leaves, g)


def selective_scan(x, delta, A, B, C, D):
    """Selective scan (same signature as :func:`selective_scan_plain`),
    differentiable in every input."""
    return _Scan.apply(x, delta, A, B, C, D)


selective_scan.launches = 0


def logcumsumexp(x, axis: int = 1):
    """Running log-sum-exp along ``axis`` (the JAX package's associative
    scan; a run of -inf stays -inf, never nan)."""
    return torch.logcumsumexp(x, dim=axis)


def heinsen_log_scan(log_coeffs, log_values, axis: int = 1):
    """h[t] = a[t] h[t-1] + v[t] for positive a, v, in log space:
    exp(a* + logcumsumexp(log_values - a*)) with a* = cumsum(log_coeffs)."""
    a_star = torch.cumsum(log_coeffs, dim=axis)
    return torch.exp(a_star + logcumsumexp(log_values - a_star, axis))


# torch.nn.GRU weights: rows [r; z; n], n = tanh(W_in x + b_in + r (W_hn h
# + b_hn)), h' = (1 - z) n + z h. torch.nn.LSTM weights: rows [i; f; g; o],
# c' = f c + i g, h' = o tanh(c').

def gru_scan(x, h0, w_ih, w_hh, b_ih, b_hh, reverse: bool = False):
    """x (B, L, I); h0 (B, H); weights in torch layout (3H, I) / (3H, H).
    Returns (B, L, H)."""
    H = h0.shape[-1]
    gi = x @ w_ih.t() + b_ih                                     # (B, L, 3H)
    h, ys = h0, [None] * x.shape[1]
    for t in (reversed(range(x.shape[1])) if reverse else range(x.shape[1])):
        gh = h @ w_hh.t() + b_hh
        r = torch.sigmoid(gi[:, t, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, t, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, t, 2 * H:] + r * gh[:, 2 * H:])
        h = ys[t] = (1.0 - z) * n + z * h
    return torch.stack(ys, dim=1)


def lstm_scan(x, h0, c0, w_ih, w_hh, b_ih, b_hh, reverse: bool = False):
    """x (B, L, I); h0, c0 (B, H); weights in torch layout (4H, I) /
    (4H, H). Returns (B, L, H)."""
    H = h0.shape[-1]
    gi = x @ w_ih.t() + b_ih                                     # (B, L, 4H)
    h, c, ys = h0, c0, [None] * x.shape[1]
    for t in (reversed(range(x.shape[1])) if reverse else range(x.shape[1])):
        g = gi[:, t] + h @ w_hh.t() + b_hh
        i, f = torch.sigmoid(g[:, :H]), torch.sigmoid(g[:, H:2 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c = f * c + i * torch.tanh(g[:, 2 * H:3 * H])
        h = ys[t] = o * torch.tanh(c)
    return torch.stack(ys, dim=1)
