"""The algorithm of the port's tensor-core attention kernels
(csrc/attention_mma.cuh, csrc/flash_attention.cu and
csrc/flash_attention_dropout.cu in bf16) against the Pallas kernels of
ops/pallas_attention.py and ops/pallas_attention_dropout.py in interpret
mode, on the CPU.

No CUDA kernel runs here. The mirror below is plain torch, kept in this
file and not in the package: the kernels' arithmetic in their order.
Keys stream in chunks of 64; the forward makes two passes (the row max m
and sum l, then the normalized, dropped weights rounded to the operand
dtype before the product with V); the backward takes D = rowsum(dO * O)
from the forward's output and rounds P * mask and dS to the operand dtype
before their products. f32 agrees with the Pallas kernels within rtol
2e-4 / atol 2e-5 (another summation order only); bf16 within 2e-2 of the
largest value, the bound chip_smoke.py holds the kernels to on the card.
The CPU path of the port is the plain version: it launches nothing and
its backward is the plain backward, now that the forward saves its
output for the kernel's D."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video2music_tpu.ops.pallas_attention import flash_attention as jax_flash
from video2music_tpu.ops.pallas_attention_dropout import (
    flash_attention_dropout as jax_fad)
from video2music_tpu_torch import kernels
from video2music_tpu_torch.ops.flash_attention import NEG_INF, flash_attention
from video2music_tpu_torch.ops.flash_attention_dropout import (
    dropout_mask, flash_attention_dropout, flash_attention_dropout_bwd,
    flash_attention_dropout_fwd, flash_attention_dropout_plain,
    flash_attention_dropout_plain_bwd)

torch.set_num_threads(1)
INTERP = pltpu.InterpretParams()
F32 = dict(rtol=2e-4, atol=2e-5)
BF16_REL = 2e-2
CHUNK = 64  # attention_mma.cuh kChunk
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _logits(q, k, bias, causal, c0, c1):
    """f32 logits of every query against keys c0 .. c1 - 1: scaled,
    biased, -1e9 above the start-aligned causal diagonal."""
    s = torch.einsum("bhld,bhsd->bhls", q.float(), k[:, :, c0:c1].float())
    s = s * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias[..., c0:c1].float()
    if causal:
        rows = torch.arange(q.shape[2])[:, None]
        cols = torch.arange(c0, c1)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    return s


def mirror_forward(q, k, v, bias=None, causal=False, rate=0.0, seed=0):
    """(out in q's dtype, m, l): the tensor-core forward's two passes."""
    B, H, L, _ = q.shape
    S = k.shape[2]
    mask = dropout_mask(B, H, L, S, rate, seed, "cpu") if rate > 0 else None
    m = torch.full((B, H, L), -torch.inf)
    l = torch.zeros(B, H, L)
    for c0 in range(0, S, CHUNK):  # pass 0: online max and sum
        s = _logits(q, k, bias, causal, c0, min(S, c0 + CHUNK))
        mx = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - mx) + torch.exp(s - mx[..., None]).sum(-1)
        m = mx
    acc = torch.zeros(q.shape)
    for c0 in range(0, S, CHUNK):  # pass 1: rounded weights times V
        c1 = min(S, c0 + CHUNK)
        w = torch.exp(_logits(q, k, bias, causal, c0, c1) - m[..., None]) \
            / l[..., None]
        if mask is not None:
            w = w * mask[..., c0:c1]
        acc += torch.einsum("bhls,bhsd->bhld", w.to(v.dtype).float(),
                            v[:, :, c0:c1].float())
    return acc.to(q.dtype), m, l


def mirror_backward(q, k, v, out, do, m, l, bias=None, causal=False,
                    rate=0.0, seed=0):
    """(dq, dk, dv, dbias or None): the tensor-core backward, D from the
    forward's output, P * mask and dS rounded to q's dtype as operands."""
    B, H, L, D = q.shape
    S = k.shape[2]
    rnd = lambda t: t.to(q.dtype).float()
    mask = dropout_mask(B, H, L, S, rate, seed, "cpu") if rate > 0 else None
    dsum = (do.float() * out.float()).sum(-1)
    dq = torch.zeros(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    dbias = None if bias is None else torch.zeros(B, H, L, S)
    for c0 in range(0, S, CHUNK):
        c1 = min(S, c0 + CHUNK)
        p = torch.exp(_logits(q, k, bias, causal, c0, c1) - m[..., None]) \
            / l[..., None]
        dp = torch.einsum("bhld,bhsd->bhls", do.float(),
                          v[:, :, c0:c1].float())
        f = 1.0 if mask is None else mask[..., c0:c1]
        ds = p * (dp * f - dsum[..., None])
        if dbias is not None:
            dbias[..., c0:c1] = ds
        dq += torch.einsum("bhls,bhsd->bhld", rnd(ds), k[:, :, c0:c1].float())
        dv[:, :, c0:c1] = torch.einsum("bhls,bhld->bhsd", rnd(p * f),
                                       do.float())
        dk[:, :, c0:c1] = torch.einsum("bhls,bhld->bhsd", rnd(ds), q.float())
    scale = D ** -0.5
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype), dbias)


def _inputs(seed, B, H, L, D, use_bias):
    r = np.random.default_rng(seed)
    q, k, v, do = (r.standard_normal((B, H, L, D)).astype(np.float32)
                   for _ in range(4))
    b = r.standard_normal((B, H, L, L)).astype(np.float32) \
        if use_bias else None
    return q, k, v, b, do


def _assert_agrees(got, want, dtype, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=name, **F32)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= BF16_REL, (name, err)


CASES = [  # (L, D, causal, use_bias): the product width, a ragged length
    (300, 64, False, False), (300, 64, True, False), (77, 64, True, True)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L,D,causal,use_bias", CASES)
def test_dropout_mirror_matches_pallas(L, D, causal, use_bias, dtype):
    t_dt, j_dt = DTYPES[dtype]
    rate, seed = 0.1, 20241016
    q, k, v, b, do = _inputs(L + D, 1, 2, L, D, use_bias)
    jargs = [jnp.asarray(a, j_dt) for a in (q, k, v)] + (
        [jnp.asarray(b)] if use_bias else [])

    def f(q_, k_, v_, *rest):
        return jax_fad(q_, k_, v_, bias=rest[0] if rest else None,
                       causal=causal, dropout_rate=rate, seed=seed,
                       interpret=INTERP)
    jout, vjp = jax.vjp(f, *jargs)
    want = [jout] + list(vjp(jnp.asarray(do, j_dt)))

    tq, tk, tv, tdo = (torch.tensor(a).to(t_dt) for a in (q, k, v, do))
    tb = None if b is None else torch.tensor(b)
    kw = dict(bias=tb, causal=causal, rate=rate, seed=seed)
    out, m, l = mirror_forward(tq, tk, tv, **kw)
    got = [out] + [g for g in mirror_backward(tq, tk, tv, out, tdo, m, l,
                                              **kw) if g is not None]
    for name, g, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        _assert_agrees(g.float().numpy(), jnp.asarray(w, jnp.float32),
                       dtype, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("L,D,causal,use_bias", [CASES[0], CASES[2]])
def test_flash_mirror_matches_pallas(L, D, causal, use_bias, dtype):
    """Row 1's forward is the same two passes without dropout or stats."""
    t_dt, j_dt = DTYPES[dtype]
    q, k, v, b, _ = _inputs(L * 3 + D, 1, 2, L, D, use_bias)
    want = jax_flash(*(jnp.asarray(a, j_dt) for a in (q, k, v)),
                     bias=None if b is None else jnp.asarray(b),
                     causal=causal, interpret=True)
    got, _, _ = mirror_forward(*(torch.tensor(a).to(t_dt) for a in (q, k, v)),
                               bias=None if b is None else torch.tensor(b),
                               causal=causal)
    _assert_agrees(got.float().numpy(), jnp.asarray(want, jnp.float32),
                   dtype, "out")


@pytest.mark.parametrize("causal", [False, True])
def test_rowsum_of_do_times_out_is_the_dropped_sum(causal):
    """D = rowsum(dO * O) equals sum_j w_j mask_j (dO . v_j) (f32): the
    identity the backward's one pass over the keys rests on."""
    q, k, v, _, do = (torch.tensor(a) if a is not None else None
                      for a in _inputs(5, 2, 2, 70, 16, False))
    rate, seed = 0.2, 3
    out = flash_attention_dropout_plain(q, k, v, causal=causal,
                                        dropout_rate=rate, seed=seed)
    logits = _logits(q, k, None, causal, 0, k.shape[2])
    wd = torch.softmax(logits, -1) * dropout_mask(2, 2, 70, 70, rate, seed,
                                                  "cpu")
    want = (wd * torch.einsum("bhld,bhsd->bhls", do, v)).sum(-1)
    torch.testing.assert_close((do * out).sum(-1), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_cpu_path_saves_out_launches_nothing_and_is_the_plain_backward(
        causal, use_bias):
    q, k, v, b, do = _inputs(9, 1, 2, 40, 16, use_bias)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tb = None if b is None else torch.tensor(b, requires_grad=True)
    kw = dict(causal=causal, dropout_rate=0.1, seed=17)
    flash_attention_dropout_fwd.launches = 0
    flash_attention_dropout_bwd.launches = 0
    out = flash_attention_dropout(*ts, bias=tb, **kw)
    out.backward(torch.tensor(do))
    assert flash_attention_dropout_fwd.launches == 0
    assert flash_attention_dropout_bwd.launches == 0
    want = flash_attention_dropout_plain_bwd(
        *(t.detach() for t in ts), torch.tensor(do),
        bias=None if tb is None else tb.detach(), **kw)
    got = [t.grad for t in ts] + [None if tb is None else tb.grad]
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_flash_attention_cpu_launches_nothing():
    q, k, v, _, _ = (torch.tensor(a) if a is not None else None
                     for a in _inputs(4, 1, 2, 30, 32, False))
    flash_attention.launches = 0
    flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == 0


def test_aligned_copies_only_a_misaligned_view():
    base = torch.zeros(4 * 16 + 1, dtype=torch.bfloat16)
    view = base[1:].view(4, 16)  # 2 bytes past a 16-byte boundary
    assert view.data_ptr() % 16 != 0
    fixed = kernels.aligned(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    whole = torch.zeros(4, 16, dtype=torch.bfloat16)
    assert kernels.aligned(whole) is whole
