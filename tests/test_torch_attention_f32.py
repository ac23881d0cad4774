"""The algorithm of the port's f32 attention kernels of rows 1 and 11
(csrc/attention_tf32.cuh: split TF32 on the tensor cores) against the
Pallas kernels of ops/pallas_attention.py and ops/pallas_attention_dropout.py
in interpret mode, on the CPU.

No CUDA kernel runs here. The mirror below is plain torch, kept in this
file and not in the package: the kernels' arithmetic in their order.
cvt.rna.tf32.f32 is emulated by rounding away the low 13 mantissa bits
(to nearest, ties away from zero); every product a b is split TF32,
a_small b_big + a_big b_small + a_big b_big with x = big + small, big =
rna(x), small = rna(x - big), each part a product of TF32 values (exact in
f32) summed in f32, the small cross terms first. The forward makes one
pass over chunks of keys with the running row max and sum (the earlier
chunks rescaled as the max grows); the backward takes D = rowsum(dO * O)
from the forward's output, P from its (m, l), dS = P (dP * mask - D) (the
dbias), and splits its products the same way; nothing is rounded to bf16.
The mirror agrees with the Pallas kernels within rtol 2e-4 / atol 2e-5,
the bf16 mirror's f32 bound (tests/test_torch_attention_mma.py); single
TF32 products (the tensor cores' own f32 mode) leave it."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video2music_tpu.ops.pallas_attention import flash_attention as jax_flash
from video2music_tpu.ops.pallas_attention_dropout import (
    flash_attention_dropout as jax_fad)
from video2music_tpu_torch.kernels import CSRC
from video2music_tpu_torch.ops.flash_attention import (NEG_INF,
                                                       flash_attention_plain)
from video2music_tpu_torch.ops.flash_attention_dropout import dropout_mask

torch.set_num_threads(1)
INTERP = pltpu.InterpretParams()
F32 = dict(rtol=2e-4, atol=2e-5)
RATE, SEED = 0.1, 20241016


def tiles(D):
    """(forward keys a chunk, backward rows a chunk) of the kernels at head
    size D (attention_tf32.cuh Tile; the wrappers pad D up to 16, 32, 64,
    128 or 256)."""
    return (64, 32) if D <= 64 else (32, 16)


def rna(x):
    """f32 x rounded to TF32 as cvt.rna.tf32.f32: to nearest, ties away
    from zero (the sign bit apart, the bits are the magnitude), the low 13
    mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(x):
    big = rna(x)
    return big, rna(x - big)


def mm3(a, b):
    """a @ b in split TF32: the two small cross terms, then big . big."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (as_ @ bb + ab @ bs) + ab @ bb


def mm1(a, b):
    """a @ b with single TF32 operands."""
    return rna(a) @ rna(b)


def _logits(q, k, bias, causal, scale, c0, c1, mm):
    s = mm(q, k[:, :, c0:c1].transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[..., c0:c1]
    if causal:
        rows = torch.arange(q.shape[2])[:, None]
        s = s.masked_fill(torch.arange(c0, c1)[None, :] > rows, NEG_INF)
    return s


def _mask(q, k, rate, seed):
    B, H, L, _ = q.shape
    return dropout_mask(B, H, L, k.shape[2], rate, seed, "cpu") \
        if rate > 0 else None


def mirror_forward(q, k, v, bias=None, causal=False, rate=0.0, seed=0,
                   scale=None, mm=mm3):
    """(out, m, l): the f32 forward, one pass over the key chunks."""
    B, H, L, D = q.shape
    S = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    mask = _mask(q, k, rate, seed)
    m = torch.full((B, H, L), -torch.inf)
    l = torch.zeros(B, H, L)
    acc = torch.zeros(q.shape)
    chunk = tiles(D)[0]
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        s = _logits(q, k, bias, causal, scale, c0, c1, mm)
        mx = torch.maximum(m, s.amax(-1))
        f = torch.exp(m - mx)  # 0 before the first chunk
        w = torch.exp(s - mx[..., None])
        l = l * f + w.sum(-1)
        if mask is not None:
            w = w * mask[..., c0:c1]
        acc = acc * f[..., None] + mm(w, v[:, :, c0:c1])
        m = mx
    return acc / l[..., None], m, l


def mirror_backward(q, k, v, out, do, m, l, bias=None, causal=False,
                    rate=0.0, seed=0, mm=mm3):
    """(dq, dk, dv, dbias or None): the f32 backward over the key chunks,
    D from the forward's output."""
    B, H, L, D = q.shape
    S = k.shape[2]
    scale = D ** -0.5
    mask = _mask(q, k, rate, seed)
    dsum = (do * out).sum(-1)
    dq = torch.zeros(q.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    dbias = None if bias is None else torch.zeros(B, H, L, S)
    chunk = tiles(D)[1]
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        kc, vc = k[:, :, c0:c1], v[:, :, c0:c1]
        p = torch.exp(_logits(q, k, bias, causal, scale, c0, c1, mm)
                      - m[..., None]) / l[..., None]
        dp = mm(do, vc.transpose(-1, -2))
        f = 1.0 if mask is None else mask[..., c0:c1]
        ds = p * (dp * f - dsum[..., None])
        if dbias is not None:
            dbias[..., c0:c1] = ds
        dq += mm(ds, kc)
        dv[:, :, c0:c1] = mm((p * f).transpose(-1, -2), do)
        dk[:, :, c0:c1] = mm(ds.transpose(-1, -2), q)
    return dq * scale, dk * scale, dv, dbias


def _inputs(seed, B, H, L, D, use_bias):
    r = np.random.default_rng(seed)
    q, k, v, do = (r.standard_normal((B, H, L, D)).astype(np.float32)
                   for _ in range(4))
    b = r.standard_normal((B, H, L, L)).astype(np.float32) \
        if use_bias else None
    return q, k, v, b, do


def _pallas_dropout(q, k, v, b, do, causal):
    """The Pallas kernel's (out, dq, dk, dv[, dbias]) in f32."""
    jargs = [jnp.asarray(a) for a in (q, k, v)] + (
        [jnp.asarray(b)] if b is not None else [])

    def f(q_, k_, v_, *rest):
        return jax_fad(q_, k_, v_, bias=rest[0] if rest else None,
                       causal=causal, dropout_rate=RATE, seed=SEED,
                       interpret=INTERP)
    jout, vjp = jax.vjp(f, *jargs)
    return [np.asarray(x) for x in [jout] + list(vjp(jnp.asarray(do)))]


def _mirror_dropout(q, k, v, b, do, causal, mm=mm3):
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    tb = None if b is None else torch.tensor(b)
    kw = dict(bias=tb, causal=causal, rate=RATE, seed=SEED, mm=mm)
    out, m, l = mirror_forward(tq, tk, tv, **kw)
    grads = mirror_backward(tq, tk, tv, out, tdo, m, l, **kw)
    return [out.numpy()] + [g.numpy() for g in grads if g is not None]


NAMES = ("out", "dq", "dk", "dv", "dbias")


def test_rna_rounds_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10  # a TF32 ulp at 1
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                      3.0, 0.0, -0.0, 2.0 ** -130], dtype=torch.float32)
    want = [1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3.0, 0.0, -0.0, 2.0 ** -130]
    assert rna(x).tolist() == want
    r = np.random.default_rng(1)
    y = torch.tensor(r.standard_normal(4096).astype(np.float32))
    big, small = split(y)
    assert torch.equal(rna(big), big) and torch.equal(rna(small), small)
    # big + small holds ~22 bits of y; big alone ~11
    assert ((big + small - y).abs() <= y.abs() * 2.0 ** -21).all()
    assert ((big - y).abs() <= y.abs() * 2.0 ** -11).all()
    assert ((big - y).abs() > y.abs() * 2.0 ** -21).any()


CASES = [  # (L, D, causal, use_bias): the training width, a ragged length,
    # the small head sizes, a bias under the causal mask
    (300, 64, False, False), (300, 64, True, False), (77, 64, True, True),
    (130, 32, False, True), (70, 16, True, False)]


@pytest.mark.parametrize("L,D,causal,use_bias", CASES)
def test_f32_dropout_mirror_matches_pallas(L, D, causal, use_bias):
    """Row 11 in f32: the forward, dq, dk, dv and dbias of the split-TF32
    mirror against the Pallas kernel's, dropout rate 0.1."""
    q, k, v, b, do = _inputs(L + D, 1, 2, L, D, use_bias)
    want = _pallas_dropout(q, k, v, b, do, causal)
    got = _mirror_dropout(q, k, v, b, do, causal)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **F32)


@pytest.mark.parametrize("mode", ["plain", "causal", "bias", "shared",
                                  "scale"])
def test_f32_flash_mirror_matches_pallas(mode):
    """Row 1 in f32 (no dropout, no stats): plain, causal, a full bias, a
    bias shared by every batch row ((1, H, L, S), MaxViT's, read in place
    by the kernel) and a scale other than D**-0.5 (the Pallas kernel takes
    none: its q is scaled to match), B=2, H=2, L=S=130, D=32."""
    B, H, L, D = 2, 2, 130, 32
    q, k, v, b, _ = _inputs(7 + len(mode), B, H, L, D, mode == "bias")
    if mode == "shared":
        b = np.random.default_rng(3).standard_normal(
            (1, H, L, L)).astype(np.float32)
    scale = 64 ** -0.5 if mode == "scale" else None
    jq = q if scale is None else q * np.float32(scale / D ** -0.5)
    want = jax_flash(*(jnp.asarray(a) for a in (jq, k, v)),
                     bias=None if b is None else jnp.asarray(
                         np.broadcast_to(b, (B, H, L, L))),
                     causal=mode == "causal", interpret=True)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    tb = None if b is None else torch.tensor(b)
    got, _, _ = mirror_forward(tq, tk, tv, bias=tb, causal=mode == "causal",
                               scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the plain version (the wrappers' CPU path) agrees too
    plain = flash_attention_plain(tq, tk, tv, bias=tb,
                                  causal=mode == "causal", scale=scale)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **F32)


def test_single_tf32_leaves_the_f32_bound():
    """At the training head size (D=64, L=300) single TF32 products keep
    ~3 digits: the mirror with them leaves the f32 bound the split-TF32
    mirror keeps, in the forward and in every gradient. So the kernels
    need the three products."""
    q, k, v, b, do = _inputs(364, 1, 2, 300, 64, False)
    want = _pallas_dropout(q, k, v, b, do, False)
    got = _mirror_dropout(q, k, v, b, do, False, mm=mm1)
    for name, g, w in zip(NAMES, got, want):
        assert not np.allclose(g, w, **F32), name
        # still attention: within a few 1e-3 of the largest magnitude
        assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), name


def test_mirror_tiles_are_the_header_tiles():
    """The mirror's chunks are the kernels' (attention_tf32.cuh Tile): the
    forward's keys and the backward's rows a chunk, at head sizes up to 64
    and above."""
    with open(os.path.join(CSRC, "attention_tf32.cuh")) as f:
        src = f.read()
    found = {}
    for name in ("kFwdKeys", "kBwdRows"):
        m = re.search(rf"int {name} = HD <= (\d+) \? (\d+) : (\d+);", src)
        assert m, name
        found[name] = tuple(int(x) for x in m.groups())
    for D in (16, 32, 64, 128, 256):
        fwd, bwd = found["kFwdKeys"], found["kBwdRows"]
        assert tiles(D) == (fwd[1] if D <= fwd[0] else fwd[2],
                            bwd[1] if D <= bwd[0] else bwd[2])
