"""The bf16 wide attention forward of rows 1 and 11 above head size 256
(csrc/attention_wide.cuh): its plan and its algorithm, on the CPU, against
the Pallas kernels of ops/pallas_attention.py and
ops/pallas_attention_dropout.py in interpret mode.

No CUDA kernel runs here. ``kernels.wide_plan`` is the plan the wrappers
pass to the kernel: its clusters must cover every slice of the head and
every row of a query tile exactly once and fit the card's shared memory.
The mirror below is plain torch, kept in this file and not in the package:
the kernel's arithmetic in its order. A cluster of C blocks takes a tile of
64 query rows; block r adds q_r K_r^T over its own 64-column slices; each
64-key chunk's partials are summed over the blocks in rank order; with one
pass the logits stay and the exact row max and sum follow, with two a
running max and sum; the weights, times the dropout factor, are rounded to
the operand dtype before P . V over each block's slices. In f32 the mirror
and the plain versions agree with the Pallas kernels within rtol 2e-4 /
atol 2e-5 (another summation order only); the dropout mask is the Pallas
kernel's entry for entry."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video2music_tpu.ops.pallas_attention import flash_attention as jax_flash
from video2music_tpu.ops.pallas_attention_dropout import (
    extract_dropped_probs as jax_extract, flash_attention_dropout as jax_fad)
from video2music_tpu_torch import kernels
from video2music_tpu_torch.ops import flash_attention_dropout as fad
from video2music_tpu_torch.ops.flash_attention import NEG_INF, flash_attention

torch.set_num_threads(1)
INTERP = pltpu.InterpretParams()
F32 = dict(rtol=2e-4, atol=2e-5)
TILE, CHUNK, SLICE = kernels.WIDE_TILE, kernels.WIDE_CHUNK, kernels.WIDE_SLICE
SMS = 132  # an H100 SXM's streaming multiprocessors
CSRC = os.path.join(os.path.dirname(kernels.__file__), "csrc")
L = 130  # three key chunks, a partial last query tile


def _pad(t, dims):
    """t with zeros appended: dims maps an axis to its new length."""
    for axis, n in dims.items():
        extra = n - t.shape[axis]
        if extra:
            shape = list(t.shape)
            shape[axis] = extra
            t = torch.cat([t, t.new_zeros(shape)], axis)
    return t


def mirror_forward(q, k, v, plan, bias=None, causal=False, rate=0.0, seed=0):
    """(out, m, l): the wide forward's arithmetic under ``plan``. q (B, H,
    L, D), k / v (B, H, S, D), bias (1 or B, H, L, S) or None."""
    B, H, Lq, D = q.shape
    S = k.shape[2]
    nd = kernels.head_instance(D, "mirror")[1]
    n_all = -(-S // CHUNK)
    Lp, Sp, Dp = -(-Lq // TILE) * TILE, n_all * CHUNK, nd * SLICE
    scale = D ** -0.5
    qp = _pad(q.float(), {2: Lp, 3: Dp})
    kp, vp = (_pad(t.float(), {2: Sp, 3: Dp}) for t in (k, v))
    bp = None if bias is None else _pad(bias.float(), {2: Lp, 3: Sp})
    mask = None if rate <= 0 else _pad(
        fad.dropout_mask(B, H, Lq, S, rate, seed, "cpu"), {2: Lp, 3: Sp})
    C = plan.cluster
    owned = [(r * nd // C * SLICE, (r + 1) * nd // C * SLICE)
             for r in range(C)]
    out = torch.zeros(B, H, Lp, Dp)
    m_all, l_all = torch.zeros(B, H, Lp), torch.zeros(B, H, Lp)
    cols = torch.arange(Sp)
    for t0 in range(0, Lp, TILE):
        rows = torch.arange(t0, t0 + TILE)
        n = min(n_all, t0 // CHUNK + 1) if causal else n_all
        lg = torch.empty(B, H, TILE, n * CHUNK)
        for c in range(n):
            ks = slice(c * CHUNK, (c + 1) * CHUNK)
            x = 0
            for a, b in owned:  # the partials, in rank order
                x = x + torch.einsum("bhld,bhsd->bhls", qp[:, :, t0:t0 + TILE, a:b],
                                     kp[:, :, ks, a:b])
            x = x * scale
            if bp is not None:
                x = x + bp[:, :, t0:t0 + TILE, ks]
            x = x.masked_fill(cols[None, ks] >= S, -torch.inf)
            if causal:
                x = x.masked_fill((cols[None, ks] > rows[:, None])
                                  & (cols[None, ks] < S), NEG_INF)
            lg[..., ks] = x
        if plan.passes == 1:  # the exact row max and sum
            m = lg.amax(-1)
            l = torch.exp(lg - m[..., None]).sum(-1)
        else:  # a running max and sum over the chunks
            m = torch.full((B, H, TILE), -torch.inf)
            l = torch.zeros(B, H, TILE)
            for c in range(n):
                x = lg[..., c * CHUNK:(c + 1) * CHUNK]
                mx = torch.maximum(m, x.amax(-1))
                l = l * torch.exp(m - mx) + torch.exp(x - mx[..., None]).sum(-1)
                m = mx
        w = torch.exp(lg - m[..., None]) / l[..., None]
        if mask is not None:
            w = w * mask[:, :, t0:t0 + TILE, :n * CHUNK]
        w = w.to(v.dtype).float()
        for a, b in owned:  # each block's own columns of O
            out[:, :, t0:t0 + TILE, a:b] = torch.einsum(
                "bhls,bhsd->bhld", w, vp[:, :, :n * CHUNK, a:b])
        m_all[:, :, t0:t0 + TILE], l_all[:, :, t0:t0 + TILE] = m, l
    return (out[:, :, :Lq, :D].to(q.dtype), m_all[:, :, :Lq],
            l_all[:, :, :Lq])


def _inputs(D, seed, B=2, H=2, S=L):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, L, D)).astype(np.float32)
    k, v = (r.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(2))
    bias = r.standard_normal((1, H, L, S)).astype(np.float32)
    return q, k, v, bias


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               err_msg=msg, **F32)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

WIDE_D = [257, 264, 320, 384, 448, 512, 576, 1000, 1024, 1088, 2048, 3000,
          4096]


@pytest.mark.parametrize("D", WIDE_D)
def test_wide_plan_covers_and_fits(D):
    """Across head sizes 257..4096, key counts up to past the one-pass cut
    and small and large grids: the cluster's blocks own every slice and
    every row of a tile exactly once, none more than ``slices`` slices or
    16 rows; the cluster is within the limit the plan declares (the
    launch's grid is tiles x cluster blocks); the shared bytes fit a
    block; one pass
    exactly where S is at most the cut the plan states; two slices a block
    at most where the cluster was halved. The f32 plan: the same cluster,
    its own shared bytes and one-pass cut (with the plan's slices), and
    the f32 backward's two kernels fitting a block on that cluster."""
    nd = kernels.head_instance(D, "t")[1]
    assert kernels.padded_head(D, "t") == nd * SLICE >= D
    for tiles in (1, 5, 80, 400):
        for S in (1, 130, 300, 1100, 1984, 1985, 3264, 3265, 8000):
            p = kernels.wide_plan(D, S, "t", tiles, SMS)
            C = p.cluster
            assert kernels.WIDE_CLUSTER_MIN <= C <= min(
                nd, kernels.WIDE_CLUSTER_MAX)
            if C < min(nd, kernels.WIDE_CLUSTER_MAX):
                assert p.slices <= kernels.WIDE_GROUP
            owned = [range(r * nd // C, (r + 1) * nd // C) for r in range(C)]
            assert sorted(i for o in owned for i in o) == list(range(nd))
            assert max(len(o) for o in owned) == p.slices == -(-nd // C)
            rows = [range(r * TILE // C, (r + 1) * TILE // C)
                    for r in range(C)]
            assert sorted(i for o in rows for i in o) == list(range(TILE))
            assert max(len(o) for o in rows) <= 16
            assert p.smem == kernels.wide_smem(C, S, p.passes)
            assert p.smem <= kernels.SMEM_MAX
            cut = kernels.wide_one_pass_keys(C)
            assert p.passes == (1 if S <= cut else 2)
            assert kernels.wide_smem(C, cut, 1) <= kernels.SMEM_MAX
            assert kernels.wide_smem(C, cut + CHUNK, 1) > kernels.SMEM_MAX
            # f32: the same cluster, its own shared bytes and one-pass cut
            # (its q slices resident or streamed); the backward's two
            # kernels fit on the forward's cluster
            f = kernels.wide_plan(D, S, "t", tiles, SMS, f32=True)
            assert f[:2] == p[:2]
            assert f.smem == kernels.wide_smem_f32(C, f.slices, S, f.passes)
            assert f.smem <= kernels.SMEM_MAX
            cut = kernels.wide_one_pass_keys(C, f.slices)
            assert cut >= CHUNK and f.passes == (1 if S <= cut else 2)
            assert kernels.wide_smem_f32(C, f.slices, cut, 1) <= \
                kernels.SMEM_MAX
            assert kernels.wide_smem_f32(C, f.slices, cut + CHUNK, 1) > \
                kernels.SMEM_MAX
            for dkv in (False, True):
                assert kernels.wide_bwd_smem_f32(f.slices, dkv) <= \
                    kernels.SMEM_MAX


def test_wide_plan_refuses(monkeypatch):
    """No wide plan for a head the narrow instances take or for no keys;
    the plan's arguments reach the launches above 256 in the call's dtype;
    the
    cluster halves only past one wave of two blocks an SM (head size 512,
    L = 300: eight blocks a tile at B*H = 1 and 4, four at 8 and 16; head
    size 1024 keeps eight, four blocks would hold four slices each)."""
    with pytest.raises(ValueError, match="narrow instances"):
        kernels.wide_plan(256, 300, "flash_attention", 1, SMS)
    with pytest.raises(ValueError, match="keys"):
        kernels.wide_plan(512, 0, "flash_attention", 1, SMS)
    bf16, f32 = kernels.DTYPE_CODES["bfloat16"], kernels.DTYPE_CODES["float32"]
    assert kernels.wide_plan_arg(256, 300, 5, bf16, "t", "cpu") is None
    assert kernels.wide_plan_arg(256, 300, 5, f32, "t", "cpu") is None
    # the card's SM count as device_sms reads it on a card; the plan in the
    # call's dtype (f32 since its kernels run the cluster plan too)
    monkeypatch.setattr(kernels, "device_sms", lambda device: SMS)
    assert list(kernels.wide_plan_arg(512, 300, 5, bf16, "t", "cuda")) == \
        list(kernels.wide_plan(512, 300, "t", 5, SMS))
    assert list(kernels.wide_plan_arg(512, 300, 5, f32, "t", "cuda")) == \
        list(kernels.wide_plan(512, 300, "t", 5, SMS, f32=True))
    for tiles, C in ((5, 8), (20, 8), (40, 4), (80, 4)):
        assert kernels.wide_plan(512, 300, "t", tiles, SMS).cluster == C
    assert kernels.wide_plan(1024, 300, "t", 80, SMS).cluster == 8
    # a card of fewer SMs halves at fewer tiles
    assert kernels.wide_plan(512, 300, "t", 20, 78).cluster == 4


def _constexprs(name):
    """The ``constexpr int k... = <int>;`` constants of a csrc header."""
    with open(os.path.join(CSRC, name)) as f:
        return {k: int(v) for k, v in re.findall(
            r"constexpr int (k\w+) = (\d+);", f.read())}


def test_wide_constants_match_the_header():
    """The plan's constants in kernels.py are the kernel's: the tile, the
    chunk, the slice, the ring's stages, the products' group, the cluster
    limits, the f32 pieces' padding and the shared-memory limit, as
    csrc/attention_wide.cuh and
    csrc/attention_mma.cuh declare them (the launch also refuses a plan
    whose shared bytes differ from the kernel's own count)."""
    wide, mma = _constexprs("attention_wide.cuh"), _constexprs(
        "attention_mma.cuh")
    assert (kernels.WIDE_TILE, kernels.WIDE_SLICE, kernels.WIDE_STAGES,
            kernels.WIDE_GROUP, kernels.WIDE_CLUSTER_MIN,
            kernels.WIDE_CLUSTER_MAX, kernels.WIDE_F32_PAD,
            kernels.SMEM_MAX) == (
        wide["kTile"], wide["kWide"], wide["kStages"], wide["kGroup"],
        wide["kClusterMin"], wide["kClusterMax"], wide["kPadF32"],
        wide["kSmemMax"])
    assert kernels.WIDE_CHUNK == mma["kChunk"]


# ---------------------------------------------------------------------------
# the plain versions and the mirror against the Pallas kernels (f32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bias", "causal"])
@pytest.mark.parametrize("D", [264, 1024])
def test_wide_flash_attention_matches_pallas(D, mode):
    """Row 1 at head sizes 264 and 1024, B=2, H=2, L=S=130 (three key
    chunks, a partial last tile), with a bias shared by the batch's rows
    ((1, H, L, S), read in place) or the causal mask: the plain version
    (the CPU path of the wrapper) and the mirror under the wrappers' plan
    and under a two-pass plan against the Pallas kernel in interpret
    mode."""
    q, k, v, bias = _inputs(D, D + len(mode))
    causal = mode == "causal"
    b = bias if mode == "bias" else None
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     bias=None if b is None else jnp.asarray(
                         np.broadcast_to(b, (2, 2, L, L))),
                     causal=causal, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tb = None if b is None else torch.from_numpy(b)
    _close(flash_attention(tq, tk, tv, bias=tb, causal=causal), want,
           f"plain D={D} {mode}")
    plan = kernels.wide_plan(D, L, "t", 2 * 2 * -(-L // TILE), SMS)
    for p in (plan, plan._replace(passes=2)):
        got = mirror_forward(tq, tk, tv, p, bias=tb, causal=causal)[0]
        _close(got, want, f"mirror D={D} {mode} plan {tuple(p)}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [264, 1024])
def test_wide_dropout_attention_matches_pallas(D, causal):
    """Row 11's forward at head sizes 264 and 1024, B=2, H=2, L=S=130,
    rate 0.1: the plain forward and the mirror (one and two passes, its
    row max and sum against the plain softmax's) against the Pallas
    dropout attention in interpret mode, and the dropped probabilities
    (the mask) equal to the Pallas kernel's entry for entry."""
    rate, seed = 0.1, 7
    q, k, v, _ = _inputs(D, D + 3 * causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax_fad(jq, jk, jv, causal=causal, dropout_rate=rate, seed=seed,
                   interpret=INTERP)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got, _ = fad.flash_attention_dropout_fwd(tq, tk, tv, None, seed, causal,
                                             rate)
    _close(got, want, f"plain D={D}")
    logits = torch.einsum("bhld,bhsd->bhls", tq, tk) * D ** -0.5
    if causal:
        logits = logits.masked_fill(torch.ones(L, L).triu(1).bool(), NEG_INF)
    m_ref = logits.amax(-1)
    l_ref = torch.exp(logits - m_ref[..., None]).sum(-1)
    plan = kernels.wide_plan(D, L, "t", 2 * 2 * -(-L // TILE), SMS)
    for p in (plan, plan._replace(passes=2)):
        out, m, l = mirror_forward(tq, tk, tv, p, causal=causal, rate=rate,
                                   seed=seed)
        _close(out, want, f"mirror D={D} plan {tuple(p)}")
        np.testing.assert_allclose(m, m_ref, **F32)
        np.testing.assert_allclose(l, l_ref, **F32)
    jm = np.asarray(jnp.asarray(jax_extract(
        jq, jk, causal=causal, dropout_rate=rate, seed=seed,
        interpret=INTERP), jnp.float32))
    pm = fad.extract_dropped_probs(tq, tk, causal=causal, dropout_rate=rate,
                                   seed=seed).numpy()
    np.testing.assert_array_equal(pm == 0, jm == 0)
    np.testing.assert_allclose(pm, jm, **F32)
