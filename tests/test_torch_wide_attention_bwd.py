"""The bf16 wide backward of row 11 above head size 256
(csrc/attention_wide.cuh: one thread-block cluster a 64-row query tile for
dQ, D and dbias, one a 64-row key tile for dK and dV, S and dP formed once
a (tile, chunk)) against the Pallas kernel of
ops/pallas_attention_dropout.py in interpret mode, on the CPU.

No CUDA kernel runs here. The mirror below is plain torch, kept in this
file and not in the package: the kernels' arithmetic in their order, on
tests/test_torch_wide_attention_f32.py's padding and ownership helpers. A
cluster of C blocks takes a 64-row tile; block r owns the slices [r nd /
C, (r + 1) nd / C) of 64 columns. For each 64-row chunk of the other side
a block adds its partials of S and dP over its slices (bf16 operands, f32
products and sums); the blocks' partials are summed in rank order in f32,
and so are their partials of D = rowsum(dO * O), O the bf16 output of the
forward. The owners form P from the forward's (m, l) and dS = P (dP * mask
- D) in f32 (dbias), and P * mask and dS are rounded to bf16 as the
operands of dQ += dS K, dV += (P * mask)^T dO and dK += dS^T q. The
mirror, on the bf16 forward mirror of tests/test_torch_wide_attention.py,
agrees with the Pallas backward within 2e-2 of each gradient's largest
value, chip_smoke.py's bf16 bound, at the wrappers' clusters and at
clusters of four."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention_f32 import INTERP, RATE, SEED, _inputs
from test_torch_wide_attention import CSRC, mirror_forward
from test_torch_wide_attention_f32 import _owned, _pad, _padded

from video2music_tpu.ops.pallas_attention_dropout import (
    flash_attention_dropout as jax_fad)
from video2music_tpu_torch import kernels
from video2music_tpu_torch.ops.flash_attention import NEG_INF

torch.set_num_threads(1)
TILE, CHUNK, SLICE = kernels.WIDE_TILE, kernels.WIDE_CHUNK, kernels.WIDE_SLICE
BF16_REL = 2e-2  # chip_smoke.py's bf16 bound
SMS = 132        # an H100 SXM's streaming multiprocessors
L = 70           # two tiles and two chunks, the second ragged
NAMES = ("dq", "dk", "dv", "dbias")


def rnd(t):
    """t rounded to bf16, as the kernels round an operand."""
    return t.to(torch.bfloat16).float()


def _reduced(a, b, owned):
    """The cluster's a b^T: each block's partial over its own columns (one
    f32 product of bf16 values), summed over the blocks in rank order."""
    x = 0
    for c0, c1 in owned:
        x = x + a[..., c0:c1] @ b[..., c0:c1].transpose(-1, -2)
    return x


def mirror_backward(q, k, v, out, do, m, l, plan, bias=None, causal=False,
                    rate=0.0, seed=0, operand=rnd):
    """(dq, dk, dv in bf16, dbias f32 or None): the bf16 wide backward
    under ``plan``'s cluster, from the forward's bf16 output and (m, l);
    ``operand`` rounds P * mask and dS before their products."""
    B, H, Lq, D = q.shape
    S = k.shape[2]
    scale = D ** -0.5
    qp, kp, vp, bp, f, (Lp, Sp, nd) = _padded(q.float(), k.float(),
                                              v.float(), bias, rate, seed)
    dop, op = (_pad(t.float(), {2: Lp, 3: nd * SLICE}) for t in (do, out))
    mp, lp = _pad(m, {2: Lp}), _pad(l, {2: Lp}) + (torch.arange(Lp) >= Lq)
    owned = _owned(nd, plan.cluster)
    live_q = torch.arange(Lp) < Lq
    dsum = 0  # D: the blocks' partials of rowsum(dO * O), in rank order
    for a, b in owned:
        dsum = dsum + (dop[..., a:b] * op[..., a:b]).sum(-1)
    dq = torch.zeros(qp.shape)
    dbias = torch.zeros(B, H, Lp, Sp) if bias is not None else None
    for t0 in range(0, Lp, TILE):  # dQ: a query tile
        tr = slice(t0, t0 + TILE)
        rows = torch.arange(t0, t0 + TILE)
        n = min(Sp // CHUNK, t0 // CHUNK + 1) if causal else Sp // CHUNK
        acc = 0
        for c in range(n):
            cs = slice(c * CHUNK, (c + 1) * CHUNK)
            cols = torch.arange(c * CHUNK, (c + 1) * CHUNK)
            s = _reduced(qp[:, :, tr], kp[:, :, cs], owned) * scale
            if bp is not None:
                s = s + bp[:, :, tr, cs]
            s = s.masked_fill(cols[None, :] >= S, -torch.inf)
            if causal:
                s = s.masked_fill((cols[None, :] > rows[:, None])
                                  & (cols[None, :] < S), NEG_INF)
            dp = _reduced(dop[:, :, tr], vp[:, :, cs], owned)
            p = torch.exp(s - mp[:, :, tr, None]) / lp[:, :, tr, None]
            ds = torch.where(live_q[tr, None],
                             p * (dp * f[:, :, tr, cs] - dsum[:, :, tr, None]),
                             0.0)
            if dbias is not None:
                dbias[:, :, tr, cs] = ds
            acc = acc + operand(ds) @ kp[:, :, cs]
        dq[:, :, tr] = acc * scale
    dk, dv = torch.zeros(kp.shape), torch.zeros(vp.shape)
    for k0 in range(0, Sp, TILE):  # dK / dV: a key tile
        kr = slice(k0, k0 + TILE)
        keys = torch.arange(k0, k0 + TILE)
        acc_k = acc_v = 0
        for c in range(k0 // CHUNK if causal else 0, Lp // CHUNK):
            qs = slice(c * CHUNK, (c + 1) * CHUNK)
            queries = torch.arange(c * CHUNK, (c + 1) * CHUNK)
            st = _reduced(kp[:, :, kr], qp[:, :, qs], owned) * scale
            if bp is not None:
                st = st + bp[:, :, qs, kr].transpose(-1, -2)
            if causal:
                st = st.masked_fill(keys[:, None] > queries[None, :], NEG_INF)
            dpt = _reduced(vp[:, :, kr], dop[:, :, qs], owned)
            pt = torch.exp(st - mp[:, :, None, qs]) / lp[:, :, None, qs]
            ft = f[:, :, qs, kr].transpose(-1, -2)
            live = (queries < Lq)[None, :]
            pm = torch.where(live, pt * ft, 0.0)
            dst = torch.where(live, pt * (dpt * ft - dsum[:, :, None, qs]),
                              0.0)
            acc_v = acc_v + operand(pm) @ dop[:, :, qs]
            acc_k = acc_k + operand(dst) @ qp[:, :, qs]
        dk[:, :, kr], dv[:, :, kr] = acc_k * scale, acc_v
    return (rnd(dq[:, :, :Lq, :D]), rnd(dk[:, :, :S, :D]),
            rnd(dv[:, :, :S, :D]),
            None if dbias is None else dbias[:, :, :Lq, :S])


def _pallas_bf16(q, k, v, b, do, causal):
    """The Pallas kernel's (dq, dk, dv[, dbias]) from bf16 q, k, v, dO
    (the bias f32), as f32 arrays."""
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)] + (
        [jnp.asarray(b)] if b is not None else [])

    def f(q_, k_, v_, *rest):
        return jax_fad(q_, k_, v_, bias=rest[0] if rest else None,
                       causal=causal, dropout_rate=RATE, seed=SEED,
                       interpret=INTERP)
    _, vjp = jax.vjp(f, *jargs)
    return [np.asarray(jnp.asarray(g, jnp.float32))
            for g in vjp(jnp.asarray(do, jnp.bfloat16))]


def _mirror(q, k, v, b, do, causal, plan, operand=rnd):
    tq, tk, tv, tdo = (torch.tensor(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    tb = None if b is None else torch.tensor(b)
    kw = dict(bias=tb, causal=causal, rate=RATE, seed=SEED)
    out, m, l = mirror_forward(tq, tk, tv, plan, **kw)
    return [g.float().numpy() for g in mirror_backward(
        tq, tk, tv, out, tdo, m, l, plan, operand=operand, **kw)
        if g is not None]


def _plans(D):
    """The wrappers' plan at B=1 (H=2, L=70: two tiles) and the cluster of
    four (at head size 512 the halved cluster of row 11's B=16 grid; at 264
    four blocks of one or two slices; at 1024 four slices a block, two
    groups)."""
    p = kernels.wide_plan(D, L, "mirror", 2 * -(-L // TILE), SMS)
    nd = kernels.head_instance(D, "mirror")[1]
    return p, p._replace(cluster=4, slices=-(-nd // 4))


MODES = {"plain": (False, False), "bias": (False, True),
         "causal": (True, False), "causal+bias": (True, True)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("D", [264, 512, 1024])
def test_bf16_wide_backward_mirror_matches_pallas(D, mode):
    """Row 11's backward in bf16 above head size 256: dq, dk, dv and dbias
    of the cluster mirror against the Pallas backward in interpret mode,
    dropout rate 0.1, B=1, H=2, L=S=70, at the wrappers' cluster (5, 8 and
    8 blocks) and at clusters of four, within 2e-2 of each gradient's
    largest value."""
    causal, use_bias = MODES[mode]
    q, k, v, b, do = _inputs(D + 3 * len(mode), 1, 2, L, D, use_bias)
    want = _pallas_bf16(q, k, v, b, do, causal)
    plans = _plans(D)
    nd = kernels.head_instance(D, "t")[1]
    assert [p.cluster for p in plans] == [min(nd, 8), 4]
    for p in plans:
        got = _mirror(q, k, v, b, do, causal, p)
        assert len(got) == len(want)
        for name, g, w in zip(NAMES, got, want):
            err = np.abs(g - w).max() / np.abs(w).max()
            assert err <= BF16_REL, (name, tuple(p), err)


def test_bf16_wide_backward_rounds_its_operands():
    """The rounding the bound allows for: the mirror with P * mask and dS
    left f32 (no operand rounded) moves dq, dk and dv away from the
    rounded mirror, and each stays within the bound of the Pallas
    backward."""
    D = 512
    q, k, v, b, do = _inputs(7, 1, 2, L, D, False)
    want = _pallas_bf16(q, k, v, b, do, False)
    plan = _plans(D)[1]
    rounded = _mirror(q, k, v, b, do, False, plan)
    exact = _mirror(q, k, v, b, do, False, plan, operand=lambda t: t)
    for name, r, e, w in zip(NAMES, rounded, exact, want):
        assert not np.array_equal(r, e), name
        for g in (r, e):
            assert np.abs(g - w).max() <= BF16_REL * np.abs(w).max(), name


WIDE_D = [257, 264, 320, 384, 448, 512, 576, 1000, 1024, 1088, 2048, 3000,
          4096]


def _bwd_smem_table():
    """csrc/attention_wide.cuh's kBwdSmem, the backward's shared bytes a
    block for 1 .. kBwdSlicesMax slices, [f32][dK / dV][slices - 1] (the
    compiler holds it to the header's bwd_smem)."""
    with open(os.path.join(CSRC, "attention_wide.cuh")) as f:
        text = f.read()
    body = re.search(r"kBwdSmem\[2\]\[2\]\[kBwdSlicesMax\] = (\{.*?\}\}\});",
                     text, re.S).group(1)
    nums = [int(x) for x in re.findall(r"\d+", body)]
    n = int(re.search(r"constexpr int kBwdSlicesMax = (\d+);", text).group(1))
    assert len(nums) == 4 * n
    return {(f32, dkv): nums[(2 * f32 + dkv) * n:(2 * f32 + dkv + 1) * n]
            for f32 in (False, True) for dkv in (False, True)}


@pytest.mark.parametrize("D", WIDE_D)
def test_wide_bwd_smem_fits(D):
    """The bf16 backward's two kernels fit a block on every plan of
    test_wide_plan_covers_and_fits's range (head sizes 257..4096, small to
    large grids, the forward's cluster), and kernels.wide_bwd_smem gives
    the header's own numbers (its kBwdSmem table) in both dtypes; the own
    side is resident while its pieces fit beside the ring and the tiles
    and streams beyond."""
    table = _bwd_smem_table()
    for (f32, dkv), want in table.items():
        assert [kernels.wide_bwd_smem(n, dkv, f32)
                for n in range(1, len(want) + 1)] == want
    for tiles in (1, 5, 80, 400):
        for S in (1, 130, 300, 1985, 8000):
            p = kernels.wide_plan(D, S, "t", tiles, SMS)
            for dkv in (False, True):
                got = kernels.wide_bwd_smem(p.slices, dkv)
                assert got <= kernels.SMEM_MAX
                assert got == table[False, dkv][p.slices - 1]
    # the edges: head size 4608 (9 slices a block at 8 blocks, chip_smoke.py's
    # bf16 edge) streams q and dO, and K and V; 4096 (8 slices) keeps q and
    # dO, streams K and V; 1024 at clusters of 4 (4 slices) keeps both
    assert not kernels.wide_bwd_resident(9, False)
    assert not kernels.wide_bwd_resident(9, True)
    assert kernels.wide_bwd_resident(8, False)
    assert not kernels.wide_bwd_resident(8, True)
    assert kernels.wide_bwd_resident(4, True)
