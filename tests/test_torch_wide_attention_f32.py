"""The f32 wide attention of rows 1 and 11 above head size 256
(csrc/attention_wide.cuh: split TF32 on the tensor cores, one
thread-block cluster a tile) against the Pallas kernels of
ops/pallas_attention.py and ops/pallas_attention_dropout.py in interpret
mode, on the CPU.

No CUDA kernel runs here. The mirror below is plain torch, kept in this
file and not in the package: the kernels' arithmetic in their order, with
tests/test_torch_attention_f32.py's emulation of split TF32 (rna, split,
mm3). A cluster of C blocks takes a 64-row tile; block r owns the slices
[r nd / C, (r + 1) nd / C) of 64 columns. For each 64-row chunk of the
other side a block adds its partial of S (and in the backward of dP) over
its slices, one product a chain of kChainSlices k-slices (32 columns),
added to the sum in order; the blocks' partials are summed in rank order.
The forward keeps the logits (one pass: the exact row max and sum) or a
running max and sum (two passes), weighs each chunk in f32 (times the
dropout factor) and adds one product a chunk of P . V. The backward takes
D as the blocks' partials of rowsum(dO * O) summed in rank order, forms
P from the forward's (m, l) and dS = P (dP * mask - D) (the dbias) once a
(tile, chunk), and adds one product a chunk of dS K (dQ), (P * mask)^T dO
(dV) and dS^T q (dK). The mirror agrees with the Pallas kernels within
rtol 2e-4 / atol 2e-5, the f32 bound of tests/test_torch_attention_f32.py;
single TF32 products leave it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention_f32 import (F32, NAMES, RATE, SEED, _inputs,
                                      _pallas_dropout, mm1, mm3, rna, split)

from video2music_tpu.ops.pallas_attention import flash_attention as jax_flash
from video2music_tpu_torch import kernels
from video2music_tpu_torch.ops.flash_attention import NEG_INF
from video2music_tpu_torch.ops.flash_attention_dropout import dropout_mask

torch.set_num_threads(1)
TILE, CHUNK, SLICE = kernels.WIDE_TILE, kernels.WIDE_CHUNK, kernels.WIDE_SLICE
CHAIN = 4 * 8  # columns of one chain: kChainSlices k-slices of 8
SMS = 132      # an H100 SXM's streaming multiprocessors
L = 70         # two tiles and two chunks, the second ragged


def _pad(t, dims):
    """t with zeros appended: dims maps an axis to its new length."""
    for axis, n in dims.items():
        extra = n - t.shape[axis]
        if extra:
            shape = list(t.shape)
            shape[axis] = extra
            t = torch.cat([t, t.new_zeros(shape)], axis)
    return t


def _owned(nd, C):
    """Each block's columns [a, b) of the padded head, in rank order."""
    return [(r * nd // C * SLICE, (r + 1) * nd // C * SLICE)
            for r in range(C)]


def _reduced(a, b, owned, mm):
    """The cluster's a b^T: each block's partial over its own columns, one
    product a chain of CHAIN columns added in order, summed over the blocks
    in rank order."""
    x = 0
    for c0, c1 in owned:
        part = 0
        for k0 in range(c0, c1, CHAIN):
            part = part + mm(a[..., k0:k0 + CHAIN],
                             b[..., k0:k0 + CHAIN].transpose(-1, -2))
        x = x + part
    return x


def _padded(q, k, v, bias, rate, seed):
    """The inputs padded to whole tiles, chunks and slices, the padded
    dropout factor, and (Lp, Sp, nd)."""
    B, H, Lq, D = q.shape
    S = k.shape[2]
    nd = kernels.head_instance(D, "mirror")[1]
    Lp, Sp = -(-Lq // TILE) * TILE, -(-S // CHUNK) * CHUNK
    qp = _pad(q, {2: Lp, 3: nd * SLICE})
    kp, vp = (_pad(t, {2: Sp, 3: nd * SLICE}) for t in (k, v))
    bp = None if bias is None else _pad(
        bias.expand(B, H, Lq, S), {2: Lp, 3: Sp})
    f = torch.ones(B, H, Lp, Sp) if rate <= 0 else _pad(
        dropout_mask(B, H, Lq, S, rate, seed, "cpu"), {2: Lp, 3: Sp})
    return qp, kp, vp, bp, f, (Lp, Sp, nd)


def _logits(x, bp, rows, cols, S, causal, scale):
    """Reduced dot products into logits: * scale, + bias, -inf past S,
    -1e9 above the causal diagonal."""
    x = x * scale
    if bp is not None:
        x = x + bp
    x = x.masked_fill(cols[None, :] >= S, -torch.inf)
    if causal:
        x = x.masked_fill((cols[None, :] > rows[:, None])
                          & (cols[None, :] < S), NEG_INF)
    return x


def mirror_forward(q, k, v, plan, bias=None, causal=False, rate=0.0,
                   seed=0, scale=None, mm=mm3):
    """(out, m, l): the f32 wide forward under ``plan``. q (B, H, L, D),
    k / v (B, H, S, D), bias (1 or B, H, L, S) or None."""
    B, H, Lq, D = q.shape
    S = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    qp, kp, vp, bp, f, (Lp, Sp, nd) = _padded(q, k, v, bias, rate, seed)
    owned = _owned(nd, plan.cluster)
    n_all = Sp // CHUNK
    out = torch.zeros(B, H, Lp, nd * SLICE)
    m_all, l_all = torch.zeros(B, H, Lp), torch.zeros(B, H, Lp)
    for t0 in range(0, Lp, TILE):
        tr = slice(t0, t0 + TILE)
        rows = torch.arange(t0, t0 + TILE)
        n = min(n_all, t0 // CHUNK + 1) if causal else n_all
        lg = torch.empty(B, H, TILE, n * CHUNK)
        for c in range(n):
            cs = slice(c * CHUNK, (c + 1) * CHUNK)
            lg[..., cs] = _logits(
                _reduced(qp[:, :, tr], kp[:, :, cs], owned, mm),
                None if bp is None else bp[:, :, tr, cs], rows,
                torch.arange(c * CHUNK, (c + 1) * CHUNK), S, causal, scale)
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
        w = torch.exp(lg - m[..., None]) / l[..., None] * f[:, :, tr, :n * CHUNK]
        acc = 0
        for c in range(n):  # one product a chunk, added in order
            cs = slice(c * CHUNK, (c + 1) * CHUNK)
            acc = acc + mm(w[..., cs], vp[:, :, cs])
        out[:, :, tr] = acc
        m_all[:, :, tr], l_all[:, :, tr] = m, l
    return out[:, :, :Lq, :D], m_all[:, :, :Lq], l_all[:, :, :Lq]


def mirror_backward(q, k, v, out, do, m, l, plan, bias=None, causal=False,
                    rate=0.0, seed=0, mm=mm3):
    """(dq, dk, dv, dbias or None): the f32 wide backward under ``plan``'s
    cluster, from the forward's output and (m, l)."""
    B, H, Lq, D = q.shape
    S = k.shape[2]
    scale = D ** -0.5
    qp, kp, vp, bp, f, (Lp, Sp, nd) = _padded(q, k, v, bias, rate, seed)
    dop, op = (_pad(t, {2: Lp, 3: nd * SLICE}) for t in (do, out))
    mp, lp = _pad(m, {2: Lp}), _pad(l, {2: Lp}) + (torch.arange(Lp) >= Lq)
    owned = _owned(nd, plan.cluster)
    live_q = (torch.arange(Lp) < Lq)[:, None]
    # D: the blocks' partials of rowsum(dO * O), in rank order
    dsum = 0
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
            s = _logits(_reduced(qp[:, :, tr], kp[:, :, cs], owned, mm),
                        None if bp is None else bp[:, :, tr, cs], rows,
                        torch.arange(c * CHUNK, (c + 1) * CHUNK), S, causal,
                        scale)
            dp = _reduced(dop[:, :, tr], vp[:, :, cs], owned, mm)
            p = torch.exp(s - mp[:, :, tr, None]) / lp[:, :, tr, None]
            ds = torch.where(live_q[tr],
                             p * (dp * f[:, :, tr, cs] - dsum[:, :, tr, None]),
                             0.0)
            if dbias is not None:
                dbias[:, :, tr, cs] = ds
            acc = acc + mm(ds, kp[:, :, cs])
        dq[:, :, tr] = acc * scale
    dk, dv = torch.zeros(kp.shape), torch.zeros(vp.shape)
    for k0 in range(0, Sp, TILE):  # dK / dV: a key tile
        kr = slice(k0, k0 + TILE)
        keys = torch.arange(k0, k0 + TILE)
        acc_k = acc_v = 0
        for c in range(k0 // CHUNK if causal else 0, Lp // CHUNK):
            qs = slice(c * CHUNK, (c + 1) * CHUNK)
            queries = torch.arange(c * CHUNK, (c + 1) * CHUNK)
            st = _reduced(kp[:, :, kr], qp[:, :, qs], owned, mm) * scale
            if bp is not None:
                st = st + bp[:, :, qs, kr].transpose(-1, -2)
            if causal:
                st = st.masked_fill(keys[:, None] > queries[None, :], NEG_INF)
            dpt = _reduced(vp[:, :, kr], dop[:, :, qs], owned, mm)
            pt = torch.exp(st - mp[:, :, None, qs]) / lp[:, :, None, qs]
            ft = f[:, :, qs, kr].transpose(-1, -2)
            live = (queries < Lq)[None, :]
            pm = torch.where(live, pt * ft, 0.0)
            dst = torch.where(live, pt * (dpt * ft - dsum[:, :, None, qs]),
                              0.0)
            acc_v = acc_v + mm(pm, dop[:, :, qs])
            acc_k = acc_k + mm(dst, qp[:, :, qs])
        dk[:, :, kr], dv[:, :, kr] = acc_k * scale, acc_v
    return (dq[:, :, :Lq, :D], dk[:, :, :S, :D], dv[:, :, :S, :D],
            None if dbias is None else dbias[:, :, :Lq, :S])


def _plan(D, S, tiles):
    return kernels.wide_plan(D, S, "mirror", tiles, SMS, f32=True)


def _mirror_dropout(q, k, v, b, do, causal, plan, mm=mm3):
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    tb = None if b is None else torch.tensor(b)
    kw = dict(bias=tb, causal=causal, rate=RATE, seed=SEED, mm=mm)
    out, m, l = mirror_forward(tq, tk, tv, plan, **kw)
    grads = mirror_backward(tq, tk, tv, out, tdo, m, l, plan, **kw)
    return [out.numpy()] + [g.numpy() for g in grads if g is not None]


MODES = {"bias": (False, True), "causal": (True, False),
         "causal+bias": (True, True)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("D", [264, 1024])
def test_f32_wide_dropout_mirror_matches_pallas(D, mode):
    """Row 11 in f32 above head size 256: the forward, dq, dk, dv and dbias
    of the split-TF32 cluster mirror against the Pallas kernel's, dropout
    rate 0.1, B=1, H=2, L=S=70, under the wrappers' plan (head size 264: a
    cluster of 5 blocks of one slice; 1024: 8 blocks of two) and the same
    plan in two passes."""
    causal, use_bias = MODES[mode]
    q, k, v, b, do = _inputs(D + len(mode), 1, 2, L, D, use_bias)
    want = _pallas_dropout(q, k, v, b, do, causal)
    plan = _plan(D, L, 2 * -(-L // TILE))
    assert plan.passes == 1
    for p in (plan, plan._replace(passes=2)):
        got = _mirror_dropout(q, k, v, b, do, causal, p)
        for name, g, w in zip(NAMES, got, want):
            np.testing.assert_allclose(g, w, err_msg=f"{name} {tuple(p)}",
                                       **F32)


def test_f32_wide_halved_cluster_matches_pallas():
    """Head size 512 under the halved cluster of row 11's B=16 grid (4
    blocks of two slices, as the train_amt CLI at -num_heads 1 runs it)
    and under the B=1 cluster of 8 blocks: the mirror's forward and
    gradients against the Pallas kernel's, causal with a bias."""
    q, k, v, b, do = _inputs(512, 1, 2, L, 512, True)
    want = _pallas_dropout(q, k, v, b, do, True)
    plans = (_plan(512, L, 80), _plan(512, L, 1))  # 80: B=16, L=300
    assert [(p.cluster, p.slices) for p in plans] == [(4, 2), (8, 1)]
    for p in plans:
        got = _mirror_dropout(q, k, v, b, do, True, p)
        for name, g, w in zip(NAMES, got, want):
            np.testing.assert_allclose(g, w, err_msg=f"{name} {tuple(p)}",
                                       **F32)


@pytest.mark.parametrize("mode", ["shared", "causal", "scale"])
@pytest.mark.parametrize("D", [264, 1024])
def test_f32_wide_flash_mirror_matches_pallas(D, mode):
    """Row 1 in f32 above head size 256 (no dropout, no stats): a bias
    shared by every batch row ((1, H, L, S), read in place), the causal
    mask, and a scale other than D**-0.5 (the Pallas kernel takes none:
    its q is scaled to match), B=2, H=2, L=S=70."""
    B, H = 2, 2
    q, k, v, _, _ = _inputs(D + 7 * len(mode), B, H, L, D, False)
    b = np.random.default_rng(D).standard_normal(
        (1, H, L, L)).astype(np.float32) if mode == "shared" else None
    scale = 64 ** -0.5 if mode == "scale" else None
    jq = q if scale is None else q * np.float32(scale / D ** -0.5)
    want = jax_flash(*(jnp.asarray(a) for a in (jq, k, v)),
                     bias=None if b is None else jnp.asarray(
                         np.broadcast_to(b, (B, H, L, L))),
                     causal=mode == "causal", interpret=True)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = mirror_forward(tq, tk, tv, _plan(D, L, B * H * 2),
                         bias=None if b is None else torch.tensor(b),
                         causal=mode == "causal", scale=scale)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_f32_wide_single_tf32_leaves_the_f32_bound():
    """At head size 512, L=S=70, single TF32 products keep ~3 digits: the
    cluster mirror with them leaves the f32 bound the split-TF32 mirror
    keeps, in the forward and in every gradient, while staying within a
    few 1e-3 of the largest magnitude. So the wide kernels need the three
    products too."""
    q, k, v, b, do = _inputs(513, 1, 2, L, 512, False)
    want = _pallas_dropout(q, k, v, b, do, False)
    got = _mirror_dropout(q, k, v, b, do, False, _plan(512, L, 2), mm=mm1)
    for name, g, w in zip(NAMES, got, want):
        assert not np.allclose(g, w, **F32), name
        assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), name


def test_split_tf32_helpers_are_the_narrow_tests():
    """The mirror's emulation is the narrow f32 tests' own: rna rounds to
    TF32 and split gives parts that are TF32 and sum to ~22 bits."""
    y = torch.tensor(np.random.default_rng(2).standard_normal(256)
                     .astype(np.float32))
    big, small = split(y)
    assert torch.equal(rna(big), big) and torch.equal(rna(small), small)
    assert ((big + small - y).abs() <= y.abs() * 2.0 ** -21).all()
