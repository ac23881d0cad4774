"""The decode kernels (rows 2-10) at every head size the JAX sampler fuses,
held to the JAX package on the CPU.

* The shape predicate: every config that the JAX sampler's fused
  predicates take (``fused_decode_eligible`` and ``fused_decode_mosaic_ok``,
  or the variant pair) over a grid of widths, head counts, wirings, batch
  sizes and int8 modes is taken by the port's ``cuda_decode_shapes_ok``
  and routed to a kernel backend, with no warning under ``fused="auto"``.
* The attention of any even head size (csrc/batch_decode.cuh
  attn_any_kernel: one block per (value head, clip); P.V of each value
  pair by row groups summed in group order: 256 / (hd / 2) groups below
  256 pairs a head, 8 from 256 up) and the cooperative kernel's instance of any
  head size (csrc/decode_stack.cu attend_split_any: splits of rows, tiles
  online with exp(m_old - m_new) rescaling, the splits merged): plain
  mirrors of those orders in place of the plain layers' attention, against
  the Pallas kernels in interpret mode at head sizes 4 and 512, B=1 (rows
  2, 8 and the cooperative kernel's layer) and B=3 (rows 6 and 9; row 6
  on int8 caches too), f32 and bf16.
generate_chords at these head sizes token for token against the JAX
sampler: tests/test_torch_decode_wide_heads_generate.py (a file of its
own, to keep each file's run short).
"""

import functools
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video2music_tpu.core.config import amt_config as jax_amt_config
from video2music_tpu.ops import pallas_decode as jpd
from video2music_tpu.ops import pallas_decode_batch as jpb
from video2music_tpu.ops import pallas_decode_variant as jpv
from video2music_tpu.ops.pallas_decode_batch_variant import (
    batched_variant_layer_step as jax_variant_b)
from video2music_tpu_torch.core.config import amt_config
from video2music_tpu_torch.decode import sampler
from video2music_tpu_torch.decode.sampler import fused_backend
from video2music_tpu_torch.ops import decode_batch as db
from video2music_tpu_torch.ops import decode_batch_variant as dbv
from video2music_tpu_torch.ops import decode_layer as dl
from video2music_tpu_torch.ops import decode_variant as dv
from video2music_tpu_torch.ops.decode_layer import cuda_decode_shapes_ok
from video2music_tpu_torch.ops.embeddings import rope_table

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5  # the JAX decode kernel tests' tolerance
BF16_REL = 2e-2          # bf16: relative to the largest magnitude
SUBLN_EPS = 1e-5
THREADS = 256            # csrc/batch_decode.cuh kThreads, decode_stack NT
ANY_GROUPS = 8           # csrc/batch_decode.cuh kAnyGroups
S = 12                   # cache rows of the single-layer steps
F, E, K_TOP = 32, 6, 2
B = 3


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _close_bf16(got, want, msg=""):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got - want).max()
    assert err <= BF16_REL * np.abs(want).max(), f"{msg}: max abs {err}"


def _check(got, want, dtype, msg):
    (_close if dtype == "float32" else _close_bf16)(got, want, msg)


# ---------------------------------------------------------------------------
# the predicate over the JAX sampler's fused configs
# ---------------------------------------------------------------------------

VERSIONS = (None, "1.0", "1.1", "1.2", "1.3", "1.3.1", "1.3.2", "1.3.3",
            "1.3.4", "2.0", "2.1", "2.2", "2.3", "3.0", "3.1", "3.2")


def _jax_fuses(cfg) -> bool:
    """The JAX sampler runs its Pallas decode kernels on a TPU for cfg."""
    return ((jpd.fused_decode_eligible(cfg)
             and jpd.fused_decode_mosaic_ok(cfg))
            or (jpv.fused_variant_eligible(cfg)
                and jpv.fused_variant_mosaic_ok(cfg)))


@pytest.mark.parametrize("d_model", [128, 384, 512, 1024])
def test_jax_fused_configs_take_the_kernels(d_model):
    """For every head count dividing d_model, d_ff 64 and 1024, every
    wiring amt_config builds, B 1 and 16, quantize None / "int8" and
    kv_quant None / "int8": where the JAX sampler fuses on a TPU, the
    port's predicate takes the config and fused_backend routes it to a
    kernel backend (int8 weights at B>1 excepted: the plain step on
    fake-quantized weights there, as in the JAX sampler), warning-free
    under "auto". Odd head sizes are never fused (the wirings'
    eligibility), as in the JAX package."""
    fused = 0
    for H in [h for h in range(1, d_model + 1) if d_model % h == 0]:
        for d_ff in (64, 1024):
            for version in VERSIONS:
                kw = dict(n_layers=2, num_heads=H, d_model=d_model,
                          d_ff=d_ff)
                jcfg = jax_amt_config(version, **kw)
                cfg = amt_config(version, **kw)
                assert dl.fused_decode_eligible(cfg) == \
                    jpd.fused_decode_eligible(jcfg), (version, H)
                assert dv.fused_variant_eligible(cfg) == \
                    jpv.fused_variant_eligible(jcfg), (version, H)
                if not _jax_fuses(jcfg):
                    continue
                assert (d_model // H) % 2 == 0
                fused += 1
                for Bn in (1, 16):
                    for quantize in (None, "int8"):
                        ok = cuda_decode_shapes_ok(cfg, Bn, quantize)
                        assert ok, (version, H, d_ff, Bn, quantize)
                        for kv in (None, "int8"):
                            if quantize and kv:
                                continue
                            with warnings.catch_warnings():
                                warnings.simplefilter("error")
                                init, _ = fused_backend(
                                    cfg, Bn, "auto", quantize, kv_quant=kv
                                    if dl.fused_decode_eligible(cfg)
                                    else None)
                            plain = init is sampler._init_plain_caches
                            assert plain == (quantize is not None
                                             and Bn > 1), (version, H, Bn)
    assert fused > 0


# ---------------------------------------------------------------------------
# mirrors of the new sum orders
# ---------------------------------------------------------------------------

def cluster_of(rows: int, pairs: int) -> int:
    """csrc/batch_decode.cuh attn_cluster: blocks per (value head, clip)."""
    cs = 1
    while cs < 8 and pairs * cs < 132 and rows >= 64 * cs:
        cs *= 2
    return cs


def any_attend(q, k, v, n_heads, *, lam=None, subw=None, er=None, pos=0,
               cur=None, batched=False, k_scale=None, v_scale=None,
               k_cur=None, v_cur=None, dt=None, cs=None):
    """attn_any_kernel's arithmetic: q (B, nq D) f32 over the rows of k
    (B, R, nq D) / v (B, R, D) -> (B, D) f32. The rows split into cs
    contiguous chunks (cluster_of unless given), one a cluster block: the
    logits, the max over all rows, the exponentials, their sum (the
    chunks' sums added in rank order) and the normalised (batched:
    rounded, row `cur` kept f32) probabilities; a chunk's P.V by row
    groups, summed in group order:
    the chunk's row r0 + i in group i mod THREADS // (hd / 2) below
    THREADS value pairs a head, i mod ANY_GROUPS from THREADS pairs up;
    the chunks' partials added in rank order. int8 caches (k_scale /
    v_scale (B, R, 1)): the scales fold into the logits and
    probabilities, the current row (the last) from k_cur / v_cur."""
    Bq, R, Dk = k.shape
    D = v.shape[-1]
    H, hd = n_heads, D // n_heads
    nq = Dk // D
    dt = dt if dt is not None else k.dtype
    quant = k_scale is not None
    if quant:
        k = torch.cat([k.float(), k_cur.view(Bq, 1, D)], dim=1)
        v = torch.cat([v.float(), v_cur.view(Bq, 1, D)], dim=1)
        R, cur = R + 1, R
    cs = cs or cluster_of(R, H * Bq)
    per = math.ceil(R / cs)
    chunks = [(min(R, r * per), min(R, r * per + per)) for r in range(cs)]

    def rnd(t):
        return t.to(dt).float() if batched else t

    logits = torch.einsum("bhd,bshd->bhs", q.view(Bq, nq * H, hd).float(),
                          k.float().view(Bq, R, nq * H, hd))
    if er is not None:
        rows = er.shape[0] - 1 - pos + torch.arange(R)
        rel = rnd(er[rows].float()).view(R, H, hd)
        bias = torch.einsum("bhd,shd->bhs", q.view(Bq, H, hd).float(), rel)
        keep = bias.clone()
        bias = rnd(bias)
        if cur is not None:
            bias[..., cur] = keep[..., cur]
        logits = logits + bias
    logits = logits * hd ** -0.5
    cached = torch.ones(R, dtype=torch.bool)
    if cur is not None:
        cached[cur] = False
    if quant:
        ks = torch.cat([k_scale.view(Bq, R - 1), torch.ones(Bq, 1)], dim=1)
        logits = torch.where(cached, logits * ks[:, None, :], logits)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    total = torch.zeros(e.shape[:2])
    for a, b in chunks:  # the blocks' sums in rank order
        total = total + e[..., a:b].sum(-1)
    w = e * (1.0 / total)[..., None]
    if quant:
        vs = torch.cat([v_scale.view(Bq, R - 1), torch.ones(Bq, 1)], dim=1)
        w = torch.where(cached, w * vs[:, None, :], w)
    if batched:
        w = torch.where(cached, w.to(dt).float(), w)
    vv = v.float().view(Bq, R, H, hd)
    if nq == 2:
        vv = vv.repeat_interleave(2, dim=2)
    pairs = hd // 2
    groups = THREADS // pairs if pairs < THREADS else ANY_GROUPS
    pv = torch.zeros(Bq, nq * H, hd)
    for a, b in chunks:  # the leader adds the blocks' partials in order
        mine = torch.zeros(Bq, nq * H, hd)
        for g in range(min(groups, b - a)):  # empty groups add zeros
            mine = mine + torch.einsum("bhs,bshd->bhd", w[..., a + g:b:groups],
                                       vv[:, a + g:b:groups])
        pv = pv + mine
    if lam is None:
        return rnd(pv).reshape(Bq, D)
    c = rnd(rnd(pv[:, 0::2]) - lam.float() * rnd(pv[:, 1::2]))
    c = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + SUBLN_EPS)
    return (c * subw.float().view(H, hd)).reshape(Bq, D)


def split_attend(q, k, v, n_heads, *, splits=2, tile=4):
    """attend_split_any's arithmetic at B=1 (the cooperative kernel's
    instance of any head size; vanilla, f32 throughout): the R rows in
    `splits` contiguous splits of ceil(R / splits); each split's tiles of
    `tile` rows (the kernel's are 64) online: the running max, the sum
    and P.V rescaled by exp(m_old - m_new), each tile's P.V formed as
    any_attend forms it; the splits' triples merged as stage_merged does
    (weights exp(m_s - M), the sums and P.V added in split order, P.V
    divided by the sum)."""
    _, R, D = k.shape
    H, hd = n_heads, D // n_heads
    logits = torch.einsum("hd,shd->hs", q[0].view(H, hd).float(),
                          k[0].float().view(R, H, hd)) * hd ** -0.5
    vv = v[0].float().view(R, H, hd)
    pairs = hd // 2
    per = math.ceil(R / splits)
    trips = []
    for r0 in range(0, R, per):
        r1 = min(R, r0 + per)
        m = torch.full((H,), -math.inf)
        l_ = torch.zeros(H)
        o = torch.zeros(H, hd)
        for t0 in range(r0, r1, tile):
            t1 = min(r1, t0 + tile)
            lt = logits[:, t0:t1]
            m_new = torch.maximum(m, lt.amax(-1))
            p = torch.exp(lt - m_new[:, None])
            corr = torch.exp(m - m_new)
            l_ = l_ * corr + p.sum(-1)
            vt = vv[t0:t1]
            t = torch.zeros(H, hd)
            if pairs < THREADS:
                groups = THREADS // pairs
                for g in range(min(groups, t1 - t0)):
                    t = t + torch.einsum("hs,shd->hd", p[:, g::groups],
                                         vt[g::groups])
            else:
                for s in range(t1 - t0):
                    t = t + p[:, s, None] * vt[s]
            o = o * corr[:, None] + t
            m = m_new
        trips.append((o, m, l_))
    M = torch.stack([t[1] for t in trips]).amax(0)
    acc = torch.zeros(H, hd)
    L_ = torch.zeros(H)
    for o, m, l_ in trips:
        wgt = torch.exp(m - M)
        L_ = L_ + wgt * l_
        acc = acc + wgt[:, None] * o
    return (acc / L_[:, None]).reshape(1, D)


_T = ("wqkv", "wo", "cwq", "cwo", "fw1g", "fw2", "sw1g", "sw2", "gate_w")
_EXPERT = ("ew1g", "ew2")
_ROW = ("bqkv", "bo", "cbq", "cbo", "fb1g", "fb2", "sb1g", "sb2", "gate_b",
        "lam", "clam", "subw", "csubw")
_F32 = ("lam", "clam", "subw", "csubw", "er")


def _shapes(D, nq=1, nc=1):
    """The JAX packed deep layer's arrays (pallas_decode / the variant
    pack): (D, (2 nq + 1) D) QKV, SharedMoE of E GLU experts of width F."""
    return dict(wqkv=(D, (2 * nq + 1) * D), bqkv=(1, (2 * nq + 1) * D),
                wo=(D, D), bo=(1, D), cwq=(D, nc * D), cbq=(1, nc * D),
                cwo=(D, D), cbo=(1, D), norm_scale=(3, D), norm_bias=(3, D),
                gate_w=(D, E), gate_b=(1, E), ew1g=(E, D, 2 * F),
                eb1g=(E, 2 * F), ew2=(E, F, D), eb2=(E, D), sw1g=(D, 2 * F),
                sb1g=(1, 2 * F), sw2=(F, D), sb2=(1, D))


def _random_pack(seed, D, dtype, variant):
    """(JAX packed deep layer, the port's): random weights scaled by
    1 / sqrt(fan-in), exact in ``dtype``; the variant layer is V3.1's
    (differential self and cross attention, RMSNorm, SharedMoE)."""
    r = np.random.default_rng(seed)
    nq = 2 if variant else 1
    jl = {}
    for key, shape in _shapes(D, nq, nq).items():
        fan = shape[-2] if len(shape) > 1 and shape[0] != 1 else D
        a = r.standard_normal(shape).astype(np.float32) * fan ** -0.5
        if key == "norm_scale":
            a = 1.0 + 0.1 * r.standard_normal(shape).astype(np.float32)
        elif key.startswith(("b", "cb", "sb", "eb", "gate_b", "norm_b")):
            a = 0.1 * r.standard_normal(shape).astype(np.float32)
        jl[key] = np.asarray(jnp.asarray(jnp.asarray(a, dtype), jnp.float32))
    if variant:
        for pre in ("", "c"):
            jl[pre + "lam"] = np.full((1, 1), 0.3 + 0.1 * r.random(),
                                      np.float32)
            jl[pre + "subw"] = (0.8 + 0.1 * r.random((1, D))).astype(
                np.float32)
    tdt = getattr(torch, dtype)
    if variant:
        port = {}
        for key, a in jl.items():
            if key in _T:
                a = a.T
            elif key in _EXPERT:
                a = a.transpose(0, 2, 1)
            elif key in _ROW:
                a = a.reshape(-1)
            t = torch.from_numpy(np.ascontiguousarray(a))
            port[key] = t if key in _F32 else t.to(tdt)
    else:
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
        port = dict(
            wqkv=t(jl["wqkv"].T), bqkv=t(jl["bqkv"][0]), wo=t(jl["wo"].T),
            bo=t(jl["bo"][0]), cwq=t(jl["cwq"].T), cbq=t(jl["cbq"][0]),
            cwo=t(jl["cwo"].T), cbo=t(jl["cbo"][0]),
            norm_scale=t(jl["norm_scale"]), norm_bias=t(jl["norm_bias"]),
            w1g=t(jl["sw1g"].T), b1g=t(jl["sb1g"][0]), w2=t(jl["sw2"].T),
            b2=t(jl["sb2"][0]), gate_w=t(jl["gate_w"].T),
            gate_b=t(jl["gate_b"][0]),
            ew1g=t(jl["ew1g"].transpose(0, 2, 1)), eb1g=t(jl["eb1g"]),
            ew2=t(jl["ew2"].transpose(0, 2, 1)), eb2=t(jl["eb2"]))
    jl = {k: jnp.asarray(a, dtype if k not in _F32 else jnp.float32)
          if not variant else jnp.asarray(a) for k, a in jl.items()}
    return jl, port


def _rope(D, H):
    t = rope_table(S, D // H, "cpu")
    return t[..., 0].contiguous(), t[..., 1].contiguous()


META31 = ("differential", "differential", "moe", "glu", True)
# head size -> (d_model, heads)
HEADS = {4: (16, 4), 512: (512, 1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", sorted(HEADS))
@pytest.mark.parametrize("row", ["2", "6", "8", "9"])
def test_any_head_attention_layer_matches_pallas(row, hd, dtype,
                                                 monkeypatch):
    """One deep layer step with any_attend in place of the plain layer's
    attention against the Pallas kernel in interpret mode: row 2 (the 2.2
    layer, B=1), row 6 (the batched 2.2 attention half, B=3), row 8 (the
    3.1 layer, B=1) and row 9 (its batched attention half, B=3), at pos 7
    of 12 cache rows over 12 memory rows; the K row written at pos too.
    At B=1 the mirror splits the rows over a cluster of 3 blocks."""
    D, H = HEADS[hd]
    variant = row in ("8", "9")
    batched = row in ("6", "9")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jl, pl_ = _random_pack(int(row) * 10 + hd, D, dtype, variant)
    nq = 2 if variant else 1
    r = np.random.default_rng(hd + int(row))
    lead = (B,) if batched else ()
    n = lambda *shape: r.standard_normal(lead + shape).astype(np.float32)
    x = n(D) if batched else n(1, D)
    kc, vc, kx, vx = n(S, nq * D), n(S, D), n(S, nq * D), n(S, D)
    pos = 7
    rope = _rope(D, H)
    # B=1: the rows over 3 cluster blocks (the kernel's order at 300 rows
    # takes 8), B=3: one block a (head, clip), as the kernel at 12 rows
    mirror = any_attend if batched else functools.partial(any_attend, cs=3)
    for mod in (dl, db, dv):
        monkeypatch.setattr(mod, "attend", mirror)
    t = lambda a: torch.from_numpy(a.copy()).to(tdt)
    j = lambda a: jnp.asarray(a, jdt)
    if row == "2":
        want, jk, _ = jpd.decode_layer_step(
            j(x), pos, jl, j(kc), j(vc), j(kx), j(vx), n_heads=H, rope=True,
            k_top=K_TOP, interpret=True)
        pk = t(kc)
        got = dl.decode_layer_step(t(x), pos, pl_, pk, t(vc), t(kx), t(vx),
                                   n_heads=H, k_top=K_TOP, rope=rope)
        k_row, jk_row = pk[pos], jk[pos]
    elif row == "6":
        want, jk, _ = jpb.batched_layer_step(
            j(x), pos, jl, j(kc), j(vc), j(kx), j(vx), n_heads=H, rope=True,
            block_b=B, interpret=True)
        pk = t(kc)
        got = db.batched_layer_step(t(x), pos, pl_, pk, t(vc), t(kx), t(vx),
                                    n_heads=H, rope=rope)
        k_row, jk_row = pk[:, pos], jk
    else:
        meta = dv.VariantLayerMeta(*META31)
        jmeta = jpv.VariantLayerMeta(*META31)
        jl = {k: a if k in _F32 else jnp.asarray(a, jnp.float32)
              for k, a in jl.items()}
        kw = dict(norm="rmsnorm", pre_norm=False)
        if row == "8":
            want, jk, _ = jpv.decode_variant_layer_step(
                j(x), pos, jl, jmeta, j(kc), j(vc), j(kx), j(vx), n_heads=H,
                k_top=K_TOP, rope=True, interpret=True, **kw)
            pk = t(kc)
            got = dv.decode_variant_layer_step(
                t(x), pos, pl_, meta, pk, t(vc), t(kx), t(vx), n_heads=H,
                k_top=K_TOP, rope=rope, **kw)
            k_row, jk_row = pk[pos], jk[pos]
        else:
            want, jk, _ = jax_variant_b(
                j(x), pos, jl, jmeta, j(kc), j(vc), j(kx), j(vx), n_heads=H,
                rope=True, interpret=True, **kw)
            pk = t(kc)
            got = dbv.batched_variant_layer_step(
                t(x), pos, pl_, meta, pk, t(vc), t(kx), t(vx), n_heads=H,
                rope=rope, **kw)
            k_row, jk_row = pk[:, pos], jk
    msg = f"row {row} hd {hd} {dtype}"
    _check(got, want, dtype, msg)
    _check(k_row, jk_row, dtype, msg + " k row")


@pytest.mark.parametrize("hd", sorted(HEADS))
def test_any_head_int8_kv_layer_matches_pallas(hd, monkeypatch):
    """Row 6 on int8 caches (f32 weights): the batched 2.2 attention half
    at B=3 with any_attend's int8 form in place of attend_int8's
    self-attention, against the Pallas batched_layer_step with kv_scales."""
    D, H = HEADS[hd]
    jl, pl_ = _random_pack(60 + hd, D, "float32", False)
    r = np.random.default_rng(hd)
    qz = lambda: jpb.quantize_kv_rows(jnp.asarray(
        r.standard_normal((B, S, D)).astype(np.float32)))
    (kc, ks), (vc, vs), (kx, kxs), (vx, vxs) = qz(), qz(), qz(), qz()
    x = r.standard_normal((B, D)).astype(np.float32)
    pos = 7
    monkeypatch.setattr(db, "attend_int8", functools.partial(
        _int8_mirror, db.attend_int8))
    want, jk, _, jks, _ = jpb.batched_layer_step(
        jnp.asarray(x), pos, jl, kc, vc, kx, vx, n_heads=H, rope=True,
        block_b=B, interpret=True, kv_scales=(ks, vs, kxs, vxs))
    np_ = lambda a: torch.from_numpy(np.array(a))
    pk, pks = np_(kc), np_(ks)
    got = db.batched_layer_step(
        torch.from_numpy(x), pos, pl_, pk, np_(vc), np_(kx), np_(vx),
        n_heads=H, rope=_rope(D, H),
        kv_scales=(pks, np_(vs), np_(kxs), np_(vxs)))
    _close(got, want, f"int8 KV hd {hd}")
    np.testing.assert_array_equal(pk[:, pos].float().numpy(),
                                  np.asarray(jk))
    _close(pks[:, pos], jks, f"int8 KV hd {hd} k scale")


def _int8_mirror(plain, q, k, v, k_scale, v_scale, n_heads, dt, k_cur=None,
                 v_cur=None):
    """attend_int8 with the self-attention (the one with a current row)
    through any_attend's int8 form."""
    if k_cur is None:
        return plain(q, k, v, k_scale, v_scale, n_heads, dt)
    return any_attend(q, k, v, n_heads, batched=True, k_scale=k_scale,
                      v_scale=v_scale, k_cur=k_cur, v_cur=v_cur, dt=dt)


@pytest.mark.parametrize("hd", sorted(HEADS))
def test_split_attention_layer_matches_pallas(hd, monkeypatch):
    """The cooperative kernel's instance of any head size, per layer: the
    2.2 deep layer at B=1 with split_attend (2 splits of 4-row tiles over
    the 12 self rows at pos 11 and the 12 memory rows) in place of the
    plain attention, against the Pallas decode_layer_step (the layer the
    cooperative kernel's three TPU counterparts run), f32."""
    D, H = HEADS[hd]
    jl, pl_ = _random_pack(80 + hd, D, "float32", False)
    r = np.random.default_rng(90 + hd)
    x = r.standard_normal((1, D)).astype(np.float32)
    kc, vc, kx, vx = (r.standard_normal((S, D)).astype(np.float32)
                      for _ in range(4))
    pos = S - 1
    monkeypatch.setattr(dl, "attend", split_attend)
    want, jk, _ = jpd.decode_layer_step(
        jnp.asarray(x), pos, jl, *(jnp.asarray(a) for a in (kc, vc, kx, vx)),
        n_heads=H, rope=True, k_top=K_TOP, interpret=True)
    pk = torch.from_numpy(kc.copy())
    got = dl.decode_layer_step(torch.from_numpy(x), pos, pl_, pk,
                               torch.from_numpy(vc.copy()),
                               torch.from_numpy(kx), torch.from_numpy(vx),
                               n_heads=H, k_top=K_TOP, rope=_rope(D, H))
    _close(got, want, f"split attention hd {hd}")
    _close(pk[pos], jk[pos], f"split attention hd {hd} k row")


def test_mirrors_are_the_plain_attention():
    """The mirrors' orders change only the order of the sums: at head
    sizes 2, 4, 12, 512 and 1024, 37 rows (RPR, differential, batched
    rounding off), f32."""
    g = torch.Generator().manual_seed(0)
    R = 37
    for H, hd in ((8, 2), (4, 4), (3, 12), (1, 512), (1, 1024)):
        D = H * hd
        for nq, er in ((1, None), (1, torch.randn(S + R, D, generator=g)),
                       (2, None)):
            q = torch.randn(1, nq * D, generator=g)
            k = torch.randn(1, R, nq * D, generator=g)
            v = torch.randn(1, R, D, generator=g)
            kw = dict(er=er, pos=R - 1, cur=R - 1)
            if nq == 2:
                kw.update(lam=torch.tensor([0.3]), subw=torch.rand(D))
            want = dl.attend(q, k, v, H, **kw)
            for cs in (1, 3, 8):
                np.testing.assert_allclose(
                    any_attend(q, k, v, H, cs=cs, **kw).numpy(),
                    want.numpy(), rtol=1e-5, atol=1e-6,
                    err_msg=f"hd {hd} nq {nq} cs {cs}")
            if nq == 1 and er is None:
                for splits, tile in ((1, 64), (3, 4), (5, 2)):
                    np.testing.assert_allclose(
                        split_attend(q, k, v, H, splits=splits,
                                     tile=tile).numpy(), want.numpy(),
                        rtol=1e-5, atol=1e-6, err_msg=f"split hd {hd}")
