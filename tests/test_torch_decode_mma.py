"""The algorithms of the redesigned batched / variant decode blocks
(video2music_tpu_torch/csrc/batch_decode.cuh) as plain torch mirrors, held
to the JAX package on the CPU, and the plain versions of rows 6-10 at
d_ff 2048.

* The cluster-split attention: each of `cs` blocks takes a contiguous chunk
  of the rows, its logits and local max; the maxima and then the sums are
  exchanged; each block normalises and rounds its probabilities where the
  Pallas kernel does (batched: the cache rows' to the compute dtype, row
  `cur` in f32) and forms its partial P.V; the first block sums the
  partials in rank order and finishes. The mirror stands in for the plain
  attention inside the port's plain layers, which are held to the Pallas
  kernels in interpret mode: B=1 (vanilla, RPR, differential; f32 and
  bf16) and B=3 batched, int8 caches and row `cur` included. At one block
  a (head, clip) it is the arithmetic of the one-block kernel that vanilla
  and RPR heads run at B >= 2.
* The tensor-core GEMV: 64-wide k chunks dealt to 8 warps, 16-wide k steps
  accumulated in f32, the warps' partials summed in warp order, against
  the plain `_dot`; and the C-fragment lane map its RoPE epilogue relies
  on.
* The plain versions of rows 6-10 at d_ff 2048 (D 128, 2 heads) against
  the Pallas kernels in interpret mode: the port's kernels carry no width
  limit, as the JAX kernels carry none.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video2music_tpu.core.config import amt_config
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops import pallas_decode as jpd
from video2music_tpu.ops import pallas_decode_batch as jpb
from video2music_tpu.ops.pallas_decode_batch_variant import (
    batched_variant_layer_step as jax_variant_b,
    batched_variant_moe_ffn as jax_variant_moe_b)
from video2music_tpu.ops.pallas_decode_variant import (
    decode_variant_layer_step as jax_variant, pack_variant_layers as jax_pack)
from video2music_tpu_torch.core.config import amt_config as port_amt_config
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops import decode_batch as db
from video2music_tpu_torch.ops import decode_batch_variant as dbv
from video2music_tpu_torch.ops import decode_layer as dl
from video2music_tpu_torch.ops import decode_variant as dv
from video2music_tpu_torch.ops.embeddings import rope_table
from video2music_tpu_torch.weights import amt_from_jax

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5  # the JAX decode kernel tests' tolerance
BF16_REL = 2e-2          # bf16: relative to the largest magnitude
S = 12                   # cache rows of the tiny models
B = 3
SUBLN_EPS = 1e-5


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _close_bf16(got, want, msg=""):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got - want).max()
    assert err <= BF16_REL * np.abs(want).max(), f"{msg}: max abs {err}"


# ---------------------------------------------------------------------------
# mirrors of the device algorithms
# ---------------------------------------------------------------------------

def cluster_of(rows: int, pairs: int) -> int:
    """batch_decode.cuh attn_cluster: blocks per (value head, clip)."""
    cs = 1
    while cs < 8 and pairs * cs < 132 and rows >= 64 * cs:
        cs *= 2
    return cs


def runs_cluster(rows: int, pairs: int, diff: bool) -> bool:
    """batch_decode.cuh attention(): the cluster kernel for a differential
    pair and from kMinCluster (4) blocks a (value head, clip), the one-block
    kernel otherwise."""
    return diff or cluster_of(rows, pairs) >= 4


def cluster_attend(q, k, v, n_heads, *, lam=None, subw=None, er=None,
                   pos=0, cur=None, batched=False, cs=None, k_scale=None,
                   v_scale=None, k_cur=None, v_cur=None, dt=None):
    """attn_kernel's arithmetic in torch: q (B, nq D) f32 over the rows of
    k (B, R, nq D) / v (B, R, D) -> (B, D) f32. int8 caches (k_scale /
    v_scale (B, R, 1)): the rows' scales fold into the logits and
    probabilities, and row `cur` (the last) comes from k_cur / v_cur."""
    Bq, R, Dk = k.shape
    D = v.shape[-1]
    H, hd = n_heads, D // n_heads
    nq = Dk // D
    dt = dt if dt is not None else k.dtype
    quant = k_scale is not None
    if quant:  # append the current row: k_cur / v_cur, no scale
        k = torch.cat([k.float(), k_cur.view(Bq, 1, D)], dim=1)
        v = torch.cat([v.float(), v_cur.view(Bq, 1, D)], dim=1)
        R, cur = R + 1, R
    cs = cs or cluster_of(R, H * Bq)
    per = math.ceil(R / cs)

    def rnd(t):
        return t.to(dt).float() if batched else t

    qh = q.view(Bq, nq * H, hd).float()
    logits = torch.einsum("bhd,bshd->bhs", qh,
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
    chunks = [(min(R, r * per), min(R, r * per + per)) for r in range(cs)]
    # the cluster's max, then its sum (block sums added in rank order)
    m = torch.stack([logits[..., a:b].amax(-1) if b > a else
                     torch.full(logits.shape[:2], -math.inf)
                     for a, b in chunks]).amax(0)
    e = torch.exp(logits - m[..., None])
    total = torch.zeros_like(m)
    for a, b in chunks:
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
    pv = torch.zeros(Bq, nq * H, hd)
    for a, b in chunks:  # the leader sums the blocks' partials in rank order
        pv = pv + torch.einsum("bhs,bshd->bhd", w[..., a:b], vv[:, a:b])
    if lam is None:
        return rnd(pv).reshape(Bq, D)
    c = rnd(rnd(pv[:, 0::2]) - lam.float() * rnd(pv[:, 1::2]))
    c = c * torch.rsqrt(c.square().mean(-1, keepdim=True) + SUBLN_EPS)
    return (c * subw.float().view(H, hd)).reshape(Bq, D)


def cluster_attend_int8(q, k, v, k_scale, v_scale, n_heads, dt, k_cur=None,
                        v_cur=None, cs=None):
    """decode_batch.attend_int8's signature: self-attention (with the
    current row) through cluster_attend, cross-attention through
    _cross_int8."""
    if k_cur is None:
        return _cross_int8(q, k, v, k_scale, v_scale, n_heads, dt, cs)
    return cluster_attend(q, k, v, n_heads, batched=True, cs=cs,
                          k_scale=k_scale, v_scale=v_scale, k_cur=k_cur,
                          v_cur=v_cur, dt=dt)


def _cross_int8(q, k, v, k_scale, v_scale, n_heads, dt, cs):
    """int8 cross-attention (no current row): the scales fold as above."""
    Bq, R, D = k.shape
    hd = D // n_heads
    cs = cs or cluster_of(R, n_heads * Bq)
    per = math.ceil(R / cs)
    logits = torch.einsum("bhd,bshd->bhs", q.view(Bq, n_heads, hd),
                          k.float().view(Bq, R, n_heads, hd)) * hd ** -0.5 \
        * k_scale.view(Bq, 1, R)
    chunks = [(min(R, r * per), min(R, r * per + per)) for r in range(cs)]
    m = logits.amax(-1)
    e = torch.exp(logits - m[..., None])
    total = torch.zeros_like(m)
    for a, b in chunks:
        total = total + e[..., a:b].sum(-1)
    w = (e * (1.0 / total)[..., None] * v_scale.view(Bq, 1, R)).to(dt).float()
    out = torch.zeros(Bq, n_heads, hd)
    for a, b in chunks:
        out = out + torch.einsum("bhs,bshd->bhd", w[..., a:b],
                                 v[:, a:b].float().view(Bq, b - a, n_heads,
                                                        hd))
    return out.to(dt).float().reshape(Bq, D)


def tc_gemv(x, w, warps=8, kc=64):
    """mgemv_kernel's accumulation: x (B, K) and w (N, K) rounded to w's
    dtype; K padded with zeros to whole 64-wide chunks, chunk c dealt to
    warp c % 8, each 16-wide k step's products summed into the warp's f32
    partial; the partials added in warp order."""
    xb = x.to(w.dtype).float()
    wf = w.float()
    K = x.shape[-1]
    Kp = -(-K // kc) * kc
    xb = torch.nn.functional.pad(xb, (0, Kp - K))
    wf = torch.nn.functional.pad(wf, (0, Kp - K))
    part = torch.zeros(warps, x.shape[0], w.shape[0])
    for c in range(Kp // kc):
        for s in range(c * kc, (c + 1) * kc, 16):
            part[c % warps] += xb[:, s:s + 16] @ wf[:, s:s + 16].t()
    total = torch.zeros(x.shape[0], w.shape[0])
    for i in range(warps):
        total = total + part[i]
    return total


def fragment_rows(lane: int, e: int):
    """(row, clip) of C-fragment element e of `lane` in an m16n8 tile."""
    return lane // 4 + 8 * (e >> 1), 2 * (lane % 4) + (e & 1)


# ---------------------------------------------------------------------------
# tiny models
# ---------------------------------------------------------------------------

_T = ("wqkv", "wo", "cwq", "cwo", "fw1g", "fw2", "sw1g", "sw2", "gate_w")
_EXPERT = ("ew1g", "ew2")
_ROW = ("bqkv", "bo", "cbq", "cbo", "fb1g", "fb2", "sb1g", "sb2", "gate_b",
        "lam", "clam", "subw", "csubw")


def _cfg(version, factory=amt_config, d_model=16, d_ff=32):
    return factory(version, n_layers=4, num_heads=2, d_model=d_model,
                   d_ff=d_ff, max_seq_video=S, max_seq_chord=S,
                   total_vf_dim=7 + 1 + 1 + 2, dropout=0.0)


def _params(cfg, seed=3):
    z = jnp.zeros((1, S - 1), jnp.int32)
    f = jnp.zeros((1, S, 7), jnp.float32)
    s = jnp.zeros((1, S), jnp.float32)
    return JaxAMT(cfg=cfg).init(
        {"params": jax.random.PRNGKey(seed)}, z, z, z, f, jnp.ones((1, 1)), s,
        s, jnp.zeros((1, S, 2)))["params"]


def _port_layer(jl, dtype=torch.float32):
    """A JAX packed variant layer in the port's layout."""
    out = {}
    for key, val in jl.items():
        a = np.array(jnp.asarray(val, jnp.float32))
        if key in _T:
            a = a.T
        elif key in _EXPERT:
            a = a.transpose(0, 2, 1)
        elif key in _ROW:
            a = a.reshape(-1)
        t = torch.from_numpy(np.ascontiguousarray(a))
        out[key] = t if key in ("lam", "clam", "subw", "csubw", "er") \
            else t.to(dtype)
    return out


def _rope(cfg):
    if not cfg.decoder_layers[0].attn.rope:
        return None
    t = rope_table(S, cfg.d_model // cfg.num_heads, "cpu")
    return t[..., 0].contiguous(), t[..., 1].contiguous()


def _inputs(r, meta, D, lead=()):
    kw = 2 * D if meta.attn == "differential" else D
    cw = 2 * D if meta.cross == "differential" else D
    n = lambda *shape: r.standard_normal(lead + shape).astype(np.float32)
    return n(D), n(S, kw), n(S, D), n(S, cw), n(S, D)


@pytest.fixture(scope="module", params=[None, "1.1", "3.1"],
                ids=["AMT-rpr", "1.1-vanilla", "3.1-differential"])
def variant(request):
    cfg = _cfg(request.param)
    layers, metas = jax_pack(_params(cfg), cfg)
    return dict(version=request.param, cfg=cfg, layers=layers, metas=metas)


# ---------------------------------------------------------------------------
# the cluster-split attention against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cs", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cluster_attention_b1_layer_matches_pallas(variant, dtype, cs,
                                                   monkeypatch):
    """B=1: the port's plain variant layer with cluster_attend in place of
    its attention, against the Pallas decode_variant_layer_step."""
    cfg = variant["cfg"]
    D, H = cfg.d_model, cfg.num_heads
    monkeypatch.setattr(dv, "attend", functools.partial(cluster_attend,
                                                        cs=cs))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    kw = dict(n_heads=H, k_top=cfg.moe.n_experts_per_token, norm=cfg.norm,
              pre_norm=cfg.pre_norm)
    i = 0
    # both sides hold the same bf16-exact weights (the f32 rows of the
    # differential and RPR extras as they are)
    jl = {key: a if key in ("lam", "clam", "subw", "csubw", "er")
          else jnp.asarray(jnp.asarray(a, jdt), jnp.float32)
          for key, a in variant["layers"][i].items()}
    jmeta = variant["metas"][i]
    meta = dv.VariantLayerMeta(**dataclasses.asdict(jmeta))
    pl_ = _port_layer(jl, tdt)
    r = np.random.default_rng(7 + cs)
    for pos in (0, 6, S - 1):
        x, kc, vc, kx, vx = _inputs(r, meta, D)
        want, k_new, _ = jax_variant(
            jnp.asarray(x[None], jdt), pos, jl, jmeta, jnp.asarray(kc, jdt),
            jnp.asarray(vc, jdt), jnp.asarray(kx, jdt), jnp.asarray(vx, jdt),
            rope=cfg.decoder_layers[0].attn.rope, interpret=True, **kw)
        pk = torch.from_numpy(kc).to(tdt)
        pv = torch.from_numpy(vc).to(tdt)
        got = dv.decode_variant_layer_plain(
            torch.from_numpy(x[None]).to(tdt), pos, pl_, meta, pk, pv,
            torch.from_numpy(kx).to(tdt), torch.from_numpy(vx).to(tdt),
            rope=_rope(cfg), **kw)
        msg = f"{variant['version']} cs {cs} pos {pos} {dtype}"
        if dtype == "float32":
            _close(got, want, msg)
            _close(pk, k_new, msg + " k cache")
        else:
            _close_bf16(got, want, msg)


@pytest.mark.parametrize("cs", [1, 4])
def test_cluster_attention_batched_layer_matches_pallas(variant, cs,
                                                        monkeypatch):
    """B=3 batched: the plain batched variant layer with cluster_attend
    (probabilities of the cache rows rounded, row `cur` kept f32) against
    the Pallas batched_variant_layer_step."""
    cfg = variant["cfg"]
    D, H = cfg.d_model, cfg.num_heads
    monkeypatch.setattr(dv, "attend", functools.partial(cluster_attend,
                                                        cs=cs))
    nkw = dict(norm=cfg.norm, pre_norm=cfg.pre_norm)
    i = 0
    jl, jmeta = variant["layers"][i], variant["metas"][i]
    meta = dv.VariantLayerMeta(**dataclasses.asdict(jmeta))
    pl_ = _port_layer(jl)
    r = np.random.default_rng(30 + cs)
    for pos in (0, S - 1):
        x, kc, vc, kx, vx = _inputs(r, meta, D, (B,))
        want, k_row, _ = jax_variant_b(
            jnp.asarray(x), pos, jl, jmeta, jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(kx), jnp.asarray(vx), n_heads=H,
            rope=cfg.decoder_layers[0].attn.rope, interpret=True, **nkw)
        pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        got = dbv.batched_variant_layer_plain(
            torch.from_numpy(x), pos, pl_, meta, pk, pv,
            torch.from_numpy(kx), torch.from_numpy(vx), n_heads=H,
            rope=_rope(cfg), **nkw)
        msg = f"{variant['version']} cs {cs} pos {pos} B={B}"
        _close(got, want, msg)
        _close(pk[:, pos], k_row, msg + " k row")


@pytest.fixture(scope="module")
def v22():
    """Tiny 2.2 in JAX and the port (bridged weights), its packed layers
    and the primed cross K/V of B=3 clips."""
    cfg = _cfg("2.2")
    r = np.random.default_rng(0)
    feats = dict(semantic=r.standard_normal((B, S, 7)).astype(np.float32),
                 scene_offset=r.integers(0, 5, (B, S)).astype(np.float32),
                 motion=r.standard_normal((B, S)).astype(np.float32),
                 emotion=r.uniform(size=(B, S, 2)).astype(np.float32))
    jm = JaxAMT(cfg=cfg)
    z = jnp.zeros((1, S - 1), jnp.int32)
    variables = jm.init({"params": jax.random.PRNGKey(1)}, z, z, z,
                        feats["semantic"][:1], jnp.ones((1, 1)),
                        feats["scene_offset"][:1], feats["motion"][:1],
                        feats["emotion"][:1])
    pm = VideoMusicTransformer(_cfg("2.2", port_amt_config)).eval()
    pm.load_state_dict(amt_from_jax(jax.device_get(variables["params"]),
                                    variables.get("moe_state")))
    memory, _ = jm.apply(variables, feats["semantic"], feats["scene_offset"],
                         feats["motion"], feats["emotion"], method=jm.encode,
                         mutable=["metrics", "moe_state"])
    _, primed = jm.apply(variables, memory, method=jm.prime,
                         mutable=["cache"])
    return dict(cfg=cfg, variables=variables, pm=pm, cross=primed["cache"])


def _lanes(a):  # flax cache (B, H, S, hd) -> (B, S, H*hd)
    a = np.asarray(a)
    return a.transpose(0, 2, 1, 3).reshape(a.shape[0], a.shape[2], -1)


@pytest.mark.parametrize("cs", [1, 3, 4])
@pytest.mark.parametrize("case", ["bf16 caches", "int8 caches"])
def test_cluster_attention_2p2_batched_matches_pallas(v22, case, cs,
                                                      monkeypatch):
    """B=3, the 2.2 batched layer (vanilla attention, RoPE): the plain step
    with the cluster mirror against the Pallas batched_layer_step, on bf16
    caches (bf16 weights) and on int8 caches (f32 weights, the current row
    from its dequantized copy)."""
    m = v22
    cfg = m["cfg"]
    D, H = cfg.d_model, cfg.num_heads
    i = 3  # the deep layer
    quant = case == "int8 caches"
    monkeypatch.setattr(db, "attend", functools.partial(cluster_attend,
                                                        cs=cs))
    monkeypatch.setattr(db, "attend_int8", functools.partial(
        cluster_attend_int8, cs=cs))
    params, pm = m["variables"]["params"], m["pm"]
    jdt, tdt = jnp.float32, torch.float32
    if not quant:
        jdt, tdt = jnp.bfloat16, torch.bfloat16
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
        pm = VideoMusicTransformer(_cfg("2.2", port_amt_config)).eval()
        pm.load_state_dict(amt_from_jax(jax.device_get(
            m["variables"]["params"]), m["variables"].get("moe_state")))
        pm = pm.to(tdt)
    jl = jpd.pack_decoder_layers(params, cfg)[i]
    pl_ = dl.pack_decoder_layers(pm)[i]
    r = np.random.default_rng(50 + cs)
    cc = m["cross"][f"dec_{i}"]["cross_attn"]
    t = lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    for pos in (0, 5, S - 1):
        x = r.standard_normal((B, D)).astype(np.float32)
        msg = f"{case} cs {cs} pos {pos}"
        if quant:
            kc, ks = jpb.quantize_kv_rows(jnp.asarray(
                r.standard_normal((B, S, D)).astype(np.float32)))
            vc, vs = jpb.quantize_kv_rows(jnp.asarray(
                r.standard_normal((B, S, D)).astype(np.float32)))
            kx, kxs = jpb.quantize_kv_rows(jnp.asarray(_lanes(cc["k"])))
            vx, vxs = jpb.quantize_kv_rows(jnp.asarray(_lanes(cc["v"])))
            want = jpb.batched_layer_step(
                jnp.asarray(x), pos, jl, kc, vc, kx, vx, n_heads=H,
                rope=True, block_b=B, interpret=True,
                kv_scales=(ks, vs, kxs, vxs))[0]
            pk, pv = (torch.from_numpy(np.array(a)) for a in (kc, vc))
            got = db.batched_layer_step_plain(
                torch.from_numpy(x), pos, pl_, pk, pv,
                torch.from_numpy(np.array(kx)), torch.from_numpy(np.array(vx)),
                n_heads=H, rope=_rope(cfg),
                kv_scales=tuple(torch.from_numpy(np.array(a))
                                for a in (ks, vs, kxs, vxs)))
            _close(got, want, msg)
        else:
            kc, vc = (r.standard_normal((B, S, D)).astype(np.float32)
                      for _ in range(2))
            kx, vx = _lanes(cc["k"]), _lanes(cc["v"])
            want = jpb.batched_layer_step(
                jnp.asarray(x, jdt), pos, jl, jnp.asarray(kc, jdt),
                jnp.asarray(vc, jdt), jnp.asarray(kx, jdt),
                jnp.asarray(vx, jdt), n_heads=H, rope=True, block_b=B,
                interpret=True)[0]
            got = db.batched_layer_step_plain(
                t(x).to(tdt), pos, pl_, t(kc).to(tdt), t(vc).to(tdt),
                t(kx).to(tdt), t(vx).to(tdt), n_heads=H, rope=_rope(cfg))
            _close_bf16(got, want, msg)


def test_cluster_split_is_the_plain_attention():
    """Any cluster size gives the plain attention's output: the split
    changes only the order of the sums (f32, 300 rows, RPR and
    differential, the row counts of the product path)."""
    g = torch.Generator().manual_seed(0)
    Bq, H, hd, R = 2, 4, 16, 151
    D = H * hd
    for nq, er in ((1, None), (1, torch.randn(300, D, generator=g)),
                   (2, None)):
        q = torch.randn(Bq, nq * D, generator=g)
        k = torch.randn(Bq, R, nq * D, generator=g)
        v = torch.randn(Bq, R, D, generator=g)
        kw = dict(er=er, pos=R - 1, cur=R - 1)
        if nq == 2:
            kw.update(lam=torch.tensor([0.3]), subw=torch.rand(D))
        want = dl.attend(q, k, v, H, **kw)
        for cs in (1, 2, 4, 8):
            got = cluster_attend(q, k, v, H, cs=cs, **kw)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"nq {nq} cs {cs}")


def test_cluster_size_rule():
    """At B=1 (8 heads) 4 blocks a head over 151 rows and 8 over 300, 2 at
    B=16, one at B=64; a block keeps at least 32 rows. The cluster kernel
    runs at B=1 and for differential pairs, the one-block kernel for vanilla
    and RPR heads at B=16 and B=64."""
    assert cluster_of(151, 8) == 4 and cluster_of(300, 8) == 8
    assert cluster_of(151, 16 * 8) == 2 and cluster_of(151, 64 * 8) == 1
    assert cluster_of(1, 8) == 1 and cluster_of(63, 8) == 1
    assert cluster_of(64, 8) == 2 and cluster_of(128, 8) == 4
    assert runs_cluster(151, 8, False) and runs_cluster(300, 8, False)
    for B in (16, 64):
        assert not runs_cluster(151, B * 8, False)
        assert not runs_cluster(300, B * 8, False)
        assert runs_cluster(151, B * 8, True)


# ---------------------------------------------------------------------------
# the tensor-core GEMV's accumulation and fragment map
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K, Bn, dtype", [
    (136, 2, "float32"),      # K not a whole chunk, fewer warps than chunks
    (512, 16, "bfloat16"),    # the product QKV width
    (2048, 64, "bfloat16"),   # d_ff 2048, four clip groups
])
def test_tc_gemv_accumulation_matches_dot(K, Bn, dtype):
    g = torch.Generator().manual_seed(K + Bn)
    dt = getattr(torch, dtype)
    N = 48
    x = torch.randn(Bn, K, generator=g)
    w = (torch.randn(N, K, generator=g) * K ** -0.5).to(dt)
    want = dl._dot(x, w)
    got = tc_gemv(x, w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fragment_rope_pairs_are_four_lanes_apart():
    """Every C-fragment element's RoPE partner (row ^ 1, same clip) sits on
    lane ^ 4 in the same element slot, so one xor-4 shuffle pairs them; the
    32 lanes x 4 elements cover the 16 x 8 tile once."""
    seen = set()
    for lane in range(32):
        for e in range(4):
            row, clip = fragment_rows(lane, e)
            seen.add((row, clip))
            assert fragment_rows(lane ^ 4, e) == (row ^ 1, clip)
    assert seen == {(r, c) for r in range(16) for c in range(8)}


# ---------------------------------------------------------------------------
# rows 6-10 at d_ff 2048
# ---------------------------------------------------------------------------

WIDE = dict(d_model=128, d_ff=2048)


@pytest.fixture(scope="module")
def wide22():
    cfg = _cfg("2.2", **WIDE)
    params = _params(cfg, seed=5)
    pm = VideoMusicTransformer(_cfg("2.2", port_amt_config, **WIDE)).eval()
    pm.load_state_dict(amt_from_jax(jax.device_get(params)))
    return dict(cfg=cfg, params=params, pm=pm)


@pytest.mark.parametrize("layer_idx", [0, 3])  # shallow SwiGLU / deep MoE
def test_wide_ffn_batched_pair_matches_pallas(wide22, layer_idx):
    """Rows 6 and 7 at d_ff 2048: the plain batched layer (and MoE half of
    the deep layer) against the Pallas kernels in interpret mode."""
    m = wide22
    cfg = m["cfg"]
    D, H = cfg.d_model, cfg.num_heads
    assert cfg.d_ff == 2048
    jl = jpd.pack_decoder_layers(m["params"], cfg)[layer_idx]
    pl_ = dl.pack_decoder_layers(m["pm"])[layer_idx]
    r = np.random.default_rng(60 + layer_idx)
    kc, vc, kx, vx = (r.standard_normal((B, S, D)).astype(np.float32)
                      for _ in range(4))
    pos = 7
    x = r.standard_normal((B, D)).astype(np.float32)
    want, k_row, _ = jpb.batched_layer_step(
        jnp.asarray(x), pos, jl, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kx), jnp.asarray(vx), n_heads=H, rope=True, block_b=B,
        interpret=True)
    pk = torch.from_numpy(kc.copy())
    got = db.batched_layer_step(
        torch.from_numpy(x), pos, pl_, pk, torch.from_numpy(vc.copy()),
        torch.from_numpy(kx), torch.from_numpy(vx), n_heads=H,
        rope=_rope(cfg))
    _close(got, want, f"layer {layer_idx}")
    _close(pk[:, pos], k_row, f"layer {layer_idx} k row")
    if layer_idx == 3:
        want3 = jpb.batched_moe_ffn(want, None, jl,
                                    k_top=cfg.moe.n_experts_per_token,
                                    interpret=True, gate=True)
        got3 = db.batched_moe_ffn(torch.from_numpy(np.array(want)), pl_,
                                  k_top=cfg.moe.n_experts_per_token)
        _close(got3, want3, "moe")


@pytest.fixture(scope="module")
def wide31():
    cfg = _cfg("3.1", **WIDE)
    layers, metas = jax_pack(_params(cfg, seed=6), cfg)
    return dict(cfg=cfg, layers=layers, metas=metas)


@pytest.mark.parametrize("layer_idx", [0, 3])  # shallow SwiGLU / deep MoE
def test_wide_ffn_variant_kernels_match_pallas(wide31, layer_idx):
    """Rows 8-10 at d_ff 2048 (V3.1): the plain B=1 variant layer and the
    plain batched variant pair against the Pallas kernels."""
    m = wide31
    cfg = m["cfg"]
    D, H = cfg.d_model, cfg.num_heads
    k_top = cfg.moe.n_experts_per_token
    nkw = dict(norm=cfg.norm, pre_norm=cfg.pre_norm)
    jl, jmeta = m["layers"][layer_idx], m["metas"][layer_idx]
    meta = dv.VariantLayerMeta(**dataclasses.asdict(jmeta))
    pl_ = _port_layer(jl)
    r = np.random.default_rng(70 + layer_idx)
    pos = 7
    x, kc, vc, kx, vx = _inputs(r, meta, D)
    want, k_new, _ = jax_variant(
        jnp.asarray(x[None]), pos, jl, jmeta, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kx), jnp.asarray(vx), rope=True, interpret=True,
        n_heads=H, k_top=k_top, **nkw)
    pk = torch.from_numpy(kc.copy())
    got = dv.decode_variant_layer_step(
        torch.from_numpy(x[None]), pos, pl_, meta, pk,
        torch.from_numpy(vc.copy()), torch.from_numpy(kx),
        torch.from_numpy(vx), n_heads=H, rope=_rope(cfg), k_top=k_top, **nkw)
    _close(got, want, f"B=1 layer {layer_idx}")
    _close(pk, k_new, f"B=1 layer {layer_idx} k cache")
    x, kc, vc, kx, vx = _inputs(r, meta, D, (B,))
    want, k_row, _ = jax_variant_b(
        jnp.asarray(x), pos, jl, jmeta, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(kx), jnp.asarray(vx), n_heads=H, rope=True,
        interpret=True, **nkw)
    got = dbv.batched_variant_layer_step(
        torch.from_numpy(x), pos, pl_, meta, torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), torch.from_numpy(kx),
        torch.from_numpy(vx), n_heads=H, rope=_rope(cfg), **nkw)
    _close(got, want, f"B={B} layer {layer_idx}")
    if meta.ffn == "moe":
        want3 = jax_variant_moe_b(want, jl, jmeta, k_top=k_top,
                                  interpret=True, **nkw)
        got3 = dbv.batched_variant_moe_ffn(torch.from_numpy(np.array(want)),
                                           pl_, meta, k_top=k_top, **nkw)
        _close(got3, want3, f"B={B} moe")


def test_batched_gemv_cpu_is_the_plain_version():
    """The GEMV yardstick's wrapper takes the plain version on CPU tensors
    (x . w^T + bias, accumulated in f32, in the compute dtype) and
    launches nothing."""
    g = torch.Generator().manual_seed(3)
    before = db.batched_gemv.launches
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(16, 64, generator=g).to(dt)
        w = torch.randn(48, 64, generator=g).to(dt)
        bias = torch.randn(48, generator=g).to(dt)
        got = db.batched_gemv(x, w, bias)
        want = (x.float() @ w.float().t() + bias.float()).to(dt)
        assert got.dtype == dt and torch.equal(got, want)
    assert db.batched_gemv.launches == before
