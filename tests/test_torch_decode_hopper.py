"""The repairs and redesigns of the B=1 decode chain, the batched MoE half
and the attention kernels' head sizes, held to the JAX package on the CPU
(Pallas kernels in interpret mode, as the JAX tests run them).

* Head sizes outside the kernels' instances: the wrappers pad q, k, v (and
  dO, O) with zero columns up to the next built head size (16, 32, 64,
  128, 256) and keep the unpadded scale. The padded form, run through the
  plain versions at the padded size with q scaled by sqrt(Dp / D) (so
  that their 1 / sqrt(Dp) is the kernels' 1 / sqrt(D)), against the
  Pallas flash attention and dropout attention at head sizes 48, 96 and
  128: outputs, the dropout mask and gradients.
* Routers of any width: the kernels pick the top k by each expert's rank
  (the experts ordered before it: larger logit, then lower index), not by
  a 32-bit mask; the rank rule against the argmax loop, and the plain 2.2
  decode layer and batched MoE step at 40 experts, top-10 (with a tie at
  the selection's edge) against the Pallas kernels.
* The B=1 chain's attention (csrc/decode_layer.cu chain_attention_kernel,
  one block a head, the exponentials' sum dividing P.V at the end): a
  plain mirror of its sum order in place of the plain layer's attention,
  against the Pallas decode_layer_step at pos 150 and token for token in
  generate_chords.
* The batched MoE half's dense expert slots (every expert on every clip,
  the close adding only the selected ones, in expert order) against the
  Pallas batched_moe_ffn at B=3, and the dense / routed cut against the
  path that ran faster on the card.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video2music_tpu.core import constants as C
from video2music_tpu.core.config import amt_config
from video2music_tpu.decode.sampler import GenerateConfig as JaxGenerateConfig
from video2music_tpu.decode.sampler import generate_chords as jax_generate
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops.pallas_attention import flash_attention as jax_flash
from video2music_tpu.ops.pallas_attention_dropout import (
    extract_dropped_probs as jax_extract, flash_attention_dropout as jax_fad)
from video2music_tpu.ops.pallas_decode import (decode_layer_step as jax_layer,
                                               pack_decoder_layers as jax_pack)
from video2music_tpu.ops.pallas_decode_batch import (
    batched_moe_ffn as jax_moe_b)
from video2music_tpu_torch import kernels
from video2music_tpu_torch.decode.sampler import (GenerateConfig,
                                                  generate_chords)
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops import decode_batch as db
from video2music_tpu_torch.ops import decode_layer as dl
from video2music_tpu_torch.ops import flash_attention_dropout as fad
from video2music_tpu_torch.ops.decode_batch import (batched_moe_ffn_plain,
                                                    route_plain)
from video2music_tpu_torch.ops.embeddings import rope_table
from video2music_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_attention_plain)
from video2music_tpu_torch.weights import amt_from_jax

torch.set_num_threads(1)
INTERP = pltpu.InterpretParams()
RTOL, ATOL = 2e-4, 2e-5  # f32: another summation order only
BF16_REL = 2e-2          # bf16: relative to the largest magnitude
B1_REL = 1e-5            # the B=1 mirror in f32, relative to the largest
L = 12                   # sequence length of the tiny models
E40, K10 = 40, 10


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _close_rel(got, want, rel, msg=""):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{msg}: max abs {err}"


def _check(got, want, dtype, msg=""):
    if dtype == "float32":
        _close(got, want, msg)
    else:
        _close_rel(got, want, BF16_REL, msg)


# ---------------------------------------------------------------------------
# head sizes: the padded form of the attention kernels
# ---------------------------------------------------------------------------

def _attn_inputs(seed, D, n=4, Lq=24):
    r = np.random.default_rng(seed)
    return [r.standard_normal((1, 2, Lq, D)).astype(np.float32)
            for _ in range(n)]


def _padded(D, q, *ts):
    """q, *ts zero-padded to the kernels' head instance Dp, q in f32 and
    scaled by sqrt(Dp / D): the plain versions' 1 / sqrt(Dp) on the padded
    q is the kernels' 1 / sqrt(D). Returns (factor, padded tensors)."""
    Dp = kernels.head_instance(D, "test")
    c = (Dp / D) ** 0.5
    return c, [kernels.pad_head(t, Dp) for t in (q.float() * c, *ts)]


def test_head_instances_and_the_limit():
    assert [kernels.head_instance(d, "t") for d in (8, 16, 48, 64, 80, 96,
                                                    128, 200, 256)] == \
        [16, 16, 64, 64, 128, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="above 256"):
        kernels.head_instance(320, "t")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["plain", "bias", "causal"])
@pytest.mark.parametrize("D", [48, 96, 128])
def test_padded_flash_attention_matches_pallas(D, mode, dtype):
    q, k, v = _attn_inputs(D + len(mode), D, n=3)
    bias = np.random.default_rng(1).standard_normal(
        (1, 2, 24, 24)).astype(np.float32) if mode == "bias" else None
    causal = mode == "causal"
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    want = jax_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                     bias=None if bias is None else jnp.asarray(bias),
                     causal=causal, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    _, padded = _padded(D, tq, tk, tv)
    got = flash_attention_plain(*padded, bias=tb, causal=causal)[..., :D]
    got = got.to(tdt)
    _check(got, want, dtype, f"padded D={D} {mode}")
    _check(flash_attention(tq, tk, tv, bias=tb, causal=causal), want, dtype,
           f"wrapper D={D} {mode}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [48, 96, 128])
def test_padded_dropout_attention_matches_pallas(D, causal, dtype):
    rate, seed = 0.1, 11
    q, k, v, do = _attn_inputs(3 * D + causal, D)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)

    def f(q_, k_, v_):
        return jax_fad(q_, k_, v_, causal=causal, dropout_rate=rate,
                       seed=seed, interpret=INTERP)
    want, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    wants = vjp(jnp.asarray(do, jdt))
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    c, (pq, pk, pv, pdo) = _padded(D, tq, tk, tv, tdo)
    kw = dict(causal=causal, dropout_rate=rate, seed=seed)
    got = fad.flash_attention_dropout_plain(pq, pk, pv, **kw)[..., :D]
    _check(got.to(tdt), want, dtype, f"out D={D}")
    dq, dk, dv, _ = fad.flash_attention_dropout_plain_bwd(pq, pk, pv, pdo,
                                                          **kw)
    grads = ((dq * c).to(tdt), dk, dv)  # d/dq of f(c q) = c f'(c q)
    for name, g, w in zip(("dq", "dk", "dv"), grads, wants):
        _check(g[..., :D], w, dtype, f"{name} D={D}")
    # the mask: a hash of (seed, head, row, column), independent of D
    jm = np.asarray(jnp.asarray(jax_extract(
        jnp.asarray(q), jnp.asarray(k), causal=causal, dropout_rate=rate,
        seed=seed, interpret=INTERP), jnp.float32))
    _, (pq32, pk32) = _padded(D, torch.from_numpy(q), torch.from_numpy(k))
    pm = (fad._probs(pq32, pk32, None, causal)
          * fad.dropout_mask(1, 2, 24, 24, rate, seed, "cpu")).numpy()
    np.testing.assert_array_equal(pm == 0, jm == 0)
    np.testing.assert_allclose(pm, jm, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# routers of any width
# ---------------------------------------------------------------------------

def expert_rank(logits, e):
    """common.cuh expert_rank: the experts ordered before e (larger logit,
    then lower index; a NaN after every number)."""
    v = logits[e]
    rank = 0
    for o, u in enumerate(logits):
        nu, nv = math.isnan(u), math.isnan(v)
        if nu != nv:
            rank += nv
        elif not nu and u != v:
            rank += u > v
        else:
            rank += o < e
    return rank


def rank_top_k(logits, k):
    """The kernels' selection: expert e takes slot rank(e) if < k."""
    sel = [None] * k
    for e in range(len(logits)):
        r = expert_rank(logits, e)
        if r < k:
            sel[r] = e
    return sel


@pytest.mark.parametrize("E,k", [(6, 2), (40, 10), (40, 40), (100, 7)])
def test_rank_top_k_is_the_argmax_loop(E, k):
    """Ties (logits drawn from a few values) resolve to the first index, as
    in the Pallas kernels' top-k loop (and the plain _moe)."""
    r = np.random.default_rng(E + k)
    for _ in range(20):
        logits = (r.integers(0, 5, E) * 0.5).astype(np.float32)
        remaining = torch.from_numpy(logits.copy())
        want = []
        for _ in range(k):
            e = int(torch.argmax(remaining))
            want.append(e)
            remaining[e] = -math.inf
        assert rank_top_k(list(map(float, logits)), k) == want
    # a NaN logit ranks last, so the selection stays a permutation
    logits = [1.0, float("nan"), 3.0, float("nan"), 2.0]
    assert rank_top_k(logits, 5) == [2, 4, 0, 1, 3]


def _model(E=6, k=2, **kw):
    cfg = amt_config("2.2", n_layers=4, num_heads=2, d_model=16, d_ff=32,
                     total_vf_dim=7 + 1 + 1 + 2, dropout=0.0,
                     **{"max_seq_video": L, "max_seq_chord": L, **kw})
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=E, n_experts_per_token=k))
    S, Sm = cfg.max_seq_chord, cfg.max_seq_video
    jm = JaxAMT(cfg=cfg)
    z = jnp.zeros((1, S - 1), jnp.int32)
    f = jnp.zeros((1, Sm, 7), jnp.float32)
    s = jnp.zeros((1, Sm), jnp.float32)
    variables = jm.init({"params": jax.random.PRNGKey(E)}, z, z, z, f,
                        jnp.ones((1, 1)), s, s, jnp.zeros((1, Sm, 2)))
    params = jax.device_get(variables["params"])
    pm = VideoMusicTransformer(cfg).eval()
    pm.load_state_dict(amt_from_jax(params))
    return cfg, jm, variables, params, pm


# experts sharing one gate column and a large bias: all tie for the top of
# every row, so the first k indices win and the last two lose
TIED = (2, 5, 9, 11, 17, 20, 23, 26, 30, 33, 36, 39)


def _tie(params, pm, i):
    gate = params[f"dec_{i}"]["ffn"]["gate"]
    w, b = np.array(gate["kernel"]), np.array(gate["bias"])
    w[:, list(TIED)] = w[:, [TIED[0]]]
    b[list(TIED)] = 10.0
    params = jax.tree_util.tree_map(lambda x: x, params)
    ffn = dict(params[f"dec_{i}"]["ffn"],
               gate=dict(gate, kernel=jnp.asarray(w), bias=jnp.asarray(b)))
    params[f"dec_{i}"] = dict(params[f"dec_{i}"], ffn=ffn)
    with torch.no_grad():
        g = pm.decoder_layers[i].ffn.gate
        g.weight.copy_(torch.from_numpy(w.T))
        g.bias.copy_(torch.from_numpy(b))
    return params


@pytest.fixture(scope="module")
def forty():
    cfg, _, _, params, pm = _model(E40, K10)
    tied = _tie(params, pm, 3)  # pm now holds the tied gate
    return dict(cfg=cfg, params=params, tied=tied, pm=pm)


def _layer_inputs(seed, D, S, Sm):
    r = np.random.default_rng(seed)
    return (r.standard_normal((1, D)).astype(np.float32),
            *(r.standard_normal((n, D)).astype(np.float32)
              for n in (S, S, Sm, Sm)))


def _port_rope(cfg):
    t = rope_table(cfg.max_seq_chord, cfg.d_model // cfg.num_heads, "cpu")
    return t[..., 0].contiguous(), t[..., 1].contiguous()


def _run_layer(cfg, jl, pl_, pos, seed, attend=None, monkeypatch=None):
    """(port y, port k cache, JAX y, JAX k cache) of one B=1 step."""
    D, H = cfg.d_model, cfg.num_heads
    x, kc, vc, kx, vx = _layer_inputs(seed, D, cfg.max_seq_chord,
                                      cfg.max_seq_video)
    k_top = cfg.moe.n_experts_per_token
    want, jk, _ = jax_layer(jnp.asarray(x), pos, jl, jnp.asarray(kc),
                            jnp.asarray(vc), jnp.asarray(kx), jnp.asarray(vx),
                            n_heads=H, rope=True, k_top=k_top, interpret=True)
    if attend is not None:
        monkeypatch.setattr(dl, "attend", attend)
    pk = torch.from_numpy(kc.copy())
    got = dl.decode_layer_step(torch.from_numpy(x), pos, pl_, pk,
                               torch.from_numpy(vc.copy()),
                               torch.from_numpy(kx), torch.from_numpy(vx),
                               n_heads=H, k_top=k_top, rope=_port_rope(cfg))
    return got, pk, want, jk


@pytest.mark.parametrize("gate", ["random", "tie"])
def test_forty_expert_decode_layer_matches_pallas(forty, gate):
    cfg = forty["cfg"]
    params = forty["tied"] if gate == "tie" else forty["params"]
    pm = forty["pm"]
    if gate == "random":  # the bridged weights, not the tied gate
        pm = VideoMusicTransformer(cfg).eval()
        pm.load_state_dict(amt_from_jax(params))
    jl = jax_pack(params, cfg)[3]
    pl_ = dl.pack_decoder_layers(pm)[3]
    assert pl_["gate_w"].shape[0] == E40
    for pos in (0, 7, L - 1):
        got, pk, want, jk = _run_layer(cfg, jl, pl_, pos, seed=pos)
        _close(got, want, f"{gate} pos {pos}")
        _close(pk, jk, f"{gate} pos {pos} k cache")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forty_expert_batched_moe_with_tie_matches_pallas(forty, dtype):
    cfg = forty["cfg"]
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt),
                                    forty["tied"])
    jl = jax_pack(params, cfg)[3]
    pl_ = {k: v.to(tdt) for k, v in
           dl.pack_decoder_layers(forty["pm"])[3].items()}
    x2 = np.random.default_rng(40).standard_normal(
        (3, cfg.d_model)).astype(np.float32)
    want = jax_moe_b(jnp.asarray(x2, jdt), None, jl, k_top=K10,
                     interpret=True, gate=True)
    xt = torch.from_numpy(x2).to(tdt)
    _check(batched_moe_ffn_plain(xt, pl_, k_top=K10), want, dtype, "plain")
    _check(dense_moe(xt, pl_, K10), want, dtype, "dense mirror")
    cw = route_plain(xt, pl_["gate_w"], pl_["gate_b"], K10)
    assert (cw[:, list(TIED[:K10])] > 0).all()
    assert (cw[:, list(TIED[K10:])] == 0).all()


# ---------------------------------------------------------------------------
# the batched MoE half's dense expert slots
# ---------------------------------------------------------------------------

def dense_moe(x2, p, k_top):
    """csrc/decode_batch.cu run_moe with dense_experts: the router (the row
    rounded to T, the rank top-k, softmax over the selected raw logits);
    the shared expert and every expert's [w1|wg] and w2 on every clip (slot
    s: the shared expert at 0, expert s - 1 after), each matmul input
    rounded to T; the close: x2 + shared / k + the selected experts in
    expert order, each times its weight, then LayerNorm 3 rounded to T.
    The unselected experts' outputs are computed and never read."""
    dt = x2.dtype
    E = p["gate_w"].shape[0]
    logits = dl._dot(x2, p["gate_w"]) + p["gate_b"].float()
    slots = [(p["w1g"], p["b1g"], p["w2"], p["b2"])] + [
        (p["ew1g"][e], p["eb1g"][e], p["ew2"][e], p["eb2"][e])
        for e in range(E)]
    ye = [dl._swiglu(x2, *w) for w in slots]
    rows = []
    for b in range(x2.shape[0]):
        sel = rank_top_k(logits[b].tolist(), k_top)
        v = logits[b, sel]
        w = torch.exp(v - v[0]) / torch.exp(v - v[0]).sum()
        acc = ye[0][b] / float(k_top)
        for j in sorted(range(k_top), key=lambda j: sel[j]):
            acc = acc + w[j] * ye[sel[j] + 1][b]
        rows.append(x2[b].float() + acc)
    y = dl._layer_norm(torch.stack(rows), p["norm_scale"][2],
                       p["norm_bias"][2])
    return y.to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k", [(6, 2), (E40, K10)])
def test_dense_expert_slots_match_pallas(E, k, dtype):
    cfg, _, _, params, pm = _model(E, k)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jl = jax_pack(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt),
                                         params), cfg)[3]
    pl_ = {kk: v.to(tdt) for kk, v in dl.pack_decoder_layers(pm)[3].items()}
    x2 = np.random.default_rng(E).standard_normal(
        (3, cfg.d_model)).astype(np.float32)
    want = jax_moe_b(jnp.asarray(x2, jdt), None, jl, k_top=k,
                     interpret=True, gate=True)
    _check(dense_moe(torch.from_numpy(x2).to(tdt), pl_, k), want, dtype,
           f"E={E} k={k}")


# the faster path on an H100 in chip_smoke.py's "expert cut" phase (rows 7
# and 10, bf16): routed below the crossing, dense from it
@pytest.mark.parametrize("E,k,B,dense", [
    (6, 2, 2, False), (6, 2, 3, False), (6, 2, 4, False), (6, 2, 5, True),
    (6, 2, 6, True), (6, 2, 8, True), (40, 10, 2, False), (40, 10, 3, False),
    (40, 10, 4, False), (40, 10, 5, False), (40, 10, 6, True),
    (40, 10, 8, True)])
def test_dense_experts_cut_follows_the_chip_readings(E, k, B, dense):
    assert db.dense_experts(B, E, k, torch.bfloat16) is dense
    # the tensor cores take bf16 at B >= 2 only
    assert not db.dense_experts(B, E, k, torch.float32)
    assert not db.dense_experts(1, E, k, torch.bfloat16)


# ---------------------------------------------------------------------------
# the B=1 chain's attention
# ---------------------------------------------------------------------------

def chain_attend(q, k, v, n_heads, threads=None):
    """csrc/decode_layer.cu chain_attention_kernel, one block a head: f32
    logits (q . k * hd^-0.5), their max, the exponentials and their sum;
    P.V by row groups (row s in group s mod groups, groups = threads /
    (hd / V), V values of 16 bytes), the groups' partials added in a tree
    (Q = threads / hd sums of every Q-th group, then the Q sums), divided
    by the sum at the end. 256 threads, 512 past 256 rows."""
    _, R, D = k.shape
    H, hd = n_heads, D // n_heads
    threads = threads or (256 if R <= 256 else 512)
    V = 16 // k.element_size()
    groups = threads // (hd // V)
    Q = threads // hd
    logits = torch.einsum("hd,shd->hs", q[0].view(H, hd).float(),
                          k[0].float().view(R, H, hd)) * hd ** -0.5
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    denom = e.sum(-1)
    vv = v[0].float().view(R, H, hd)
    part = torch.zeros(groups, H, hd)
    for g in range(groups):
        part[g] = torch.einsum("hs,shd->hd", e[:, g::groups], vv[g::groups])
    tmp = torch.stack([part[j::Q].sum(0) for j in range(Q)])
    return (tmp.sum(0) / denom[:, None]).reshape(1, D)


def test_chain_attention_layer_at_pos_150_matches_pallas(monkeypatch):
    """The deep 2.2 layer at pos 150 (151 self rows, 300 cross rows: 256
    and 512 threads a head) with the mirror in place of the plain
    attention."""
    cfg, _, _, params, pm = _model(max_seq_chord=160, max_seq_video=300)
    jl = jax_pack(params, cfg)[3]
    pl_ = dl.pack_decoder_layers(pm)[3]
    for pos, seed in ((150, 0), (159, 1), (40, 2)):
        got, pk, want, jk = _run_layer(cfg, jl, pl_, pos, seed,
                                       chain_attend, monkeypatch)
        _close_rel(got, want, B1_REL, f"pos {pos}")
        _close_rel(pk[pos], jk[pos], B1_REL, f"pos {pos} k row")


def _jax_gumbel(seed, T):
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (1, C.CHORD_END))))
    return np.stack(out)


@pytest.mark.parametrize("threads", [None, 512])
def test_chain_attention_generate_matches_jax_sampler(threads, monkeypatch):
    """generate_chords (the "ends" backend) with the mirror (256 threads a
    head, as the chain runs these short caches, or forced to 512), token
    for token against the JAX sampler."""
    cfg, jm, variables, params, pm = _model()
    r = np.random.default_rng(3)
    f = dict(semantic=r.standard_normal((1, L, 7)).astype(np.float32),
             key=np.ones((1, 1), np.float32),
             scene_offset=r.integers(0, 5, (1, L)).astype(np.float32),
             motion=r.standard_normal((1, L)).astype(np.float32),
             emotion=r.uniform(size=(1, L, 2)).astype(np.float32))
    primer = [5, 122, 66]
    P = len(primer)
    pr = np.asarray([primer], np.int32)
    roots = np.asarray([[1 + (p % 12) for p in primer]], np.int32)
    attrs = np.asarray([[p % 14 for p in primer]], np.int32)
    want = jax_generate(
        jm, variables, primer=jnp.asarray(pr),
        primer_root=jnp.asarray(roots), primer_attr=jnp.asarray(attrs),
        num_primer=P, rng=jax.random.PRNGKey(4),
        gcfg=JaxGenerateConfig(target_seq_length=L), temperature=0.9,
        fused="off", **f)
    monkeypatch.setattr(dl, "attend",
                        functools.partial(chain_attend, threads=threads))
    got = generate_chords(
        pm, primer=torch.from_numpy(pr), primer_root=torch.from_numpy(roots),
        primer_attr=torch.from_numpy(attrs), num_primer=P,
        gcfg=GenerateConfig(target_seq_length=L), temperature=0.9,
        _gumbel=torch.from_numpy(_jax_gumbel(4, L)),
        **{k: torch.from_numpy(v) for k, v in f.items()})
    for k in ("gen_seq", "gen_seq_root", "gen_seq_attr"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
