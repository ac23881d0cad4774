"""The port's int8 decode paths against the JAX package (CPU, f32): int8 KV
caches on the batched V2 step (``kv_quant="int8"``: ``quantize_kv_rows``,
the int8 caches, the int8-KV ``batched_layer_step`` against the Pallas
kernel in interpret mode, the batched step under teacher forcing,
``generate_chords`` and ``Video2music.generate_batch``), int8 weights of
the variant wirings (the 3.1 / 3.2 int8 packs, the int8
``decode_variant_layer_step`` against the Pallas kernel, ``generate_chords``
and ``Video2music.generate``), the ``kv_quant`` guards, and the two repairs
of this slice: a B=1 decode of more than 16 layers ("stack", "monolith",
``split=False``) and ``fake_quantize_decoder_params`` on the variant
wirings.

int8 values of the two sides may differ by one quantum where a float lies
on a rounding boundary (the two frameworks sum in other orders):
:func:`_same_int8` holds such elements within one quantum and requires
them rare; every float keeps the tolerance of tests/test_torch_stack.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import video2music_tpu.pipeline.api as jax_api
from video2music_tpu.core import constants as C
from video2music_tpu.core.config import amt_config
from video2music_tpu.decode import fused as jax_fused
from video2music_tpu.decode.sampler import GenerateConfig as JaxGenerateConfig
from video2music_tpu.decode.sampler import generate_chords as jax_generate
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops import pallas_decode as jpd
from video2music_tpu.ops import pallas_decode_batch as jpb
from video2music_tpu.ops import pallas_decode_variant as jpv
from video2music_tpu.pipeline import Video2music as JaxVideo2music
from video2music_tpu_torch.core.config import amt_config as port_amt_config
from video2music_tpu_torch.decode import fused
from video2music_tpu_torch.decode.sampler import (GenerateConfig,
                                                  generate_chords)
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops import decode_batch as db
from video2music_tpu_torch.ops import decode_layer as dl
from video2music_tpu_torch.ops import decode_variant as dv
from video2music_tpu_torch.ops.embeddings import rope_table
from video2music_tpu_torch.pipeline import Video2music
from video2music_tpu_torch.weights import (amt_from_jax, init_weights_,
                                           regression_from_jax)

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5
L = 12  # max_seq_video == max_seq_chord of the tiny models
B = 3
# at most this share of an int8 tensor may sit one quantum away
QUANTUM_SHARE = 1 / 64


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _same_int8(got, want, msg=""):
    """int8 values equal, but for rare elements one quantum apart: a float
    on a rounding boundary of x / s that the two frameworks' sums put on
    either side."""
    got = np.asarray(got, np.int32)
    want = np.asarray(want, np.int32)
    assert got.shape == want.shape, msg
    d = np.abs(got - want)
    assert d.max(initial=0) <= 1, f"{msg}: {d.max()} quanta apart"
    assert (d > 0).mean() <= QUANTUM_SHARE, \
        f"{msg}: {(d > 0).sum()} of {d.size} one quantum apart"


def _features(r, n):
    return dict(
        semantic=r.standard_normal((n, L, 7)).astype(np.float32),
        key=np.asarray([[1.0], [0.0], [1.0], [0.0]][:n], np.float32),
        scene_offset=r.integers(0, 5, (n, L)).astype(np.float32),
        motion=r.standard_normal((n, L)).astype(np.float32),
        emotion=r.uniform(size=(n, L, 2)).astype(np.float32))


def _tiny_cfg(version, factory=amt_config, n_layers=4):
    """A tiny config; a deeper one keeps one encoder layer (only the
    decoder's depth matters here)."""
    cfg = factory(version, n_layers=n_layers, num_heads=2, d_model=16,
                  d_ff=32, max_seq_video=L, max_seq_chord=L,
                  total_vf_dim=7 + 1 + 1 + 2, dropout=0.0)
    if n_layers > 4:
        cfg = dataclasses.replace(cfg, encoder_layers=cfg.encoder_layers[:1])
    return cfg


def _pair(version, n, seed=0, n_layers=4):
    """A tiny AMT in JAX and the port with the same bridged weights, and n
    clips' features."""
    cfg = _tiny_cfg(version, n_layers=n_layers)
    feats = _features(np.random.default_rng(seed), n)
    jm = JaxAMT(cfg=cfg)
    z = jnp.zeros((1, L - 1), jnp.int32)
    variables = jm.init(
        {"params": jax.random.PRNGKey(1)}, z, z, z, feats["semantic"][:1],
        feats["key"][:1], feats["scene_offset"][:1], feats["motion"][:1],
        feats["emotion"][:1])
    pm = VideoMusicTransformer(_tiny_cfg(version, port_amt_config,
                                         n_layers)).eval()
    pm.load_state_dict(amt_from_jax(jax.device_get(variables["params"]),
                                    variables.get("moe_state")))
    memory, _ = jm.apply(variables, feats["semantic"], feats["scene_offset"],
                         feats["motion"], feats["emotion"], method=jm.encode,
                         mutable=["metrics", "moe_state"])
    _, primed = jm.apply(variables, memory, method=jm.prime,
                         mutable=["cache"])
    return dict(cfg=cfg, jm=jm, variables=variables, pm=pm, feats=feats,
                t={k: torch.from_numpy(v) for k, v in feats.items()},
                cross=primed["cache"])


@pytest.fixture(scope="module")
def v22():
    """Tiny 2.2 (4 decoder layers: 3 SwiGLU + 1 SharedMoE), B=4 clips."""
    return _pair("2.2", 4)


@pytest.fixture(scope="module", params=["3.1", "3.2"])
def v3(request):
    """Tiny 3.1 / 3.2 (differential attention, RMSNorm; pre-norm for 3.2),
    B=3 clips."""
    return dict(_pair(request.param, B), version=request.param)


def _lanes(a):  # flax cache (B, H, S, hd) -> (B, S, H*hd)
    a = np.asarray(a)
    return a.transpose(0, 2, 1, 3).reshape(a.shape[0], a.shape[2], -1)


def _rope(cfg):
    t = rope_table(L, cfg.d_model // cfg.num_heads, "cpu")
    return t[..., 0].contiguous(), t[..., 1].contiguous()


def _jax_gumbel(seed, T, n):
    """The noise jax.random.categorical draws in the JAX sampler's loop."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (n, C.CHORD_END))))
    return np.stack(out)


def _sampler_inputs(m, n):
    """The features of the first n clips, their primers (ids, roots,
    attrs) and primer lengths, as numpy arrays."""
    primer = np.asarray([[5, 122, 66], [1, 40, 0], [17, 3, 9]][:n], np.int32)
    return dict({k: v[:n] for k, v in m["feats"].items()}, primer=primer,
                primer_root=(1 + primer % 12).astype(np.int32),
                primer_attr=(primer % 14).astype(np.int32),
                num_primer=np.asarray([2, 1, 3][:n], np.int32))


def _jax_generate(m, n, seed=4, **kw):
    return jax_generate(
        m["jm"], m["variables"], rng=jax.random.PRNGKey(seed),
        gcfg=JaxGenerateConfig(target_seq_length=L), temperature=0.8,
        **{k: jnp.asarray(v) for k, v in _sampler_inputs(m, n).items()},
        **kw)


def _port_generate(m, n, seed=4, **kw):
    """The port's generate_chords with the JAX sampler's noise handed in."""
    return generate_chords(
        m["pm"], gcfg=GenerateConfig(target_seq_length=L), temperature=0.8,
        _gumbel=torch.from_numpy(_jax_gumbel(seed, L, n)),
        **{k: torch.from_numpy(v) for k, v in _sampler_inputs(m, n).items()},
        **kw)


def _generate_both(m, n, jax_kw, port_kw):
    """generate_chords of the JAX sampler and the port on the first n
    clips: (JAX out, port out)."""
    return _jax_generate(m, n, **jax_kw), _port_generate(m, n, **port_kw)


def _same_tokens(got, want, msg=""):
    for k in ("gen_seq", "gen_seq_root", "gen_seq_attr"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{msg} {k}")


# ---------------------------------------------------------------------------
# int8 KV caches (kv_quant="int8") on the batched V2 step
# ---------------------------------------------------------------------------

def test_quantize_kv_rows_matches_jax_bit_for_bit():
    """Random rows, an all-zero row (scale 1), and exact .5 ties of x / s,
    which both round half to even."""
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 9, 16)).astype(np.float32)
    x[1, 3] = 0.0
    # max 127 -> s = 1: the row's quotients are the values themselves
    x[0, 0] = np.concatenate([[127.0], np.arange(-7.5, 7.5, 1.0)])[:16]
    x[0, 1] = np.asarray([-127.0] + [0.5, 1.5, 2.5, -0.5, -1.5, -2.5] * 2
                         + [126.5, -126.5, 3.5], np.float32)
    jq, js = jpb.quantize_kv_rows(jnp.asarray(x))
    q, s = db.quantize_kv_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.shape == (2, 9, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s[1, 3] == 1.0).all() and (q[1, 3] == 0).all()
    assert q[0, 1, 1:7].tolist() == [0, 2, 2, 0, -2, -2]


def test_init_fused_batch_caches_int8_match_jax(v22):
    m = v22
    with torch.no_grad():
        t = m["t"]
        cross = m["pm"].prime(m["pm"].encode(t["semantic"], t["scene_offset"],
                                             t["motion"], t["emotion"]))
        got = fused.init_fused_batch_caches(m["pm"], cross, kv_quant="int8")
    want = jax_fused.init_fused_batch_caches(
        m["variables"]["params"], m["cfg"], 4, m["cross"], kv_quant="int8")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k]
        assert tuple(g.shape) == v.shape, k
        if v.dtype == jnp.int8:
            assert g.dtype == torch.int8, k
            _same_int8(g, v, k)
        else:
            _close(g, v, k)
    assert (got["k0"] == 0).all() and (got["ksc0"] == 0).all()


def _int8_caches(r, n, S, D):
    """Random caches quantized as the step leaves them: (int8, scales)."""
    return jpb.quantize_kv_rows(
        jnp.asarray(r.standard_normal((n, S, D)).astype(np.float32)))


@pytest.mark.parametrize("case", ["shallow+embed", "shallow", "deep",
                                  "deep, segmented form"])
def test_int8_kv_batched_layer_step_matches_pallas(v22, case):
    """The plain int8-KV step against the Pallas kernel (interpret mode, its
    default wide form, and the segmented form once): the output, and the
    int8 K/V rows and scales written at pos; the rest of the caches stay."""
    m = v22
    cfg = m["cfg"]
    D, H, n = cfg.d_model, cfg.num_heads, 4
    i = 3 if case.startswith("deep") else 0
    embed = case == "shallow+embed"
    jl = jpd.pack_decoder_layers(m["variables"]["params"], cfg)[i]
    pl_ = dl.pack_decoder_layers(m["pm"])[i]
    r = np.random.default_rng(10 + len(case))
    (kc, ks), (vc, vs) = _int8_caches(r, n, L, D), _int8_caches(r, n, L, D)
    cc = m["cross"][f"dec_{i}"]["cross_attn"]
    kx, kxs = jpb.quantize_kv_rows(jnp.asarray(_lanes(cc["k"])))
    vx, vxs = jpb.quantize_kv_rows(jnp.asarray(_lanes(cc["v"])))
    t = lambda a: torch.from_numpy(np.array(a))
    pk, pv, pks, pvs = t(kc), t(vc), t(ks), t(vs)
    embed_pack = None
    if embed:
        p = m["variables"]["params"]
        lc_w = p["Linear_chord"]["kernel"]
        embed_pack = {"emb_root": p["embedding_root"]["embedding"],
                      "emb_attr": p["embedding_attr"]["embedding"],
                      "lc_w": lc_w[:D], "lc_krow": lc_w[D:D + 1],
                      "lc_b": p["Linear_chord"]["bias"].reshape(1, -1)}
    for pos in (0, 5, L - 1):
        x = r.standard_normal((n, D)).astype(np.float32)
        roots, attrs = r.integers(0, 13, n), r.integers(0, 14, n)
        keys = np.asarray([1.0, 0.0, 0.0, 1.0], np.float32)
        before = pk.clone(), pv.clone()
        want, k_row, v_row, ks_row, vs_row = jpb.batched_layer_step(
            None if embed else jnp.asarray(x), pos, jl,
            jnp.asarray(pk.numpy()), jnp.asarray(pv.numpy()), kx, vx,
            n_heads=H, rope=True, block_b=2, interpret=True,
            wide=not case.endswith("form"),
            tokens=((jnp.asarray(roots), jnp.asarray(attrs),
                     jnp.asarray(keys)) if embed else None),
            embed_pack=embed_pack,
            kv_scales=(jnp.asarray(pks.numpy()), jnp.asarray(pvs.numpy()),
                       kxs, vxs))
        got = db.batched_layer_step(
            None if embed else torch.from_numpy(x), pos, pl_, pk, pv, t(kx),
            t(vx), n_heads=H, rope=_rope(cfg),
            tokens=((torch.from_numpy(roots), torch.from_numpy(attrs),
                     torch.from_numpy(keys)) if embed else None),
            embed_pack=dl.pack_ends(m["pm"]) if embed else None,
            kv_scales=(pks, pvs, t(kxs), t(vxs)))
        msg = f"{case} pos {pos}"
        assert got.shape == (n, D) and got.dtype == torch.float32
        _close(got, want, msg)
        _same_int8(pk[:, pos], k_row, msg + " k row")
        _same_int8(pv[:, pos], v_row, msg + " v row")
        _close(pks[:, pos], ks_row, msg + " k scale")
        _close(pvs[:, pos], vs_row, msg + " v scale")
        others = [j for j in range(L) if j != pos]
        assert torch.equal(pk[:, others], before[0][:, others]), msg
        assert torch.equal(pv[:, others], before[1][:, others]), msg


@pytest.mark.parametrize("ends", [True, False])
def test_int8_kv_batch_step_matches_jax_step(v22, ends):
    """8 teacher-forced steps of the batched step on int8 caches against
    the JAX make_fused_batch_step(kv_quant="int8") (Pallas interpret mode):
    the logits, and the caches both steps append to."""
    m = v22
    n = 4
    r = np.random.default_rng(5)
    roots, attrs = r.integers(0, 13, (8, n)), r.integers(0, 14, (8, n))
    params = m["variables"]["params"]
    jstep = jax.jit(jax_fused.make_fused_batch_step(
        params, m["cfg"], block_b=2, interpret=True, ends=ends,
        kv_quant="int8"))
    jc = jax_fused.init_fused_batch_caches(params, m["cfg"], n, m["cross"],
                                           kv_quant="int8")
    t = m["t"]
    with torch.no_grad():
        cross = m["pm"].prime(m["pm"].encode(t["semantic"], t["scene_offset"],
                                             t["motion"], t["emotion"]))
        pc = fused.init_fused_batch_caches(m["pm"], cross, kv_quant="int8")
        pstep = fused.make_fused_batch_step(m["pm"], ends=ends,
                                            kv_quant="int8")
        for pos in range(8):
            jr, ja = (jnp.asarray(v[pos][:, None], jnp.int32)
                      for v in (roots, attrs))
            want, jc = jstep(jc, jr, jr, ja, m["feats"]["key"],
                             jnp.asarray(pos, jnp.int32))
            got = pstep(pc, torch.from_numpy(roots[pos]),
                        torch.from_numpy(attrs[pos]), t["key"].reshape(-1),
                        pos)
            assert got.shape == (n, C.CHORD_SIZE)
            _close(got, want, f"ends={ends} pos {pos}")
    for k, v in jc.items():
        if v.dtype == jnp.int8:
            _same_int8(pc[k], v, k)
        else:
            _close(pc[k], v, k)


def test_generate_chords_kv_quant_b3_matches_jax_sampler(v22):
    """B=3 token for token against the JAX sampler's batched int8-KV kernels
    ("ends", Pallas interpret mode), the port on "auto"."""
    want, got = _generate_both(
        v22, B, dict(fused="ends", interpret=True, kv_quant="int8"),
        dict(kv_quant="int8"))
    _same_tokens(got, want)


@pytest.mark.parametrize("case", ["bad value", "with quantize", "B=1",
                                  "variant at B>1"])
def test_kv_quant_guards(v22, case):
    """The JAX sampler's semantics: a value other than None / "int8" and
    kv_quant with quantize raise ValueError; at B=1 kv_quant is ignored; a
    variant wiring at B>1 warns and decodes with full-precision caches."""
    p = torch.ones(B, 2, dtype=torch.int32)
    kw = dict(primer_root=p, primer_attr=p, num_primer=2,
              gcfg=GenerateConfig(target_seq_length=L))
    if case in ("bad value", "with quantize"):
        bad = dict(kv_quant="int4") if case == "bad value" else dict(
            kv_quant="int8", quantize="int8")
        f = {k: v[:1] for k, v in v22["t"].items()}
        with pytest.raises(ValueError, match="kv_quant"):
            generate_chords(v22["pm"], primer=p[:1], **dict(
                kw, primer_root=p[:1], primer_attr=p[:1]), **bad, **f)
        return
    if case == "B=1":
        model, n = v22["pm"], 1
        f = {k: v[:1] for k, v in v22["t"].items()}
    else:
        model, n = init_weights_(
            VideoMusicTransformer(_tiny_cfg("3.1", port_amt_config)),
            torch.Generator().manual_seed(0)).eval(), B
        f = {k: v[:B] for k, v in v22["t"].items()}
    kw.update(primer=p[:n], primer_root=p[:n], primer_attr=p[:n])
    noise = torch.from_numpy(_jax_gumbel(2, L, n))
    plain = generate_chords(model, _gumbel=noise, **kw, **f)
    if n == 1:
        got = generate_chords(model, _gumbel=noise, kv_quant="int8", **kw,
                              **f)
    else:
        with pytest.warns(UserWarning, match="full-precision KV"):
            got = generate_chords(model, _gumbel=noise, kv_quant="int8",
                                  **kw, **f)
    _same_tokens(got, plain, case)


# ---------------------------------------------------------------------------
# int8 weights of the variant wirings (3.x quantize="int8")
# ---------------------------------------------------------------------------

_T = ("wqkv", "wo", "cwq", "cwo", "fw1g", "fw2", "sw1g", "sw2", "gate_w")
_EXPERT = ("ew1g", "ew2")


def _port_variant_layer(jl):
    """A JAX variant pack in the port's layout, int8 weights kept int8:
    weights (out, in), expert stacks (E, out, in), rows and scale rows as
    vectors, expert scales (E, out), norms and er as they are."""
    out = {}
    for k, v in jl.items():
        a = np.array(v)
        if k in _T:
            a = a.T
        elif k in _EXPERT:
            a = a.transpose(0, 2, 1)
        elif k not in ("norm_scale", "norm_bias", "er", "eb1g", "eb2",
                       "ew1g_s", "ew2_s"):
            a = a.reshape(-1)
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def test_pack_variant_layers_int8_match_jax(v3):
    """The int8 packs of 3.1 and 3.2, bit for bit: every QUANT_KEYS weight
    int8 with its f32 row scales; the rest as the float pack."""
    m = v3
    jl, jmetas = jpv.pack_variant_layers(m["variables"]["params"], m["cfg"],
                                         quantize="int8")
    pl_, metas = dv.pack_variant_layers(m["pm"], quantize="int8")
    assert [dataclasses.asdict(a) for a in metas] == \
        [dataclasses.asdict(b) for b in jmetas]
    assert dv.QUANT_KEYS == jpv.QUANT_KEYS
    for i, (p, j) in enumerate(zip(pl_, jl)):
        want = _port_variant_layer(j)
        assert sorted(p) == sorted(want), i
        for k, v in want.items():
            assert p[k].shape == v.shape and p[k].dtype == v.dtype, (i, k)
            if k in dv.QUANT_KEYS or k.endswith("_s"):
                assert torch.equal(p[k], v), f"layer {i} {k}"
            else:
                _close(p[k], v, f"layer {i} {k}")
        assert p["wqkv"].dtype == torch.int8


@pytest.mark.parametrize("layer_idx", [1, 3])  # shallow SwiGLU / deep MoE
def test_int8_decode_variant_layer_matches_pallas(v3, layer_idx):
    """The plain int8 variant layer against the Pallas kernel (interpret
    mode) on the same int8 pack: the output and the written caches."""
    m = v3
    cfg = m["cfg"]
    D, H = cfg.d_model, cfg.num_heads
    jls, jmetas = jpv.pack_variant_layers(m["variables"]["params"], cfg,
                                          quantize="int8")
    jl, jmeta = jls[layer_idx], jmetas[layer_idx]
    meta = dv.VariantLayerMeta(**dataclasses.asdict(jmeta))
    pl_ = _port_variant_layer(jl)
    kw = dict(n_heads=H, k_top=cfg.moe.n_experts_per_token, norm=cfg.norm,
              pre_norm=cfg.pre_norm)
    r = np.random.default_rng(30 + layer_idx)
    n = lambda *shape: r.standard_normal(shape).astype(np.float32)
    kc, vc, kx, vx = n(L, 2 * D), n(L, D), n(L, 2 * D), n(L, D)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    for pos in (0, 5, L - 1):
        x = n(1, D)
        want, jk, jv = jpv.decode_variant_layer_step(
            jnp.asarray(x), pos, jl, jmeta, jk, jv, jnp.asarray(kx),
            jnp.asarray(vx), rope=True, interpret=True, **kw)
        got = dv.decode_variant_layer_step(
            torch.from_numpy(x), pos, pl_, meta, pk, pv, torch.from_numpy(kx),
            torch.from_numpy(vx), rope=_rope(cfg), **kw)
        msg = f"V{m['version']} layer {layer_idx} pos {pos}"
        _close(got, want, msg)
        _close(pk, jk, msg + " k cache")
        _close(pv, jv, msg + " v cache")


@pytest.mark.parametrize("mode", ["B=1", "B=3", "off"])
def test_generate_chords_int8_variant_matches_jax_sampler(v3, mode):
    """3.1 / 3.2 quantize="int8" token for token against the JAX sampler: at
    B=1 both on their int8 variant kernels (JAX: Pallas interpret mode), at
    B=3 and with fused="off" both on the plain step with fake-quantized
    weights."""
    n = B if mode == "B=3" else 1
    jax_kw = dict(quantize="int8", fused="off")
    port_kw = dict(quantize="int8", fused="off" if mode == "off" else "auto")
    if mode == "B=1":
        jax_kw.update(fused="on", interpret=True)
    want, got = _generate_both(v3, n, jax_kw, port_kw)
    _same_tokens(got, want, f"V{v3['version']} {mode}")


def test_fake_quantize_decoder_params_matches_jax_on_v3(v3):
    """Parameter by parameter, bit for bit, on bridged 3.1 / 3.2 weights: the
    differential query rows (2D of them in the cross-attention too), the
    out-projections, the SwiGLU, the experts and the shared expert go
    through int8; the lambda, subln, norms and gate stay."""
    m = v3
    want = amt_from_jax(jax.device_get(jpd.fake_quantize_decoder_params(
        m["variables"]["params"], m["cfg"])), m["variables"].get("moe_state"))
    got = dl.fake_quantize_decoder_params(m["pm"]).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    D = m["cfg"].d_model
    w = got["decoder_layers.0.cross_attn.in_proj.weight"][D:2 * D]
    assert not torch.equal(
        w, m["pm"].state_dict()["decoder_layers.0.cross_attn.in_proj.weight"]
        [D:2 * D])


# ---------------------------------------------------------------------------
# the pipeline: Video2music at 2.2 (kv_quant) and 3.1 (quantize)
# ---------------------------------------------------------------------------

PIPE = dict(reg_model="bimamba+", motion_type=0,
            amt_overrides=dict(n_layers=3, num_heads=2, d_model=16, d_ff=32),
            reg_overrides=dict(n_layers=1, d_model=8, d_hidden=16))
T = 300


def _pipe_features(n_sec, seed):
    r = np.random.default_rng(seed)
    return {"semantic": r.standard_normal((n_sec, 768)).astype(np.float32),
            "emotion": r.uniform(size=(n_sec, 6)).astype(np.float32),
            "scene_offset": np.arange(n_sec, dtype=np.float32),
            "motion": r.standard_normal((n_sec,)).astype(np.float32)}


def _pipelines(version):
    jv = JaxVideo2music(music_gen_version=version, **PIPE)
    pv = Video2music(device="cpu", music_gen_version=version, **PIPE)
    pv.load_state_dicts(
        amt_from_jax(jax.device_get(jv.variables["params"]),
                     jv.variables.get("moe_state")),
        regression_from_jax(jax.device_get(jv.reg_variables["params"])))
    return jv, pv


def test_generate_batch_kv_quant_matches_jax_pipeline(monkeypatch, tmp_path):
    """2.2 ``generate_batch(kv_quant="int8")`` at B=3, chord for chord. On
    the CPU the JAX pipeline's "auto" decodes on the XLA step, which has no
    int8 caches; it is run on its batched int8-KV kernels ("ends", Pallas
    interpret mode) instead, the port on its "auto" step."""
    monkeypatch.setattr(jax_api, "generate_chords", functools.partial(
        jax_generate, fused="ends", interpret=True))
    jv, pv = _pipelines("2.2")
    reqs = lambda: [dict(features=_pipe_features(24, 5), primer="C Am",
                         key="C major"),
                    dict(features=_pipe_features(10, 6), primer=""),
                    dict(features=_pipe_features(40, 7), primer="G Em C D")]
    kw = dict(temperature=[0.9, 1.0, 1.1], seed=3, compute_dtype="float32",
              kv_quant="int8")
    want = jv.generate_batch(reqs(), output_dir=str(tmp_path / "jax"), **kw)
    got = pv.generate_batch(reqs(), output_dir=str(tmp_path / "port"),
                            _gumbel=torch.from_numpy(_jax_gumbel(3, T, 3)),
                            **kw)
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.chord_ids, w.chord_ids,
                                      err_msg=f"clip {i}")
        assert g.chords == w.chords and g.key == w.key


def test_generate_int8_v31_matches_jax_pipeline(tmp_path):
    """3.1 ``generate(quantize="int8")``: the port's int8 variant step
    against the JAX pipeline (on the CPU its fake-quantized XLA step),
    chord for chord."""
    jv, pv = _pipelines("3.1")
    kw = dict(primer="Am F", features=_pipe_features(20, 6), seed=2,
              temperature=1.0, compute_dtype="float32", quantize="int8")
    want = jv.generate(output_dir=str(tmp_path / "jax"), **kw)
    got = pv.generate(output_dir=str(tmp_path / "port"),
                      _gumbel=torch.from_numpy(_jax_gumbel(2, T, 1)), **kw)
    np.testing.assert_array_equal(got.chord_ids, want.chord_ids)
    assert got.chords == want.chords


# ---------------------------------------------------------------------------
# repair: B=1 decode runs of more than 16 layers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deep22():
    """Tiny 2.2 with 20 decoder layers (3 SwiGLU + a 17-layer MoE segment)
    and the JAX sampler's tokens for one clip on its "stack" backend
    (Pallas interpret mode; the JAX backends agree token for token)."""
    m = _pair("2.2", 1, n_layers=20)
    return dict(m, want=_jax_generate(m, 1, fused="stack", interpret=True))


@pytest.mark.parametrize("fused_mode,split,wrapper,runs", [
    ("stack", True, "decode_segment_step", 3),
    ("monolith", True, "decode_monolith_step", 2),
    ("auto", False, "decode_flat_monolith_step", 2)])
def test_deep_b1_backends_chunk_and_match_jax_sampler(deep22, monkeypatch,
                                                      fused_mode, split,
                                                      wrapper, runs):
    """"stack" (segments of 3 and 17 layers: 3 runs a step), "monolith" and
    the one-launch "ends" step (split=False) (2 runs a step) call their
    wrapper once per run of at most 16 layers, and match the JAX sampler
    token for token."""
    calls = []
    wrapped = getattr(fused, wrapper)

    def counted(*args, **kwargs):
        calls.append(wrapper)
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(fused, wrapper, counted)
    got = _port_generate(deep22, 1, fused=fused_mode, split=split)
    _same_tokens(got, deep22["want"], fused_mode)
    assert len(calls) == runs * (L - 1)
