"""The port's B=1 decode backends against the JAX package (CPU, f32): the
stack / monolith packs and the int8 packs against the JAX packs, the plain
segment / monolith / flat-run / int8 layer steps against the Pallas kernels
in interpret mode, every backend's step against the flax decode_step under
teacher forcing, and generate_chords token for token against the JAX
sampler for every ``fused`` value and ``quantize="int8"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video2music_tpu.core import constants as C
from video2music_tpu.core.config import amt_config
from video2music_tpu.decode.sampler import GenerateConfig as JaxGenerateConfig
from video2music_tpu.decode.sampler import generate_chords as jax_generate
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops import pallas_decode as jpd
from video2music_tpu.ops import pallas_decode_stack as jps
from video2music_tpu_torch.core.config import amt_config as port_amt_config
from video2music_tpu_torch.decode import fused
from video2music_tpu_torch.decode.sampler import (GenerateConfig,
                                                  generate_chords)
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops import decode_layer as dl
from video2music_tpu_torch.ops import decode_stack as ds
from video2music_tpu_torch.ops.embeddings import rope_table
from video2music_tpu_torch.weights import amt_from_jax, init_weights_

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5
L = 12  # max_seq_video == max_seq_chord of the tiny model
B = 3


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


@pytest.fixture(scope="module")
def models():
    """Tiny AMT 2.2 (6 decoder layers: 3 SwiGLU + 3 SharedMoE, so a MoE
    segment holds several layers) in JAX and the port with the same
    bridged weights, B=3 features, and the primed state of clip 0."""
    cfg = amt_config("2.2", n_layers=6, num_heads=2, d_model=16, d_ff=32,
                     max_seq_video=L, max_seq_chord=L,
                     total_vf_dim=7 + 1 + 1 + 2, dropout=0.0)
    r = np.random.default_rng(0)
    feats = dict(
        semantic=r.standard_normal((B, L, 7)).astype(np.float32),
        key=np.asarray([[1.0], [0.0], [1.0]], np.float32),
        scene_offset=r.integers(0, 5, (B, L)).astype(np.float32),
        motion=r.standard_normal((B, L)).astype(np.float32),
        emotion=r.uniform(size=(B, L, 2)).astype(np.float32))
    one = {k: v[:1] for k, v in feats.items()}
    jm = JaxAMT(cfg=cfg)
    z = jnp.zeros((1, L - 1), jnp.int32)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, z, z, z,
                        one["semantic"], one["key"], one["scene_offset"],
                        one["motion"], one["emotion"])
    params = jax.device_get(variables["params"])
    pm = VideoMusicTransformer(cfg).eval()
    pm.load_state_dict(amt_from_jax(params))
    memory, _ = jm.apply(variables, one["semantic"], one["scene_offset"],
                         one["motion"], one["emotion"], method=jm.encode,
                         mutable=["metrics", "moe_state"])
    _, primed = jm.apply(variables, memory, method=jm.prime,
                         mutable=["cache"])
    return dict(cfg=cfg, jm=jm, variables=variables, params=params, pm=pm,
                feats=feats, one=one, cross=primed["cache"])


def _lanes(a):  # flax cache (1, H, S, hd) -> (S, H*hd)
    a = np.asarray(a)[0]
    return a.transpose(1, 0, 2).reshape(a.shape[1], -1)


def _cross(m, i):
    cc = m["cross"][f"dec_{i}"]["cross_attn"]
    return _lanes(cc["k"]), _lanes(cc["v"])


def _rope(cfg):
    t = rope_table(L, cfg.d_model // cfg.num_heads, "cpu")
    return t[..., 0].contiguous(), t[..., 1].contiguous()


def _kw(cfg):
    return dict(n_heads=cfg.num_heads, k_top=2, rope=_rope(cfg))


def _jkw(cfg):
    return dict(n_heads=cfg.num_heads, k_top=2, rope=True, interpret=True)


def _as_port(jl):
    """A JAX per-layer pack in the port's keys and (out, in) layout."""
    deep = "gate_w" in jl
    names = dict(wqkv="wqkv", bqkv="bqkv", wo="wo", bo="bo", cwq="cwq",
                 cbq="cbq", cwo="cwo", cbo="cbo", norm_scale="norm_scale",
                 norm_bias="norm_bias")
    names.update(dict(w1g="sw1g", b1g="sb1g", w2="sw2", b2="sb2",
                      gate_w="gate_w", gate_b="gate_b", ew1g="ew1g",
                      eb1g="eb1g", ew2="ew2", eb2="eb2") if deep else
                 dict(w1g="fw1g", b1g="fb1g", w2="fw2", b2="fb2"))
    out = {}
    for pk, jk in names.items():
        for sfx in ("", "_s"):
            if jk + sfx not in jl:
                continue
            a = np.asarray(jl[jk + sfx])
            if pk in ("norm_scale", "norm_bias", "eb1g", "eb2"):
                pass
            elif sfx == "_s":
                a = a if pk in ("ew1g", "ew2") else a.reshape(-1)
            elif a.ndim == 3:
                a = a.transpose(0, 2, 1)
            elif a.shape[0] == 1:
                a = a.reshape(-1)
            else:
                a = a.T
            out[pk + sfx] = a
    return out


def _assert_pack(port, jl, exact=False, msg=""):
    want = _as_port(jl)
    assert sorted(port) == sorted(want), msg
    for k, v in want.items():
        got = port[k].numpy()
        assert got.shape == v.shape and got.dtype == v.dtype, f"{msg} {k}"
        if exact:
            np.testing.assert_array_equal(got, v, err_msg=f"{msg} {k}")
        else:
            _close(got, v, f"{msg} {k}")


def _unstack(stacked, j, E):
    out = {}
    for k, v in stacked.items():
        if k == "kind":
            continue
        out[k] = v[j * E:(j + 1) * E] if k in ("ew1g", "ew2") else v[j]
    return out


def test_pack_decoder_segments_matches_jax(models):
    m = models
    E = m["cfg"].moe.n_experts
    jsegs = jps.pack_decoder_segments(m["params"], m["cfg"])
    psegs = ds.pack_decoder_segments(m["pm"])
    assert [s["kind"] for s in psegs] == [s["kind"] for s in jsegs]
    assert ds.decoder_segments(m["pm"].cfg) == jps.decoder_segments(m["cfg"])
    for s, (jseg, pseg) in enumerate(zip(jsegs, psegs)):
        for j, layer in enumerate(pseg["layers"]):
            _assert_pack(layer, _unstack(jseg, j, E), msg=f"seg {s} layer {j}")


def test_pack_monolith_matches_jax(models):
    m = models
    cfg = m["cfg"]
    E = cfg.moe.n_experts
    jp = jps.pack_monolith(m["params"], cfg)
    pp = ds.pack_monolith(m["pm"])
    si = di = 0
    for i, spec in enumerate(cfg.decoder_layers):
        jl = {k: jp[k][i] for k in jps._ATTN_KEYS}
        if spec.ffn == "moe":
            jl.update({k: jp[k][di] for k in jps._DEEP_KEYS
                       if k not in ("ew1g", "ew2")})
            jl.update({k: jp[k][di * E:(di + 1) * E] for k in ("ew1g", "ew2")})
            di += 1
        else:
            jl.update({k: jp[k][si] for k in jps._SHALLOW_KEYS})
            si += 1
        _assert_pack(pp["layers"][i], jl, msg=f"layer {i}")
    for k in ("emb_root", "emb_attr"):
        _close(pp[k], jp[k], k)
    for k in ("lc_w", "wout"):
        _close(pp[k].T, jp[k], k)
    for k in ("lc_krow", "lc_b", "dn_scale", "dn_bias", "bout"):
        _close(pp[k], np.asarray(jp[k]).reshape(-1), k)


def test_int8_packs_match_jax_bit_for_bit(models):
    m = models
    jl = jpd.pack_decoder_layers(m["params"], m["cfg"], quantize="int8")
    pl_ = dl.pack_decoder_layers(m["pm"], quantize="int8")
    for i, (p, j) in enumerate(zip(pl_, jl)):
        _assert_pack(p, j, exact=True, msg=f"layer {i}")
    assert pl_[0]["wqkv"].dtype == torch.int8
    assert pl_[-1]["ew2_s"].dtype == torch.float32


def test_quantize_roundtrip_and_fake_quant_match_jax(models):
    m = models
    w = np.random.default_rng(5).standard_normal((24, 40)).astype(np.float32)
    jq, js = jpd.quantize_weight(jnp.asarray(w.T))
    q, s = dl.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(-1))
    np.testing.assert_array_equal(dl.dequantize(q, s).numpy(),
                                  np.asarray(jpd.dequantize(jq, js)).T)
    want = amt_from_jax(jax.device_get(
        jpd.fake_quantize_decoder_params(m["params"], m["cfg"])))
    got = dl.fake_quantize_decoder_params(m["pm"]).state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


def _stack_caches(m, seg, r):
    D = m["cfg"].d_model
    n = len(seg)
    kc, vc = (r.standard_normal((n, L, D)).astype(np.float32)
              for _ in range(2))
    kx = np.stack([_cross(m, i)[0] for i in seg])
    vx = np.stack([_cross(m, i)[1] for i in seg])
    return kc, vc, kx, vx


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("kind", ["swiglu", "moe"])
def test_segment_step_matches_pallas_kernel(models, kind, resident):
    m = models
    cfg = m["cfg"]
    s = 0 if kind == "swiglu" else 1
    jseg = jps.pack_decoder_segments(m["params"], cfg)[s]
    pseg = ds.pack_decoder_segments(m["pm"])[s]
    r = np.random.default_rng(11 + s)
    kc, vc, kx, vx = _stack_caches(m, jps.decoder_segments(cfg)[s]["layers"],
                                   r)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    for pos in (0, 4, L - 1):
        x = r.standard_normal((1, cfg.d_model)).astype(np.float32)
        want, jk, jv = jps.decode_segment_step(
            jnp.asarray(x), pos, jseg, jk, jv, jnp.asarray(kx),
            jnp.asarray(vx), resident=resident, **_jkw(cfg))
        got = ds.decode_segment_step(
            torch.from_numpy(x), pos, pseg, pk, pv, torch.from_numpy(kx),
            torch.from_numpy(vx), resident=resident, **_kw(cfg))
        _close(got, want, f"y pos={pos}")
        _close(pk, jk, f"k caches pos={pos}")
        _close(pv, jv, f"v caches pos={pos}")


def test_monolith_step_matches_pallas_kernel(models):
    m = models
    cfg = m["cfg"]
    kinds = tuple(spec.ffn for spec in cfg.decoder_layers)
    r = np.random.default_rng(21)
    kc, vc, kx, vx = _stack_caches(m, range(len(kinds)), r)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    jp = jps.pack_monolith(m["params"], cfg)
    pp = ds.pack_monolith(m["pm"])
    for pos, root, attr, key in ((0, 1, 2, 1.0), (4, 5, 7, 0.0),
                                 (L - 1, 12, 13, 1.0)):
        want, jk, jv = jps.decode_monolith_step(
            jnp.asarray([root]), jnp.asarray([attr]), jnp.asarray([key]),
            pos, jp, jk, jv, jnp.asarray(kx), jnp.asarray(vx), kinds=kinds,
            **_jkw(cfg))
        got = ds.decode_monolith_step(
            torch.tensor([root]), torch.tensor([attr]), torch.tensor([key]),
            pos, pp, pk, pv, torch.from_numpy(kx), torch.from_numpy(vx),
            **_kw(cfg))
        assert got.shape == (1, C.CHORD_SIZE)
        _close(got, want, f"logits pos={pos}")
        _close(pk, jk, f"k caches pos={pos}")
        _close(pv, jv, f"v caches pos={pos}")


@pytest.mark.parametrize("run", ["all", "middle"])
def test_flat_monolith_matches_pallas_kernel(models, run):
    """All six layers with the embed and the head folded, and a two-layer
    middle run (a SwiGLU and a MoE layer) without either."""
    m = models
    cfg = m["cfg"]
    idx = list(range(6)) if run == "all" else [2, 3]
    kinds = tuple(cfg.decoder_layers[i].ffn for i in idx)
    ends = run == "all"
    r = np.random.default_rng(31)
    kc, vc, kx, vx = _stack_caches(m, idx, r)
    x = r.standard_normal((1, cfg.d_model)).astype(np.float32)
    pos, root, attr, key = 6, 3, 7, 1.0
    jlayers = jpd.pack_decoder_layers(m["params"], cfg)
    want, new = jps.decode_flat_monolith_step(
        jnp.asarray([root]), jnp.asarray([attr]), jnp.asarray([key]), pos,
        [jlayers[i] for i in idx], jps.pack_monolith(m["params"], cfg),
        [tuple(jnp.asarray(a[j]) for a in (kc, vc, kx, vx))
         for j in range(len(idx))], kinds=kinds, embed=ends, fold_head=ends,
        x=None if ends else jnp.asarray(x), **_jkw(cfg))
    players = dl.pack_decoder_layers(m["pm"])
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = ds.decode_flat_monolith_step(
        torch.tensor([root]), torch.tensor([attr]), torch.tensor([key]), pos,
        [players[i] for i in idx], dl.pack_ends(m["pm"]),
        [(pk[j], pv[j], torch.from_numpy(kx[j]), torch.from_numpy(vx[j]))
         for j in range(len(idx))], embed=ends, fold_head=ends,
        x=None if ends else torch.from_numpy(x), **_kw(cfg))
    assert got.shape == ((1, C.CHORD_SIZE) if ends else (1, cfg.d_model))
    _close(got, want, "output")
    for j, (nk, nv) in enumerate(new):
        _close(pk[j], nk, f"k cache {j}")
        _close(pv[j], nv, f"v cache {j}")


@pytest.mark.parametrize("layer_idx", [1, 4])  # shallow SwiGLU / deep MoE
def test_int8_layer_matches_pallas_kernel(models, layer_idx):
    m = models
    cfg = m["cfg"]
    jl = jpd.pack_decoder_layers(m["params"], cfg, quantize="int8")[layer_idx]
    pl_ = dl.pack_decoder_layers(m["pm"], quantize="int8")[layer_idx]
    r = np.random.default_rng(41 + layer_idx)
    kc, vc, kx, vx = (a[0] for a in _stack_caches(m, [layer_idx], r))
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    for pos in (0, 4, L - 1):
        x = r.standard_normal((1, cfg.d_model)).astype(np.float32)
        want, jk, jv = jpd.decode_layer_step(
            jnp.asarray(x), pos, jl, jk, jv, jnp.asarray(kx), jnp.asarray(vx),
            **_jkw(cfg))
        got = dl.decode_layer_step(torch.from_numpy(x), pos, pl_, pk, pv,
                                   torch.from_numpy(kx), torch.from_numpy(vx),
                                   **_kw(cfg))
        _close(got, want, f"y pos={pos}")
        _close(pk, jk, f"k cache pos={pos}")
        _close(pv, jv, f"v cache pos={pos}")


BACKENDS = {  # name: (init_caches, make_step)
    "layer": (fused.init_fused_caches, fused.make_fused_step),
    "stack": (fused.init_fused_stack_caches, fused.make_fused_stack_step),
    "monolith": (fused.init_fused_monolith_caches,
                 fused.make_fused_monolith_step),
    "whole": (fused.init_fused_caches,
              lambda pm: fused.make_fused_ends_step(pm, split=False)),
    "int8": (fused.init_fused_caches,
             lambda pm: fused.make_fused_step(pm, quantize="int8")),
}


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_backend_step_matches_flax_decode_step(models, backend):
    """Teacher forcing over 8 positions: each backend's step against the
    flax decode_step (on fake-quantized params for int8)."""
    m = models
    jm, pm, f = m["jm"], m["pm"], m["one"]
    variables = m["variables"]
    if backend == "int8":
        variables = {**variables, "params": jpd.fake_quantize_decoder_params(
            variables["params"], m["cfg"])}
    r = np.random.default_rng(1)
    roots = r.integers(0, 13, 8)
    attrs = r.integers(0, 14, 8)
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    init_caches, make_step = BACKENDS[backend]
    with torch.no_grad():
        cross = pm.prime(pm.encode(t["semantic"], t["scene_offset"],
                                   t["motion"], t["emotion"]))
        caches = init_caches(pm, cross)
        step = make_step(pm)
        flax_cache = m["cross"]
        for pos in range(8):
            jr, ja = (jnp.asarray([[v[pos]]], jnp.int32)
                      for v in (roots, attrs))
            want, mutated = jm.apply(
                {**variables, "cache": flax_cache}, jr, jr, ja, f["key"],
                jnp.asarray(pos, jnp.int32), method=jm.decode_step,
                mutable=["cache", "metrics", "moe_state"])
            flax_cache = mutated["cache"]
            tr, ta = (torch.tensor([int(v[pos])]) for v in (roots, attrs))
            got = step(caches, tr, ta, t["key"].reshape(1), pos)
            _close(got, want, f"{backend} pos={pos}")


def _jax_gumbel(seed, T, nb):
    """The noise jax.random.categorical draws in the JAX sampler's loop."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (nb, C.CHORD_END))))
    return np.stack(out)


@pytest.mark.parametrize("fused_mode,quantize,nb", [
    ("on", None, 1), ("stack", None, 1), ("monolith", None, 1),
    ("off", None, 1), ("auto", "int8", 1), ("on", None, B)])
def test_generate_chords_matches_jax_sampler(models, fused_mode, quantize,
                                             nb):
    """Token for token against the JAX sampler with its gumbel noise
    handed in: at B=1 against the same JAX backend (Pallas kernels in
    interpret mode; int8 on the JAX "on" backend), at B=3 against the
    JAX "off" path (the batched kernels in interpret mode take minutes)."""
    m = models
    f = {k: v[:nb] for k, v in m["feats"].items()}
    primer = np.asarray([[5, 122, 66]] * nb, np.int32)
    roots = np.asarray([[1 + (p % 12) for p in primer[0]]] * nb, np.int32)
    attrs = np.asarray([[p % 14 for p in primer[0]]] * nb, np.int32)
    num_primer = np.asarray([2, 3, 1][:nb], np.int32)
    jax_fused = ("on" if quantize else fused_mode) if nb == 1 else "off"
    want = jax_generate(
        m["jm"], m["variables"], semantic=f["semantic"], key=f["key"],
        scene_offset=f["scene_offset"], motion=f["motion"],
        emotion=f["emotion"], primer=jnp.asarray(primer),
        primer_root=jnp.asarray(roots), primer_attr=jnp.asarray(attrs),
        num_primer=jnp.asarray(num_primer), rng=jax.random.PRNGKey(4),
        gcfg=JaxGenerateConfig(target_seq_length=L), temperature=0.8,
        fused=jax_fused, interpret=True, quantize=quantize)
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    got = generate_chords(
        m["pm"], primer=torch.from_numpy(primer),
        primer_root=torch.from_numpy(roots),
        primer_attr=torch.from_numpy(attrs),
        num_primer=torch.from_numpy(num_primer),
        gcfg=GenerateConfig(target_seq_length=L), temperature=0.8,
        fused=fused_mode, quantize=quantize,
        _gumbel=torch.from_numpy(_jax_gumbel(4, L, nb)), **t)
    for k in ("gen_seq", "gen_seq_root", "gen_seq_attr"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_int8_at_b3_warns_and_decodes_fake_quantized(models):
    """quantize="int8" at B>1 decodes on the plain step with fake-quantized
    weights and warns unless fused="auto", as the JAX sampler does; the
    tokens equal the JAX sampler's."""
    m = models
    f = m["feats"]
    primer = np.ones((B, 2), np.int32)
    kw = dict(gcfg=GenerateConfig(target_seq_length=L), quantize="int8",
              num_primer=2)
    want = jax_generate(
        m["jm"], m["variables"], semantic=f["semantic"], key=f["key"],
        scene_offset=f["scene_offset"], motion=f["motion"],
        emotion=f["emotion"], primer=jnp.asarray(primer),
        primer_root=jnp.asarray(primer), primer_attr=jnp.asarray(primer),
        rng=jax.random.PRNGKey(9), fused="off",
        **dict(kw, gcfg=JaxGenerateConfig(target_seq_length=L)))
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    p = torch.from_numpy(primer)
    with pytest.warns(UserWarning, match="fake-quantized"):
        got = generate_chords(m["pm"], primer=p, primer_root=p, primer_attr=p,
                              fused="on",
                              _gumbel=torch.from_numpy(_jax_gumbel(9, L, B)),
                              **kw, **t)
    np.testing.assert_array_equal(got["gen_seq"].numpy(),
                                  np.asarray(want["gen_seq"]))


def _tiny_port(version):
    cfg = port_amt_config(version, n_layers=2, num_heads=2, d_model=16,
                          d_ff=32, max_seq_video=L, max_seq_chord=L,
                          total_vf_dim=7 + 1 + 1 + 2, dropout=0.0)
    return init_weights_(VideoMusicTransformer(cfg),
                         torch.Generator().manual_seed(0)).eval()


@pytest.mark.parametrize("fused_mode,quantize,error", [
    ("stack", None, ValueError), ("monolith", None, ValueError),
    ("ends", None, ValueError), ("monolith", "int8", ValueError)])
def test_variant_rejects_v2_only_backends(models, fused_mode, quantize,
                                          error):
    """A V3 wiring with a V2-only backend is a clear error (the JAX
    sampler's ValueError), with int8 weights too."""
    pm = _tiny_port("3.1")
    t = {k: torch.from_numpy(v[:1]) for k, v in models["feats"].items()}
    p = torch.ones(1, 2, dtype=torch.int32)
    with pytest.raises(error, match="V2-family"):
        generate_chords(pm, primer=p, primer_root=p, primer_attr=p,
                        num_primer=1, gcfg=GenerateConfig(target_seq_length=L),
                        fused=fused_mode, quantize=quantize, **t)


def test_unknown_fused_or_quantize_raises(models):
    t = {k: torch.from_numpy(v[:1]) for k, v in models["feats"].items()}
    p = torch.ones(1, 2, dtype=torch.int32)
    kw = dict(primer=p, primer_root=p, primer_attr=p, num_primer=1,
              gcfg=GenerateConfig(target_seq_length=L), **t)
    with pytest.raises(ValueError, match="fused must be"):
        generate_chords(models["pm"], fused="fast", **kw)
    with pytest.raises(ValueError, match="quantize must be"):
        generate_chords(models["pm"], quantize="int4", **kw)


def _flat_inputs(models, n, device="cpu", S=L):
    D = models["cfg"].d_model
    layers = dl.pack_decoder_layers(models["pm"])
    caches = [tuple(torch.zeros(rows, D, device=device)
                    for rows in (S, S, L, L)) for _ in range(n)]
    if device != "cpu":
        layers = [{k: v.to(device) for k, v in l.items()} for l in layers]
    return [layers[i % 6] for i in range(n)], caches


@pytest.mark.parametrize("case", ["too_many_layers", "cache_shape", "x_shape",
                                  "int8", "meta"])
def test_stack_wrappers_validate(models, case):
    """The wrappers refuse what the kernel does not take, on every path."""
    m = models
    kw = _kw(m["cfg"])
    head = dl.pack_ends(m["pm"])
    tok = (torch.tensor([1]), torch.tensor([2]), torch.tensor([1.0]))
    if case == "too_many_layers":
        layers, caches = _flat_inputs(m, 17)
        with pytest.raises(ValueError, match="17 layers"):
            ds.decode_flat_monolith_step(*tok, 0, layers, head, caches, **kw)
    elif case == "cache_shape":
        layers, caches = _flat_inputs(m, 2)
        caches[1] = (torch.zeros(L, 8),) + caches[1][1:]
        with pytest.raises(ValueError, match="self caches"):
            ds.decode_flat_monolith_step(*tok, 0, layers, head, caches, **kw)
    elif case == "x_shape":
        seg = ds.pack_decoder_segments(m["pm"])[0]
        kc = torch.zeros(3, L, 16)
        with pytest.raises(ValueError, match="x must be"):
            ds.decode_segment_step(torch.zeros(1, 8), 0, seg, kc, kc, kc, kc,
                                   **kw)
    elif case == "int8":
        layers = dl.pack_decoder_layers(m["pm"], quantize="int8")[:2]
        _, caches = _flat_inputs(m, 2)
        with pytest.raises(ValueError, match="int8"):
            ds.decode_flat_monolith_step(*tok, 0, layers, head, caches, **kw)
    else:
        layers, caches = _flat_inputs(m, 2, device="meta")
        with pytest.raises(ValueError, match="no kernel for device"):
            ds.decode_flat_monolith_step(*tok, 0, layers, None, caches,
                                         embed=False, fold_head=False,
                                         x=torch.zeros(1, 16, device="meta"),
                                         **kw)


def test_route_log_lists_every_moe_router(models):
    """With ops.decode_layer.route_log a list, the plain B=1 step appends
    each MoE layer's (1, k_top) expert ids in layer order (the layer chain
    and the cooperative kernel append theirs the same way on the card, for
    chip_smoke.py to compare with these); with it None, nothing is kept."""
    m = models
    cfg = m["cfg"]
    E = cfg.moe.n_experts
    kc, vc, kx, vx = _stack_caches(m, range(len(cfg.decoder_layers)),
                                   np.random.default_rng(5))
    pp = ds.pack_monolith(m["pm"])

    def step():
        return ds.decode_monolith_plain(
            torch.tensor([1]), torch.tensor([2]), torch.tensor([1.0]), 3, pp,
            torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
            torch.from_numpy(kx), torch.from_numpy(vx), **_kw(cfg))

    dl.route_log = []
    try:
        want = step()
        routes = dl.route_log
    finally:
        dl.route_log = None
    moe = [i for i, spec in enumerate(cfg.decoder_layers)
           if spec.ffn == "moe"]
    assert len(routes) == len(moe) > 0
    for ids in routes:
        assert ids.shape == (1, 2)
        assert len(set(ids.flatten().tolist())) == 2
        assert all(0 <= e < E for e in ids.flatten().tolist())
    torch.testing.assert_close(step(), want, rtol=0, atol=0)
    assert dl.route_log is None
