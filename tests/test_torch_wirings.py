"""The port's AMT variant wirings against the JAX package (CPU, f32): the
base AMT (RPR, ReLU, sinusoidal positions, residual dropout), V1.0 / V1.1
/ V1.2.3 / V1.3.4 (learned positions, MLP or GLU experts with or without
the shared expert, RoPE for 1.2.3), 2.0 (learned positions), KAN 2.3,
2.2 with grouped-query attention and V1.1 with the frozen chord table and
the scene embedding, on bridged weights: the full forward, encode, prime,
the plain decode_step and, where ``fused_variant_eligible`` holds, the
variant packs and the fused variant steps at B=1 and B=3 under teacher
forcing; the RPR bias, KANLinear and the sinusoidal table; int8
fake-quantization of the base AMT and V1.0; and ``Video2music``
``generate`` (B=1) and ``generate_batch`` (B=3) for the base AMT, V1.1 and
2.3 + moemamba with the JAX sampling noise handed in: the same chords and
byte-identical MIDI."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video2music_tpu.core import constants as C
from video2music_tpu.core.config import amt_config
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops import embeddings as jemb
from video2music_tpu.ops import pallas_decode as jpd
from video2music_tpu.ops import pallas_decode_variant as jpv
from video2music_tpu.ops import rpr as jrpr
from video2music_tpu.ops.kan import KANLinear as JaxKAN
from video2music_tpu.pipeline import Video2music as JaxVideo2music
from video2music_tpu_torch.core.config import amt_config as port_amt_config
from video2music_tpu_torch.decode.fused import (
    init_fused_batch_variant_caches, init_fused_variant_caches,
    make_fused_batch_variant_step, make_fused_variant_step)
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops import decode_layer as dl
from video2music_tpu_torch.ops import decode_variant as dv
from video2music_tpu_torch.ops import rpr
from video2music_tpu_torch.ops.embeddings import sinusoidal_table
from video2music_tpu_torch.ops.kan import KANLinear
from video2music_tpu_torch.pipeline import Video2music
from video2music_tpu_torch.weights import amt_from_jax, regression_from_jax

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5
L = 12  # max_seq_video == max_seq_chord of the tiny models
B = 3
T = 300
STEPS = 6  # teacher-forced positions
TINY = dict(n_layers=2, num_heads=2, d_model=16, d_ff=32, max_seq_video=L,
            max_seq_chord=L, total_vf_dim=7 + 1 + 1 + 2, dropout=0.0)
# (id, version, overrides on TINY)
WIRINGS = [
    ("base", None, {}),
    ("1.0", "1.0", {}),
    ("1.1", "1.1", {}),
    ("1.2.3", "1.2.3", {}),
    ("1.3.4", "1.3.4", {}),
    ("2.0", "2.0", {}),
    ("2.3", "2.3", {}),
    ("2.2-gqa", "2.2", dict(num_heads=4, kv_heads=2)),
    ("1.1-tables", "1.1", dict(chord_embed=True, scene_embed=True)),
]


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _lanes(a):  # flax cache (B, H, S, hd) -> (B, S, H*hd)
    a = np.asarray(a)
    return a.transpose(0, 2, 1, 3).reshape(a.shape[0], a.shape[2], -1)


@pytest.fixture(scope="module", params=WIRINGS, ids=lambda w: w[0])
def wiring(request):
    """A tiny model of one wiring (2 + 2 layers) in JAX and the port with
    the same bridged weights, B=3 features and the primed JAX state."""
    name, version, over = request.param
    kw = {**TINY, **over}
    cfg = amt_config(version, **kw)
    r = np.random.default_rng(0)
    feats = dict(semantic=r.standard_normal((B, L, 7)).astype(np.float32),
                 key=np.asarray([[1.0], [0.0], [1.0]], np.float32),
                 scene_offset=r.integers(0, 5, (B, L)).astype(np.float32),
                 motion=r.standard_normal((B, L)).astype(np.float32),
                 emotion=r.uniform(size=(B, L, 2)).astype(np.float32))
    jm = JaxAMT(cfg=cfg)
    z = jnp.zeros((B, L - 1), jnp.int32)
    variables = jm.init({"params": jax.random.PRNGKey(1)}, z, z, z,
                        feats["semantic"], feats["key"],
                        feats["scene_offset"], feats["motion"],
                        feats["emotion"])
    pm = VideoMusicTransformer(port_amt_config(version, **kw)).eval()
    pm.load_state_dict(amt_from_jax(jax.device_get(variables["params"]),
                                    variables.get("moe_state")))
    memory, _ = jm.apply(variables, feats["semantic"], feats["scene_offset"],
                         feats["motion"], feats["emotion"], method=jm.encode,
                         mutable=["metrics", "moe_state"])
    _, primed = jm.apply(variables, memory, method=jm.prime,
                         mutable=["cache"])
    t = {k: torch.from_numpy(v) for k, v in feats.items()}
    return dict(name=name, cfg=cfg, jm=jm, variables=variables, pm=pm,
                feats=feats, t=t, memory=memory, cross=primed["cache"])


def test_wiring_full_forward_encode_prime(wiring):
    m = wiring
    jm, pm, f, t = m["jm"], m["pm"], m["feats"], m["t"]
    r = np.random.default_rng(2)
    x = r.integers(0, C.CHORD_SIZE, (B, L - 1)).astype(np.int32)
    xr = r.integers(0, 13, (B, L - 1)).astype(np.int32)
    xa = r.integers(0, 14, (B, L - 1)).astype(np.int32)
    want, _ = jm.apply(m["variables"], x, xr, xa, f["semantic"], f["key"],
                       f["scene_offset"], f["motion"], f["emotion"],
                       mutable=["metrics", "moe_state"])
    with torch.no_grad():
        got = pm(*(torch.from_numpy(a) for a in (x, xr, xa)), t["semantic"],
                 t["key"], t["scene_offset"], t["motion"], t["emotion"])
        memory = pm.encode(t["semantic"], t["scene_offset"], t["motion"],
                           t["emotion"])
        cross = pm.prime(memory)
    _close(got, want, f"{m['name']} forward")
    _close(memory, m["memory"], f"{m['name']} encode")
    for i, (ck, cv) in enumerate(cross):
        cc = m["cross"][f"dec_{i}"]["cross_attn"]
        _close(ck, _lanes(cc["k"]), f"{m['name']} prime k {i}")
        _close(cv, _lanes(cc["v"]), f"{m['name']} prime v {i}")


def test_wiring_eligibility_and_packs_match_jax(wiring):
    """The port's ``fused_variant_eligible`` is the JAX predicate; where it
    holds, ``pack_variant_layers`` gives the JAX packs (RPR er table, ReLU
    rows, MLP experts and shared experts) in the port's layout."""
    m = wiring
    cfg = m["pm"].cfg
    assert dv.fused_variant_eligible(cfg) == jpv.fused_variant_eligible(
        m["cfg"])
    if not dv.fused_variant_eligible(cfg):
        return
    jl, jmetas = jpv.pack_variant_layers(m["variables"]["params"], m["cfg"])
    pl_, metas = dv.pack_variant_layers(m["pm"])
    assert [dataclasses.asdict(a) for a in metas] == \
        [dataclasses.asdict(b) for b in jmetas]
    for i, (p, j) in enumerate(zip(pl_, jl)):
        assert sorted(p) == sorted(j), (i, sorted(set(p) ^ set(j)))
        for k, v in j.items():
            a = np.asarray(v, np.float32)
            if k in ("ew1g", "ew2"):
                a = a.transpose(0, 2, 1)
            elif k not in ("norm_scale", "norm_bias", "er", "eb1g", "eb2"):
                a = a.T if a.ndim == 2 and a.shape[0] > 1 else a.reshape(-1)
            _close(p[k], a, f"{m['name']} layer {i} {k}")


def _teacher_forced(m, steppers):
    """Feed the same tokens through the flax decode_step and each of
    ``steppers`` (name -> step(pos, token, root, attr) -> logits); every
    logit must agree at every position."""
    jm = m["jm"]
    r = np.random.default_rng(3)
    toks = r.integers(0, C.CHORD_SIZE, (STEPS, B))
    roots = r.integers(0, 13, (STEPS, B))
    attrs = r.integers(0, 14, (STEPS, B))
    flax_cache = m["cross"]
    for pos in range(STEPS):
        jt, jr, ja = (jnp.asarray(v[pos][:, None], jnp.int32)
                      for v in (toks, roots, attrs))
        want, mutated = jm.apply(
            {**m["variables"], "cache": flax_cache}, jt, jr, ja,
            m["feats"]["key"], jnp.asarray(pos, jnp.int32),
            method=jm.decode_step, mutable=["cache", "metrics", "moe_state"])
        flax_cache = mutated["cache"]
        for name, step in steppers.items():
            got = step(pos, *(torch.from_numpy(v[pos])
                              for v in (toks, roots, attrs)))
            assert got.shape == (B, C.CHORD_SIZE)
            _close(got, want, f"{m['name']} {name} pos {pos}")


def test_wiring_decode_steps_match_flax_decode_step(wiring):
    """The plain decode_step and, for a wiring the variant kernels cover,
    the fused variant step at B=1 (one clip at a time) and the batched
    fused variant step at B=3: the position row and the chord table ride
    in the glue, so a missing one shows here."""
    m = wiring
    pm, t = m["pm"], m["t"]
    key = t["key"].reshape(-1)
    with torch.no_grad():
        cross = pm.prime(pm.encode(t["semantic"], t["scene_offset"],
                                   t["motion"], t["emotion"]))
        cache = pm.init_cache(cross)

        def unfused(pos, tok, root, attr):
            return pm.decode_step(tok[:, None], root[:, None],
                                  attr[:, None], key, pos, cache)

        steppers = {"decode_step": unfused}
        if dv.fused_variant_eligible(pm.cfg):
            ones = [init_fused_variant_caches(
                pm, [(ck[b:b + 1], cv[b:b + 1]) for ck, cv in cross])
                for b in range(B)]
            one_step = make_fused_variant_step(pm)
            batch_caches = init_fused_batch_variant_caches(pm, cross)
            batch_step = make_fused_batch_variant_step(pm)

            def fused_b1(pos, tok, root, attr):
                return torch.cat([one_step(ones[b], root[b:b + 1],
                                           attr[b:b + 1], key[b:b + 1], pos,
                                           token=tok[b:b + 1])
                                  for b in range(B)])

            def fused_b3(pos, tok, root, attr):
                return batch_step(batch_caches, root, attr, key, pos,
                                  token=tok)

            steppers.update({"fused B=1": fused_b1, "fused B=3": fused_b3})
        _teacher_forced(m, steppers)


# ---------------------------------------------------------------------------
# the new ops against theirs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L_q,er_len", [(11, 12), (12, 12), (5, 9)])
def test_rpr_bias_full_and_decode_match_jax(L_q, er_len):
    """The skew-free full form against the JAX skew, and the decode form at
    every position (inside and past the window) against the JAX slice and
    against the full form's rows."""
    r = np.random.default_rng(L_q * 100 + er_len)
    q = r.standard_normal((2, 3, L_q, 8)).astype(np.float32)
    er = r.standard_normal((er_len, 8)).astype(np.float32)
    full = rpr.rpr_bias_full(torch.from_numpy(q), torch.from_numpy(er))
    _close(full, jrpr.rpr_bias_full(jnp.asarray(q), jnp.asarray(er)), "full")
    for pos in range(L_q):
        qp = q[:, :, pos:pos + 1]
        got = rpr.rpr_bias_decode(torch.from_numpy(qp), torch.from_numpy(er),
                                  pos, er_len + 3)
        want = jrpr.rpr_bias_decode(jnp.asarray(qp), jnp.asarray(er),
                                    jnp.asarray(pos), er_len + 3)
        _close(got, want, f"decode pos {pos}")
        _close(got[..., :L_q][..., :pos + 1], full[:, :, pos:pos + 1,
                                                   :pos + 1], f"row {pos}")


@pytest.mark.parametrize("shape", [(7, 5), (2, 9, 16)])
def test_kan_linear_and_sinusoidal_table_match_jax(shape):
    """KANLinear on inputs inside and outside the grid range, and the
    sinusoidal table, against the JAX package's."""
    r = np.random.default_rng(len(shape))
    x = (2.5 * r.standard_normal(shape)).astype(np.float32)
    jk = JaxKAN(shape[-1], 6)
    params = jk.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    pk = KANLinear(shape[-1], 6)
    pk.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in params.items()})
    with torch.no_grad():
        got = pk(torch.from_numpy(x))
    _close(got, jk.apply({"params": params}, jnp.asarray(x)), "KANLinear")
    np.testing.assert_array_equal(sinusoidal_table(300, 512),
                                  jemb.sinusoidal_table(300, 512))


@pytest.mark.parametrize("version", [None, "1.0"])
def test_fake_quantize_and_int8_step_match_jax(version):
    """``fake_quantize_decoder_params`` parameter by parameter, bit for bit
    (the ReLU MLPs, the MLP experts without a shared expert; the RPR table
    stays), then the int8 fused variant step at B=1 against the flax
    decode_step on the JAX fake-quantized weights."""
    cfg = amt_config(version, **TINY)
    z = jnp.zeros((1, L - 1), jnp.int32)
    f = jnp.zeros((1, L, 7))
    s = jnp.zeros((1, L))
    jm = JaxAMT(cfg=cfg)
    variables = jm.init({"params": jax.random.PRNGKey(5)}, z, z, z, f,
                        jnp.ones((1, 1)), s, s, jnp.zeros((1, L, 2)))
    pm = VideoMusicTransformer(port_amt_config(version, **TINY)).eval()
    pm.load_state_dict(amt_from_jax(jax.device_get(variables["params"])))
    fq = jpd.fake_quantize_decoder_params(variables["params"], cfg)
    want = amt_from_jax(jax.device_get(fq))
    got = dl.fake_quantize_decoder_params(pm).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    r = np.random.default_rng(6)
    feats = [r.standard_normal((1, L, 7)).astype(np.float32),
             r.integers(0, 5, (1, L)).astype(np.float32),
             r.standard_normal((1, L)).astype(np.float32),
             r.uniform(size=(1, L, 2)).astype(np.float32)]
    jvars = {**variables, "params": fq}
    memory, _ = jm.apply(jvars, *feats, method=jm.encode,
                         mutable=["metrics", "moe_state"])
    _, primed = jm.apply(jvars, memory, method=jm.prime, mutable=["cache"])
    flax_cache = primed["cache"]
    with torch.no_grad():
        cross = pm.prime(pm.encode(*(torch.from_numpy(a) for a in feats)))
        caches = init_fused_variant_caches(pm, cross)
        step = make_fused_variant_step(pm, quantize="int8")
        key = torch.ones(1)
        for pos in range(STEPS):
            root, attr = int(r.integers(0, 13)), int(r.integers(0, 14))
            want, mutated = jm.apply(
                {**jvars, "cache": flax_cache}, jnp.full((1, 1), root),
                jnp.full((1, 1), root), jnp.full((1, 1), attr),
                jnp.ones((1, 1)), jnp.asarray(pos), method=jm.decode_step,
                mutable=["cache", "metrics", "moe_state"])
            flax_cache = mutated["cache"]
            got = step(caches, torch.tensor([root]), torch.tensor([attr]),
                       key, pos)
            _close(got, want, f"{version} int8 step pos {pos}")


# ---------------------------------------------------------------------------
# the slice: Video2music for the base AMT, V1.1 and 2.3 + moemamba
# ---------------------------------------------------------------------------

PIPE = dict(motion_type=0,
            amt_overrides=dict(n_layers=2, num_heads=2, d_model=16, d_ff=32),
            reg_overrides=dict(n_layers=1, d_model=8, d_hidden=16))
SLICE = [(None, "bimamba+"), ("1.1", "bimamba+"), ("2.3", "moemamba")]


def _features(n_sec, seed):
    r = np.random.default_rng(seed)
    return {"semantic": r.standard_normal((n_sec, 768)).astype(np.float32),
            "emotion": r.uniform(size=(n_sec, 6)).astype(np.float32),
            "scene_offset": np.arange(n_sec, dtype=np.float32),
            "motion": r.standard_normal((n_sec,)).astype(np.float32)}


def _jax_gumbel(seed, n):
    """The noise the JAX sampler's loop draws (sampler.py:453,475)."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (n, C.CHORD_END))))
    return torch.from_numpy(np.stack(out))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _same_outputs(got, want, root):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.chord_ids, w.chord_ids,
                                      err_msg=f"clip {i}")
        assert g.chords == w.chords and g.key == w.key
        assert g.densities == w.densities and g.velocities == w.velocities
    jax_files, port_files = _files(root / "jax"), _files(root / "port")
    assert any(n.endswith("output.mid") for n in port_files)
    assert sorted(port_files) == sorted(jax_files)
    for name, data in jax_files.items():
        assert port_files[name] == data, f"{name} differs"


@pytest.mark.parametrize("version,reg_model", SLICE,
                         ids=lambda v: str(v))
def test_wiring_generate_and_batch_match_jax_pipeline(version, reg_model,
                                                      tmp_path):
    """``generate`` at B=1, then ``generate_batch`` at B=3, token for token
    and byte for byte against the JAX pipeline on bridged weights."""
    jv = JaxVideo2music(music_gen_version=version, reg_model=reg_model,
                        **PIPE)
    pv = Video2music(device="cpu", music_gen_version=version,
                     reg_model=reg_model, **PIPE)
    pv.load_state_dicts(
        amt_from_jax(jax.device_get(jv.variables["params"]),
                     jv.variables.get("moe_state")),
        regression_from_jax(jax.device_get(jv.reg_variables["params"])))
    kw = dict(primer="C Am", key="C major", features=_features(24, 5),
              seed=3, temperature=0.9, compute_dtype="float32")
    one = tmp_path / "one"
    want = jv.generate(output_dir=str(one / "jax"), **kw)
    got = pv.generate(output_dir=str(one / "port"),
                      _gumbel=_jax_gumbel(3, 1), **kw)
    _same_outputs([got], [want], one)
    reqs = lambda: [dict(features=_features(24, 5), primer="C Am",
                         key="C major"),
                    dict(features=_features(10, 6), primer=""),
                    dict(features=_features(40, 7), primer="G Em C D",
                         key="A minor")]
    kw = dict(temperature=[0.9, 1.0, 1.1], seed=4, compute_dtype="float32")
    batch = tmp_path / "batch"
    want = jv.generate_batch(reqs(), output_dir=str(batch / "jax"), **kw)
    got = pv.generate_batch(reqs(), output_dir=str(batch / "port"),
                            _gumbel=_jax_gumbel(4, 3), **kw)
    _same_outputs(got, want, batch)


EVERY = ([(v, "bimamba+", {}) for v in
          (None, "1.0", "1.1", "1.2", "1.2.3", "1.3", "1.3.3", "1.3.4", "2.0",
           "2.1", "2.2", "2.3", "3.0", "3.1", "3.2")]
         + [("2.2", "bimamba+", dict(num_heads=4, kv_heads=2))]
         + [("2.2", r, {}) for r in ("mamba", "mamba+", "moemamba", "bimamba",
                                     "moe_bimamba+", "sharedmoe_bimamba+")])


@pytest.mark.parametrize("version,reg_model,over", EVERY,
                         ids=lambda v: str(v))
def test_every_wiring_and_backbone_generates(version, reg_model, over,
                                             tmp_path):
    """Every AMT version, GQA and every Mamba-family backbone construct and
    generate on the CPU (seeded random weights, tiny widths): one chord id
    a second, in [1, CHORD_END), the primer kept, finite regression."""
    pv = Video2music(device="cpu", music_gen_version=version,
                     reg_model=reg_model, motion_type=0,
                     amt_overrides={**PIPE["amt_overrides"], **over},
                     reg_overrides=PIPE["reg_overrides"])
    res = pv.generate(features=_features(12, 8), primer="C Am",
                      key="C major", output_dir=str(tmp_path),
                      compute_dtype="float32")
    ids = np.asarray(res.chord_ids)
    assert ids.shape == (12,) and ((ids >= 1) & (ids < C.CHORD_END)).all()
    assert res.chords[:2] == ["C", "A:min"]
    assert np.isfinite(pv.last_regression["ln_nd"]).all()
