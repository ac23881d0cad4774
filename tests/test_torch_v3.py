"""The port's AMT V3 family (differential attention, RMSNorm, pre-norm)
against the JAX package (CPU, f32): for 3.0 / 3.1 / 3.2 on bridged weights
the full forward, encode, prime, the unfused decode_step and the fused
variant steps at B=1 and B=3 under teacher forcing; then the V3 slice,
``Video2music(music_gen_version="3.1")`` ``generate`` at B=1 and
``generate_batch`` at B=3, and a 3.2 ``generate``, with the JAX sampling
noise handed in: the same chords and byte-identical MIDI."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video2music_tpu.core import constants as C
from video2music_tpu.core.config import amt_config
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.pipeline import Video2music as JaxVideo2music
from video2music_tpu_torch.core.config import amt_config as port_amt_config
from video2music_tpu_torch.decode.fused import (
    init_fused_batch_variant_caches, init_fused_variant_caches,
    make_fused_batch_variant_step, make_fused_variant_step)
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops.decode_variant import fused_variant_eligible
from video2music_tpu_torch.pipeline import Video2music
from video2music_tpu_torch.weights import amt_from_jax, regression_from_jax

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5
L = 12  # max_seq_video == max_seq_chord of the tiny models
B = 3
T = 300
STEPS = 6  # teacher-forced positions


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _lanes(a):  # flax cache (B, H, S, hd) -> (B, S, H*hd)
    a = np.asarray(a)
    return a.transpose(0, 2, 1, 3).reshape(a.shape[0], a.shape[2], -1)


@pytest.fixture(scope="module", params=["3.0", "3.1", "3.2"])
def models(request):
    """A tiny V3 model (4 layers: 3 SwiGLU + 1 SharedMoE) in JAX and the
    port with the same bridged weights, B=3 features and primed state."""
    kw = dict(n_layers=4, num_heads=2, d_model=16, d_ff=32,
              max_seq_video=L, max_seq_chord=L, total_vf_dim=7 + 1 + 1 + 2,
              dropout=0.0)
    cfg = amt_config(request.param, **kw)
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
    pm = VideoMusicTransformer(port_amt_config(request.param, **kw)).eval()
    pm.load_state_dict(amt_from_jax(jax.device_get(variables["params"]),
                                    variables.get("moe_state")))
    memory, _ = jm.apply(variables, feats["semantic"], feats["scene_offset"],
                         feats["motion"], feats["emotion"], method=jm.encode,
                         mutable=["metrics", "moe_state"])
    _, primed = jm.apply(variables, memory, method=jm.prime,
                         mutable=["cache"])
    t = {k: torch.from_numpy(v) for k, v in feats.items()}
    return dict(version=request.param, cfg=cfg, jm=jm, variables=variables,
                pm=pm, feats=feats, t=t, memory=memory,
                cross=primed["cache"])


def test_v3_eligible_for_the_variant_kernels(models):
    assert fused_variant_eligible(models["pm"].cfg)


def test_v3_full_forward_encode_prime(models):
    m = models
    jm, pm, f, t = m["jm"], m["pm"], m["feats"], m["t"]
    r = np.random.default_rng(2)
    x = r.integers(0, 13, (B, L - 1)).astype(np.int32)
    a = r.integers(0, 14, (B, L - 1)).astype(np.int32)
    want, _ = jm.apply(m["variables"], x, x, a, f["semantic"], f["key"],
                       f["scene_offset"], f["motion"], f["emotion"],
                       mutable=["metrics", "moe_state"])
    with torch.no_grad():
        got = pm(None, torch.from_numpy(x), torch.from_numpy(a),
                 t["semantic"], t["key"], t["scene_offset"], t["motion"],
                 t["emotion"])
        memory = pm.encode(t["semantic"], t["scene_offset"], t["motion"],
                           t["emotion"])
        cross = pm.prime(memory)
    _close(got, want, f"{m['version']} forward")
    _close(memory, m["memory"], f"{m['version']} encode")
    for i, (ck, cv) in enumerate(cross):
        cc = m["cross"][f"dec_{i}"]["cross_attn"]
        _close(ck, _lanes(cc["k"]), f"{m['version']} prime k {i}")
        _close(cv, _lanes(cc["v"]), f"{m['version']} prime v {i}")


def _teacher_forced(m, steppers):
    """Feed the same tokens through the flax decode_step and each of
    ``steppers`` (name -> step(pos, root, attr) -> logits); every logit
    must agree at every position."""
    jm = m["jm"]
    r = np.random.default_rng(3)
    roots = r.integers(0, 13, (STEPS, B))
    attrs = r.integers(0, 14, (STEPS, B))
    flax_cache = m["cross"]
    for pos in range(STEPS):
        jr, ja = (jnp.asarray(v[pos][:, None], jnp.int32)
                  for v in (roots, attrs))
        want, mutated = jm.apply(
            {**m["variables"], "cache": flax_cache}, jr, jr, ja,
            m["feats"]["key"], jnp.asarray(pos, jnp.int32),
            method=jm.decode_step, mutable=["cache", "metrics", "moe_state"])
        flax_cache = mutated["cache"]
        for name, step in steppers.items():
            got = step(pos, torch.from_numpy(roots[pos]),
                       torch.from_numpy(attrs[pos]))
            assert got.shape == (B, C.CHORD_SIZE)
            _close(got, want, f"{m['version']} {name} pos {pos}")


def test_v3_decode_steps_match_flax_decode_step(models):
    """The unfused decode_step, the fused variant step at B=1 (one clip at
    a time) and the batched fused variant step at B=3."""
    m = models
    pm, t = m["pm"], m["t"]
    key = t["key"].reshape(-1)
    with torch.no_grad():
        cross = pm.prime(pm.encode(t["semantic"], t["scene_offset"],
                                   t["motion"], t["emotion"]))
        cache = pm.init_cache(cross)
        ones = [init_fused_variant_caches(pm, [(ck[b:b + 1], cv[b:b + 1])
                                               for ck, cv in cross])
                for b in range(B)]
        one_step = make_fused_variant_step(pm)
        batch_caches = init_fused_batch_variant_caches(pm, cross)
        batch_step = make_fused_batch_variant_step(pm)

        def unfused(pos, root, attr):
            return pm.decode_step(None, root[:, None], attr[:, None], key,
                                  pos, cache)

        def fused_b1(pos, root, attr):
            return torch.cat([one_step(ones[b], root[b:b + 1],
                                       attr[b:b + 1], key[b:b + 1], pos)
                              for b in range(B)])

        def fused_b3(pos, root, attr):
            return batch_step(batch_caches, root, attr, key, pos)

        _teacher_forced(m, {"decode_step": unfused, "fused B=1": fused_b1,
                            "fused B=3": fused_b3})


# ---------------------------------------------------------------------------
# the slice: Video2music at 3.1 (B=1 and B=3) and 3.2 (B=1)
# ---------------------------------------------------------------------------

PIPE = dict(reg_model="bimamba+", motion_type=0,
            amt_overrides=dict(n_layers=3, num_heads=2, d_model=16, d_ff=32),
            reg_overrides=dict(n_layers=1, d_model=8, d_hidden=16))


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


def _pipelines(version):
    jv = JaxVideo2music(music_gen_version=version, **PIPE)
    pv = Video2music(device="cpu", music_gen_version=version, **PIPE)
    pv.load_state_dicts(
        amt_from_jax(jax.device_get(jv.variables["params"]),
                     jv.variables.get("moe_state")),
        regression_from_jax(jax.device_get(jv.reg_variables["params"])))
    return jv, pv


@pytest.fixture(scope="module")
def pipes31():
    return _pipelines("3.1")


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _same_outputs(got, want, tmp_path):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.chord_ids, w.chord_ids,
                                      err_msg=f"clip {i}")
        assert g.chords == w.chords and g.key == w.key
        assert g.densities == w.densities and g.velocities == w.velocities
    jax_files, port_files = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert any(n.endswith("output.mid") for n in port_files)
    assert sorted(port_files) == sorted(jax_files)
    for name, data in jax_files.items():
        assert port_files[name] == data, f"{name} differs"


@pytest.mark.parametrize("version", ["3.1", "3.2"])
def test_v3_generate_matches_jax_pipeline(version, pipes31, tmp_path):
    jv, pv = pipes31 if version == "3.1" else _pipelines(version)
    kw = dict(primer="C Am", key="C major", features=_features(24, 5),
              seed=3, temperature=0.9, compute_dtype="float32")
    want = jv.generate(output_dir=str(tmp_path / "jax"), **kw)
    got = pv.generate(output_dir=str(tmp_path / "port"),
                      _gumbel=_jax_gumbel(3, 1), **kw)
    _same_outputs([got], [want], tmp_path)


def test_v3_generate_batch_matches_jax_pipeline(pipes31, tmp_path):
    jv, pv = pipes31
    reqs = lambda: [dict(features=_features(24, 5), primer="C Am",
                         key="C major"),
                    dict(features=_features(10, 6), primer=""),
                    dict(features=_features(40, 7), primer="G Em C D",
                         key="A minor")]
    kw = dict(temperature=[0.9, 1.0, 1.1], seed=3, compute_dtype="float32")
    want = jv.generate_batch(reqs(), output_dir=str(tmp_path / "jax"), **kw)
    got = pv.generate_batch(reqs(), output_dir=str(tmp_path / "port"),
                            _gumbel=_jax_gumbel(3, 3), **kw)
    _same_outputs(got, want, tmp_path)
