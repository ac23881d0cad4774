"""generate_chords at the head sizes the decode kernels' attention of any
even head size takes (csrc/batch_decode.cuh attn_any_kernel), one head of
512 and 32 heads of 4 (AMT 2.2, 2 layers, L 12, random weights), token for
token against the JAX sampler on its step path, through the port's "auto"
backend (the "ends" kernels' plain versions on the CPU), with and without
the kernel's sum order (tests/test_torch_decode_wide_heads.py
any_attend) in the layers; and weights.amt_from_jax with the decode packs
at one head and at 128 (2.2 and V3.1) against the JAX packs."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_decode_wide_heads import any_attend
from video2music_tpu.core import constants as JC
from video2music_tpu.core.config import amt_config as jax_amt_config
from video2music_tpu.decode.sampler import GenerateConfig as JaxGenerateConfig
from video2music_tpu.decode.sampler import generate_chords as jax_generate
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops import pallas_decode as jpd
from video2music_tpu.ops import pallas_decode_variant as jpv
from video2music_tpu_torch.core.config import amt_config
from video2music_tpu_torch.decode import sampler
from video2music_tpu_torch.decode.sampler import (GenerateConfig,
                                                  fused_backend,
                                                  generate_chords)
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops import decode_layer as dl
from video2music_tpu_torch.ops import decode_variant as dv
from video2music_tpu_torch.ops.decode_layer import cuda_decode_shapes_ok
from video2music_tpu_torch.weights import amt_from_jax

torch.set_num_threads(1)
L = 12


def _jax_gumbel(seed, T):
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (1, JC.CHORD_END))))
    return np.stack(out)


def _features(r):
    return dict(semantic=r.standard_normal((1, L, 7)).astype(np.float32),
                key=np.ones((1, 1), np.float32),
                scene_offset=r.integers(0, 5, (1, L)).astype(np.float32),
                motion=r.standard_normal((1, L)).astype(np.float32),
                emotion=r.uniform(size=(1, L, 2)).astype(np.float32))


def _random_variables(jm, feats, r):
    """The JAX model's variables with seeded values: the tree's shapes
    from jax.eval_shape of its init (nothing compiled), norm scales near
    1, weights scaled by 1 / sqrt(fan-in), vectors by 0.1."""
    z = jnp.zeros((1, L - 1), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, z, z, z,
        *(feats[k] for k in ("semantic", "key", "scene_offset", "motion",
                             "emotion"))))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if not jnp.issubdtype(leaf.dtype, jnp.floating):
            return jnp.zeros(leaf.shape, leaf.dtype)
        a = r.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name:
            return jnp.asarray(1.0 + 0.1 * a)
        fan = leaf.shape[-2] if len(leaf.shape) > 1 else 1
        return jnp.asarray(a * (0.1 if len(leaf.shape) == 1 else
                                fan ** -0.5))
    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _kw(D, H):
    return dict(n_layers=2, num_heads=H, d_model=D, d_ff=64,
                max_seq_video=L, max_seq_chord=L,
                total_vf_dim=7 + 1 + 1 + 2, dropout=0.0)


@pytest.mark.parametrize("version,heads", [("2.2", 1), ("2.2", 128),
                                           ("3.1", 1), ("3.1", 128)])
def test_packs_carry_any_head_count(version, heads):
    """weights.amt_from_jax and the decode packs at d_model 512 with one
    head and with 128: the port model loads the JAX weights (strict), and
    its packed layers (pack_decoder_layers for 2.2, pack_variant_layers
    with their metas for V3.1) equal the JAX packs in the port's layout
    (V3.1's lambda and subln rows, computed from the weights, within
    1e-6)."""
    r = np.random.default_rng(heads)
    kw = _kw(512, heads)
    jcfg = jax_amt_config(version, **kw)
    jm = JaxAMT(cfg=jcfg)
    variables = _random_variables(jm, _features(r), r)
    pm = VideoMusicTransformer(amt_config(version, **kw)).eval()
    pm.load_state_dict(amt_from_jax(jax.device_get(variables["params"]),
                                    variables.get("moe_state")))
    t = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    if version == "2.2":
        names = dict(wqkv="wqkv", bqkv="bqkv", wo="wo", bo="bo", cwq="cwq",
                     cbq="cbq", cwo="cwo", cbo="cbo",
                     norm_scale="norm_scale", norm_bias="norm_bias",
                     gate_w="gate_w", gate_b="gate_b", ew1g="ew1g",
                     eb1g="eb1g", ew2="ew2", eb2="eb2")
        for jl, pl_ in zip(jpd.pack_decoder_layers(variables["params"],
                                                   jcfg),
                           dl.pack_decoder_layers(pm)):
            ffn = "sw" if "gate_w" in jl else "fw"
            pairs = dict(names, w1g=ffn + "1g", b1g=ffn[0] + "b1g",
                         w2=ffn + "2", b2=ffn[0] + "b2")
            for pk, jk in pairs.items():
                if jk not in jl:
                    continue
                a = t(jl[jk])
                a = (a.transpose(0, 2, 1) if pk in ("ew1g", "ew2")
                     else a.T if pk in ("wqkv", "wo", "cwq", "cwo", "w1g",
                                        "w2", "gate_w")
                     else a.reshape(pl_[pk].shape))
                np.testing.assert_array_equal(pl_[pk].float().numpy(), a,
                                              err_msg=f"{heads} heads {pk}")
        return
    jlayers, jmetas = jpv.pack_variant_layers(variables["params"], jcfg)
    players, pmetas = dv.pack_variant_layers(pm)
    for jl, pl_, jm_, pm_ in zip(jlayers, players, jmetas, pmetas):
        assert dataclasses.asdict(jm_) == dataclasses.asdict(pm_)
        assert set(jl) == set(pl_), (set(jl) ^ set(pl_))
        for key, a in jl.items():
            a = t(a)
            a = (a.transpose(0, 2, 1) if key in ("ew1g", "ew2")
                 else a.T if key in ("wqkv", "wo", "cwq", "cwo", "fw1g",
                                     "fw2", "sw1g", "sw2", "gate_w")
                 else a.reshape(pl_[key].shape))
            # lambda and the subln row are computed (exp of dot products)
            np.testing.assert_allclose(
                pl_[key].float().numpy(), a, atol=0,
                rtol=1e-6 if key in ("lam", "clam", "subw", "csubw") else 0,
                err_msg=f"{heads} heads {key}")


@pytest.fixture(scope="module", params=[(512, 1), (128, 32)],
                ids=["hd512", "hd4"])
def generated(request):
    """A 2-layer 2.2 at d_model / heads, random weights
    (_random_variables), the JAX sampler's tokens on its step path, and
    the same model in the port."""
    D, H = request.param
    kw = _kw(D, H)
    jm = JaxAMT(cfg=jax_amt_config("2.2", **kw))
    r = np.random.default_rng(D)
    feats = _features(r)
    variables = _random_variables(jm, feats, r)
    primer = dict(primer=np.asarray([[5, 122]], np.int32),
                  primer_root=np.asarray([[6, 3]], np.int32),
                  primer_attr=np.asarray([[5, 10]], np.int32))
    want = jax_generate(
        jm, variables, **{k: jnp.asarray(v) for k, v in feats.items()},
        **{k: jnp.asarray(v) for k, v in primer.items()}, num_primer=2,
        rng=jax.random.PRNGKey(4),
        gcfg=JaxGenerateConfig(target_seq_length=L), fused="off")
    cfg = amt_config("2.2", **kw)
    pm = VideoMusicTransformer(cfg).eval()
    pm.load_state_dict(amt_from_jax(jax.device_get(variables["params"])))
    inputs = dict(**{k: torch.from_numpy(v) for k, v in {**feats,
                                                          **primer}.items()},
                  num_primer=2, gcfg=GenerateConfig(target_seq_length=L),
                  _gumbel=torch.from_numpy(_jax_gumbel(4, L)))
    return dict(cfg=cfg, pm=pm, want=want, inputs=inputs)


@pytest.mark.parametrize("mirror", [False, True], ids=["plain", "mirror"])
def test_generate_matches_jax_sampler(generated, mirror, monkeypatch):
    """The port's "auto" backend (the "ends" kernels; their plain versions
    here), with or without any_attend in the layers, equals the JAX
    sampler on its step path token for token, with no warning; the
    predicate takes the config."""
    cfg = generated["cfg"]
    assert cuda_decode_shapes_ok(cfg, 1)
    if mirror:
        monkeypatch.setattr(dl, "attend", any_attend)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert fused_backend(cfg, 1)[0] is not sampler._init_plain_caches
        got = generate_chords(generated["pm"], **generated["inputs"])
    for k in ("gen_seq", "gen_seq_root", "gen_seq_attr"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(generated["want"][k]),
                                      err_msg=k)
