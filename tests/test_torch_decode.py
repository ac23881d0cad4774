"""The port's B=1 decode against the JAX package (CPU, f32): the plain
decode layer against the Pallas decode_layer_step in interpret mode, the
ends against decode_flat_monolith_step, the fused step against the flax
decode_step under teacher forcing, and generate_chords token for token
against the JAX sampler with the JAX gumbel noise handed in."""

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
from video2music_tpu.ops.pallas_decode import (decode_layer_step as jax_layer,
                                               pack_decoder_layers as jax_pack)
from video2music_tpu.ops.pallas_decode_stack import (
    decode_flat_monolith_step as jax_ends, pack_monolith)
from video2music_tpu_torch.decode.fused import (init_fused_caches,
                                                make_fused_ends_step)
from video2music_tpu_torch.decode.sampler import (GenerateConfig,
                                                  generate_chords)
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops.decode_layer import (decode_ends_step,
                                                    decode_layer_step,
                                                    pack_decoder_layers,
                                                    pack_ends)
from video2music_tpu_torch.ops.embeddings import rope_table
from video2music_tpu_torch.weights import amt_from_jax

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5
L = 12  # max_seq_video == max_seq_chord of the tiny model


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


@pytest.fixture(scope="module")
def models():
    """Tiny AMT 2.2 (4 decoder layers: 3 SwiGLU + 1 SharedMoE) in JAX and
    the port with the same (bridged) weights, plus encoded/primed state."""
    cfg = amt_config("2.2", n_layers=4, num_heads=2, d_model=16, d_ff=32,
                     max_seq_video=L, max_seq_chord=L,
                     total_vf_dim=7 + 1 + 1 + 2, dropout=0.0)
    r = np.random.default_rng(0)
    feats = dict(
        semantic=r.standard_normal((1, L, 7)).astype(np.float32),
        key=np.ones((1, 1), np.float32),
        scene_offset=r.integers(0, 5, (1, L)).astype(np.float32),
        motion=r.standard_normal((1, L)).astype(np.float32),
        emotion=r.uniform(size=(1, L, 2)).astype(np.float32))
    jm = JaxAMT(cfg=cfg)
    z = jnp.zeros((1, L - 1), jnp.int32)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, z, z, z,
                        feats["semantic"], feats["key"],
                        feats["scene_offset"], feats["motion"],
                        feats["emotion"])
    params = jax.device_get(variables["params"])
    pm = VideoMusicTransformer(cfg).eval()
    pm.load_state_dict(amt_from_jax(params))
    memory, _ = jm.apply(variables, feats["semantic"], feats["scene_offset"],
                         feats["motion"], feats["emotion"], method=jm.encode,
                         mutable=["metrics", "moe_state"])
    _, primed = jm.apply(variables, memory, method=jm.prime,
                         mutable=["cache"])
    return dict(cfg=cfg, jm=jm, variables=variables, params=params, pm=pm,
                feats=feats, cross=primed["cache"])


def _lanes(a):  # flax cache (1, H, S, hd) -> (S, H*hd)
    a = np.asarray(a)[0]
    return a.transpose(1, 0, 2).reshape(a.shape[1], -1)


def _layer_setup(m, i, seed):
    """Random self caches and the layer's primed cross K/V, as numpy."""
    r = np.random.default_rng(seed)
    D = m["cfg"].d_model
    kc, vc = (r.standard_normal((L, D)).astype(np.float32) for _ in range(2))
    cc = m["cross"][f"dec_{i}"]["cross_attn"]
    return kc, vc, _lanes(cc["k"]), _lanes(cc["v"])


def _port_rope(cfg):
    t = rope_table(L, cfg.d_model // cfg.num_heads, "cpu")
    return t[..., 0].contiguous(), t[..., 1].contiguous()


@pytest.mark.parametrize("layer_idx", [1, 3])  # shallow SwiGLU / deep MoE
def test_decode_layer_matches_pallas_kernel(models, layer_idx):
    m = models
    cfg = m["cfg"]
    jl = jax_pack(m["params"], cfg)[layer_idx]
    pl_ = pack_decoder_layers(m["pm"])[layer_idx]
    kc, vc, kx, vx = _layer_setup(m, layer_idx, seed=layer_idx)
    jk, jv = jnp.asarray(kc), jnp.asarray(vc)
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    r = np.random.default_rng(7)
    for pos in (0, 4, L - 1):
        x = r.standard_normal((1, cfg.d_model)).astype(np.float32)
        want, jk, jv = jax_layer(jnp.asarray(x), pos, jl, jk, jv,
                                 jnp.asarray(kx), jnp.asarray(vx),
                                 n_heads=cfg.num_heads, rope=True,
                                 interpret=True)
        got = decode_layer_step(torch.from_numpy(x), pos, pl_, pk, pv,
                                torch.from_numpy(kx), torch.from_numpy(vx),
                                n_heads=cfg.num_heads, rope=_port_rope(cfg))
        _close(got, want, f"y pos={pos}")
        _close(pk, jk, f"k cache pos={pos}")
        _close(pv, jv, f"v cache pos={pos}")


@pytest.mark.parametrize("end", ["embed", "head"])
def test_decode_ends_match_flat_monolith(models, end):
    m = models
    cfg = m["cfg"]
    i = 0 if end == "embed" else len(cfg.decoder_layers) - 1
    kinds = (cfg.decoder_layers[i].ffn,)
    kc, vc, kx, vx = _layer_setup(m, i, seed=10 + i)
    pos, root, attr, key = 5, 3, 7, 1.0
    x = np.random.default_rng(3).standard_normal(
        (1, cfg.d_model)).astype(np.float32)
    embed = end == "embed"
    want, new = jax_ends(
        jnp.asarray([root]), jnp.asarray([attr]), jnp.asarray([key]), pos,
        jax_pack(m["params"], cfg)[i:i + 1], pack_monolith(m["params"], cfg),
        [tuple(jnp.asarray(a) for a in (kc, vc, kx, vx))], kinds=kinds,
        n_heads=cfg.num_heads, rope=True, embed=embed, fold_head=not embed,
        x=None if embed else jnp.asarray(x), interpret=True)
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = decode_ends_step(
        torch.tensor([root]), torch.tensor([attr]), torch.tensor([key]), pos,
        pack_decoder_layers(m["pm"])[i], pack_ends(m["pm"]), pk, pv,
        torch.from_numpy(kx), torch.from_numpy(vx), n_heads=cfg.num_heads,
        rope=_port_rope(cfg), embed=embed, fold_head=not embed,
        x=None if embed else torch.from_numpy(x))
    _close(got, want, "output")
    _close(pk, new[0][0], "k cache")
    _close(pv, new[0][1], "v cache")


def test_fused_step_matches_flax_decode_step(models):
    """Teacher forcing over 8 positions: the port's fused ends step and its
    unfused decode_step both track the flax decode_step's logits."""
    m = models
    jm, pm, f = m["jm"], m["pm"], m["feats"]
    r = np.random.default_rng(1)
    roots = r.integers(0, 13, 8)
    attrs = r.integers(0, 14, 8)
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    with torch.no_grad():
        cross = pm.prime(pm.encode(t["semantic"], t["scene_offset"],
                                   t["motion"], t["emotion"]))
        unfused_cache = pm.init_cache(cross)
        caches = init_fused_caches(pm, cross)
        step = make_fused_ends_step(pm)
        flax_cache = m["cross"]
        for pos in range(8):
            jr, ja = (jnp.asarray([[v[pos]]], jnp.int32) for v in (roots, attrs))
            want, mutated = jm.apply(
                {**m["variables"], "cache": flax_cache}, jr, jr, ja, f["key"],
                jnp.asarray(pos, jnp.int32), method=jm.decode_step,
                mutable=["cache", "metrics", "moe_state"])
            flax_cache = mutated["cache"]
            tr, ta = (torch.tensor([int(v[pos])]) for v in (roots, attrs))
            got = step(caches, tr, ta, t["key"].reshape(1), pos)
            _close(got, want, f"fused pos={pos}")
            got = pm.decode_step(None, tr[None], ta[None], t["key"], pos,
                                 unfused_cache)
            _close(got, want, f"unfused pos={pos}")


def test_full_forward_matches_flax(models):
    """Teacher-forced full forward (encoder, causal decoder through the
    attention wrapper, MoE over a sequence, head) against the flax model."""
    m = models
    f = m["feats"]
    r = np.random.default_rng(2)
    roots = r.integers(0, 13, (1, L - 1)).astype(np.int32)
    attrs = r.integers(0, 14, (1, L - 1)).astype(np.int32)
    want, _ = m["jm"].apply(m["variables"], roots, roots, attrs,
                            f["semantic"], f["key"], f["scene_offset"],
                            f["motion"], f["emotion"],
                            mutable=["metrics", "moe_state"])
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    with torch.no_grad():
        got = m["pm"](None, torch.from_numpy(roots).long(),
                      torch.from_numpy(attrs).long(), t["semantic"],
                      t["key"], t["scene_offset"], t["motion"], t["emotion"])
    assert got.shape == (1, L - 1, C.CHORD_SIZE)
    _close(got, want, "logits")


def _jax_gumbel(seed, T, B=1):
    """The noise jax.random.categorical draws in the JAX sampler's loop:
    the same split sequence (sampler.py:453,475)."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (B, C.CHORD_END))))
    return np.stack(out)


@pytest.mark.parametrize("temperature,primer", [(1.0, [1, 1]),
                                                (0.7, [5, 122, 66])])
def test_generate_chords_matches_jax_sampler(models, temperature, primer):
    m = models
    f = m["feats"]
    P = len(primer)
    pr = np.asarray([primer], np.int32)
    roots = np.asarray([[1 + (p % 12) for p in primer]], np.int32)
    attrs = np.asarray([[p % 14 for p in primer]], np.int32)
    want = jax_generate(
        m["jm"], m["variables"], semantic=f["semantic"], key=f["key"],
        scene_offset=f["scene_offset"], motion=f["motion"],
        emotion=f["emotion"], primer=jnp.asarray(pr),
        primer_root=jnp.asarray(roots), primer_attr=jnp.asarray(attrs),
        num_primer=P, rng=jax.random.PRNGKey(4),
        gcfg=JaxGenerateConfig(target_seq_length=L), temperature=temperature,
        fused="off")
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    got = generate_chords(
        m["pm"], primer=torch.from_numpy(pr),
        primer_root=torch.from_numpy(roots),
        primer_attr=torch.from_numpy(attrs), num_primer=P,
        gcfg=GenerateConfig(target_seq_length=L), temperature=temperature,
        _gumbel=torch.from_numpy(_jax_gumbel(4, L)), **t)
    for k in ("gen_seq", "gen_seq_root", "gen_seq_attr"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["gen_seq"][0, :P].tolist() == primer
