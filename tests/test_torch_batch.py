"""The port's batched (B>1) decode against the JAX package (CPU): the plain
batched layer step against the Pallas batched_layer_step in interpret mode
(both attention forms), the plain batched MoE step against Pallas
batched_moe_ffn (with and without the head, with a gate tie), both again
in bfloat16, the batched fused step against the flax decode_step under
teacher forcing, and generate_chords at B=3 token for token against the
JAX sampler with the JAX gumbel noise handed in."""

import copy

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
from video2music_tpu.ops.pallas_decode import pack_decoder_layers as jax_pack
from video2music_tpu.ops.pallas_decode_batch import (
    batched_layer_step as jax_layer_b, batched_moe_ffn as jax_moe_b)
from video2music_tpu_torch.decode.fused import (init_fused_batch_caches,
                                                make_fused_batch_step)
from video2music_tpu_torch.decode.sampler import (GenerateConfig,
                                                  generate_chords)
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops.decode_batch import (batched_layer_step,
                                                    batched_moe_ffn)
from video2music_tpu_torch.ops.decode_layer import (pack_decoder_layers,
                                                    pack_ends)
from video2music_tpu_torch.ops.embeddings import rope_table
from video2music_tpu_torch.weights import amt_from_jax

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5
# bfloat16, relative to the largest magnitude: the max error may reach a
# few 8-bit-mantissa flips (the two sides may sum in another order); the
# mean error checks the rounding points. At these sizes the port and Pallas
# agree bit for bit; a plain step that skips the batched kernel's roundings
# (probabilities and attention output to bf16) misses by a mean of
# 2.8e-4 - 1.2e-3.
BF16_REL = 2e-2
BF16_MEAN_REL = 1e-4
L = 12  # max_seq_video == max_seq_chord of the tiny model
B = 4


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _close_bf16(got, want, msg=""):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= BF16_REL * scale, f"{msg}: max abs {err.max()}"
    assert err.mean() <= BF16_MEAN_REL * scale, f"{msg}: mean {err.mean()}"


def _feats(r, n):
    return dict(
        semantic=r.standard_normal((n, L, 7)).astype(np.float32),
        key=np.asarray([[1.0], [0.0], [1.0], [0.0]][:n], np.float32),
        scene_offset=r.integers(0, 5, (n, L)).astype(np.float32),
        motion=r.standard_normal((n, L)).astype(np.float32),
        emotion=r.uniform(size=(n, L, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def models():
    """Tiny AMT 2.2 (4 decoder layers: 3 SwiGLU + 1 SharedMoE) in JAX and
    the port with the same (bridged) weights, plus B=4 encoded/primed
    state."""
    cfg = amt_config("2.2", n_layers=4, num_heads=2, d_model=16, d_ff=32,
                     max_seq_video=L, max_seq_chord=L,
                     total_vf_dim=7 + 1 + 1 + 2, dropout=0.0)
    feats = _feats(np.random.default_rng(0), B)
    jm = JaxAMT(cfg=cfg)
    z = jnp.zeros((1, L - 1), jnp.int32)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, z, z, z,
                        feats["semantic"][:1], feats["key"][:1],
                        feats["scene_offset"][:1], feats["motion"][:1],
                        feats["emotion"][:1])
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


def _lanes(a):  # flax cache (B, H, S, hd) -> (B, S, H*hd)
    a = np.asarray(a)
    return a.transpose(0, 2, 1, 3).reshape(a.shape[0], a.shape[2], -1)


def _sides(m, dtype):
    """(JAX params, port model) in ``dtype`` (both rounded from the same
    float32 weights)."""
    if dtype == "float32":
        return m["params"], m["pm"]
    cast = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                  m["params"])
    return cast, copy.deepcopy(m["pm"]).to(torch.bfloat16)


def _embed_pack(params, D):
    """The embed pack JAX's make_fused_batch_step builds (decode/fused.py)."""
    lc_w = params["Linear_chord"]["kernel"]
    return {"emb_root": params["embedding_root"]["embedding"],
            "emb_attr": params["embedding_attr"]["embedding"],
            "lc_w": lc_w[:D], "lc_krow": lc_w[D:D + 1],
            "lc_b": params["Linear_chord"]["bias"].reshape(1, -1)}


def _port_rope(cfg):
    t = rope_table(L, cfg.d_model // cfg.num_heads, "cpu")
    return t[..., 0].contiguous(), t[..., 1].contiguous()


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                  dtype))


@pytest.mark.parametrize("dtype,wide", [("float32", True),
                                        ("float32", False),
                                        ("bfloat16", True)])
@pytest.mark.parametrize("layer_idx", [0, 3])  # shallow + embed / deep MoE
def test_batched_layer_step_matches_pallas(models, layer_idx, dtype, wide):
    m = models
    cfg = m["cfg"]
    D, H = cfg.d_model, cfg.num_heads
    jparams, pm = _sides(m, dtype)
    jl = jax_pack(jparams, cfg)[layer_idx]
    pl_ = pack_decoder_layers(pm)[layer_idx]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    r = np.random.default_rng(10 + layer_idx)
    kc, vc = (r.standard_normal((B, L, D)).astype(np.float32)
              for _ in range(2))
    cc = m["cross"][f"dec_{layer_idx}"]["cross_attn"]
    kx, vx = _lanes(cc["k"]), _lanes(cc["v"])
    embed = layer_idx == 0
    pk, pv = _t(kc, dtype), _t(vc, dtype)
    for pos in (0, 5, L - 1):
        x = r.standard_normal((B, D)).astype(np.float32)
        roots = r.integers(0, 13, B)
        attrs = r.integers(0, 14, B)
        keys = np.asarray([1.0, 0.0, 0.0, 1.0], np.float32)
        before_k, before_v = pk.clone(), pv.clone()
        want, k_row, v_row = jax_layer_b(
            None if embed else jnp.asarray(x, jdt), pos, jl,
            jnp.asarray(before_k.float().numpy(), jdt),
            jnp.asarray(before_v.float().numpy(), jdt),
            jnp.asarray(kx, jdt), jnp.asarray(vx, jdt), n_heads=H, rope=True,
            block_b=2, interpret=True, wide=wide,
            tokens=((jnp.asarray(roots), jnp.asarray(attrs),
                     jnp.asarray(keys)) if embed else None),
            embed_pack=_embed_pack(jparams, D) if embed else None)
        got = batched_layer_step(
            None if embed else _t(x, dtype), pos, pl_, pk, pv,
            _t(kx, dtype), _t(vx, dtype), n_heads=H, rope=_port_rope(cfg),
            tokens=((torch.from_numpy(roots), torch.from_numpy(attrs),
                     torch.from_numpy(keys)) if embed else None),
            embed_pack=pack_ends(pm) if embed else None)
        assert got.shape == (B, D) and got.dtype == getattr(torch, dtype)
        msg = f"layer {layer_idx} pos {pos} {dtype} wide={wide}"
        others = [i for i in range(L) if i != pos]
        assert torch.equal(pk[:, others], before_k[:, others]), msg
        assert torch.equal(pv[:, others], before_v[:, others]), msg
        if dtype == "float32":
            _close(got, want, msg)
            _close(pk[:, pos], k_row, msg + " k row")
            _close(pv[:, pos], v_row, msg + " v row")
        else:
            _close_bf16(got, want, msg)
            _close_bf16(pk[:, pos], k_row, msg + " k row")
            _close_bf16(pv[:, pos], v_row, msg + " v row")


def _head_pack(params):
    dn = params["decoder_norm"]
    return {"dn_scale": dn["scale"].reshape(1, -1),
            "dn_bias": dn["bias"].reshape(1, -1),
            "wout": params["Wout"]["kernel"],
            "bout": params["Wout"]["bias"].reshape(1, -1)}


def _tie_gate(params, pm, i):
    """Experts 1, 3 and 5 share one gate column and a large bias, so all
    three tie for the top of every row: the first two indices must win."""
    params = jax.tree_util.tree_map(lambda x: x, params)
    gate = dict(params[f"dec_{i}"]["ffn"]["gate"])
    w, b = np.array(gate["kernel"]), np.array(gate["bias"])
    w[:, [3, 5]] = w[:, [1]]
    b[[1, 3, 5]] = 10.0
    gate.update(kernel=jnp.asarray(w), bias=jnp.asarray(b))
    ffn = dict(params[f"dec_{i}"]["ffn"], gate=gate)
    params[f"dec_{i}"] = dict(params[f"dec_{i}"], ffn=ffn)
    pm = copy.deepcopy(pm)
    with torch.no_grad():
        g = pm.decoder_layers[i].ffn.gate
        g.weight.copy_(torch.from_numpy(w.T))
        g.bias.copy_(torch.from_numpy(b))
    return params, pm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["plain", "head", "tie"])
def test_batched_moe_ffn_matches_pallas(models, case, dtype):
    m = models
    cfg = m["cfg"]
    i = len(cfg.decoder_layers) - 1
    params, pm = m["params"], m["pm"]
    if case == "tie":
        params, pm = _tie_gate(params, pm, i)
    jparams, pm = _sides(dict(m, params=params, pm=pm), dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jl = jax_pack(jparams, cfg)[i]
    pl_ = pack_decoder_layers(pm)[i]
    x2 = np.random.default_rng(5).standard_normal(
        (B, cfg.d_model)).astype(np.float32)
    head = case == "head"
    want = jax_moe_b(jnp.asarray(x2, jdt), None, jl,
                     k_top=cfg.moe.n_experts_per_token, interpret=True,
                     gate=True, head_pack=_head_pack(jparams) if head else None)
    got = batched_moe_ffn(_t(x2, dtype), pl_,
                          k_top=cfg.moe.n_experts_per_token,
                          head_pack=pack_ends(pm) if head else None)
    assert got.shape == want.shape
    if dtype == "float32":
        _close(got, want, case)
    else:
        _close_bf16(got, want, case)
    if case == "tie":  # expert 5 (tied with 1 and 3) must not be routed
        from video2music_tpu_torch.ops.decode_batch import route_plain
        cw = route_plain(_t(x2, dtype), pl_["gate_w"], pl_["gate_b"], 2)
        assert (cw[:, 1] > 0).all() and (cw[:, 3] > 0).all()
        assert (cw[:, 5] == 0).all()


def test_fused_batch_step_matches_flax_decode_step(models):
    """Teacher forcing over 8 positions at B=4: the port's batched fused
    step tracks the flax decode_step's logits for every clip."""
    m = models
    jm, pm, f = m["jm"], m["pm"], m["feats"]
    r = np.random.default_rng(1)
    roots = r.integers(0, 13, (8, B))
    attrs = r.integers(0, 14, (8, B))
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    with torch.no_grad():
        cross = pm.prime(pm.encode(t["semantic"], t["scene_offset"],
                                   t["motion"], t["emotion"]))
        caches = init_fused_batch_caches(pm, cross)
        step = make_fused_batch_step(pm)
        flax_cache = m["cross"]
        for pos in range(8):
            jr, ja = (jnp.asarray(v[pos][:, None], jnp.int32)
                      for v in (roots, attrs))
            want, mutated = jm.apply(
                {**m["variables"], "cache": flax_cache}, jr, jr, ja, f["key"],
                jnp.asarray(pos, jnp.int32), method=jm.decode_step,
                mutable=["cache", "metrics", "moe_state"])
            flax_cache = mutated["cache"]
            got = step(caches, torch.from_numpy(roots[pos]),
                       torch.from_numpy(attrs[pos]), t["key"].reshape(-1),
                       pos)
            assert got.shape == (B, C.CHORD_SIZE)
            _close(got, want, f"pos={pos}")


def _jax_gumbel(seed, T, n):
    """The noise jax.random.categorical draws in the JAX sampler's loop:
    the same split sequence (sampler.py:453,475), (T-1, n, CHORD_END)."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (n, C.CHORD_END))))
    return np.stack(out)


def test_generate_chords_b3_matches_jax_sampler(models):
    m = models
    n = 3
    f = {k: v[:n] for k, v in m["feats"].items()}
    primer = np.asarray([[5, 122, 66], [1, 40, 0], [17, 3, 9]], np.int32)
    roots = (1 + primer % 12).astype(np.int32)
    attrs = (primer % 14).astype(np.int32)
    num_primer = np.asarray([1, 2, 3], np.int32)
    temps = np.asarray([0.8, 1.0, 1.2], np.float32)
    want = jax_generate(
        m["jm"], m["variables"], semantic=f["semantic"], key=f["key"],
        scene_offset=f["scene_offset"], motion=f["motion"],
        emotion=f["emotion"], primer=jnp.asarray(primer),
        primer_root=jnp.asarray(roots), primer_attr=jnp.asarray(attrs),
        num_primer=jnp.asarray(num_primer), rng=jax.random.PRNGKey(4),
        gcfg=JaxGenerateConfig(target_seq_length=L),
        temperature=jnp.asarray(temps), fused="off")
    t = {k: torch.from_numpy(v) for k, v in f.items()}
    got = generate_chords(
        m["pm"], primer=torch.from_numpy(primer),
        primer_root=torch.from_numpy(roots),
        primer_attr=torch.from_numpy(attrs),
        num_primer=torch.from_numpy(num_primer),
        gcfg=GenerateConfig(target_seq_length=L),
        temperature=torch.from_numpy(temps),
        _gumbel=torch.from_numpy(_jax_gumbel(4, L, n)), **t)
    for k in ("gen_seq", "gen_seq_root", "gen_seq_attr"):
        assert got[k].shape == (n, L)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for b in range(n):  # each clip keeps its own primer length
        P = int(num_primer[b])
        assert got["gen_seq"][b, :P].tolist() == primer[b, :P].tolist()
