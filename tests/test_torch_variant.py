"""The port's variant decode kernels against the JAX package (CPU, f32):
the plain B=1 ``decode_variant_layer_step`` against the Pallas kernel in
interpret mode, and the plain batched pair ``batched_variant_layer_step`` /
``batched_variant_moe_ffn`` against theirs at B=3, on the same packed
weights (a tiny JAX model's ``pack_variant_layers``, converted to the
port's layout), for every wiring family the kernels cover: base AMT (RPR +
ReLU + LayerNorm), V1.0 (shared-less SiLU-MLP experts), V1.1 (shared-less
GLU experts), V3.0 (differential + RMSNorm) and V3.2 (pre-norm). The
output and the written K/V rows must agree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video2music_tpu.core.config import amt_config
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops.pallas_decode_batch_variant import (
    batched_variant_layer_step as jax_layer_b,
    batched_variant_moe_ffn as jax_moe_b)
from video2music_tpu.ops.pallas_decode_variant import (
    decode_variant_layer_step as jax_layer, pack_variant_layers as jax_pack)
from video2music_tpu_torch.core.config import amt_config as port_amt_config
from video2music_tpu_torch.ops.decode_batch_variant import (
    batched_variant_layer_step, batched_variant_moe_ffn)
from video2music_tpu_torch.ops.decode_variant import (
    VariantLayerMeta, decode_variant_layer_step, fused_variant_eligible)
from video2music_tpu_torch.ops.embeddings import rope_table

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5  # the JAX variant kernel tests' tolerance
S = 12  # max_seq_video == max_seq_chord of the tiny models
B = 3
# (version, layer indices): every layer of a uniform stack is alike; V3
# has shallow SwiGLU layers (0) and deep MoE layers (3)
CASES = [(None, (0,)), ("1.0", (0,)), ("1.1", (0,)), ("3.0", (0, 3)),
         ("3.2", (0, 3))]
_T = ("wqkv", "wo", "cwq", "cwo", "fw1g", "fw2", "sw1g", "sw2", "gate_w")
_EXPERT = ("ew1g", "ew2")
_ROW = ("bqkv", "bo", "cbq", "cbo", "fb1g", "fb2", "sb1g", "sb2", "gate_b",
        "lam", "clam", "subw", "csubw")


def _cfg(version, factory=amt_config):
    return factory(version, n_layers=4, num_heads=2, d_model=16, d_ff=32,
                   max_seq_video=S, max_seq_chord=S,
                   total_vf_dim=7 + 1 + 1 + 2, dropout=0.0)


def _port_layer(jl):
    """A JAX packed layer in the port's layout: weights (out, in), rows as
    vectors, expert stacks (E, out, in); er and norms as they are."""
    out = {}
    for k, v in jl.items():
        a = np.array(v, np.float32)
        if k in _T:
            a = a.T
        elif k in _EXPERT:
            a = a.transpose(0, 2, 1)
        elif k in _ROW:
            a = a.reshape(-1)
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


@pytest.fixture(scope="module", params=CASES, ids=lambda c: str(c[0]))
def packed(request):
    version, layer_ids = request.param
    cfg = _cfg(version)
    z = jnp.zeros((1, S - 1), jnp.int32)
    f = jnp.zeros((1, S, 7), jnp.float32)
    s = jnp.zeros((1, S), jnp.float32)
    params = JaxAMT(cfg=cfg).init(
        {"params": jax.random.PRNGKey(3)}, z, z, z, f,
        jnp.ones((1, 1)), s, s, jnp.zeros((1, S, 2)))["params"]
    layers, metas = jax_pack(params, cfg)
    return dict(version=version, cfg=cfg, layer_ids=layer_ids,
                layers=layers, metas=metas)


def _rope(cfg):
    if not cfg.decoder_layers[0].attn.rope:
        return None
    t = rope_table(S, cfg.d_model // cfg.num_heads, "cpu")
    return t[..., 0].contiguous(), t[..., 1].contiguous()


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _inputs(r, meta, D, lead=()):
    kw = 2 * D if meta.attn == "differential" else D
    cw = 2 * D if meta.cross == "differential" else D
    n = lambda *shape: r.standard_normal(lead + shape).astype(np.float32)
    return n(D), n(S, kw), n(S, D), n(S, cw), n(S, D)


def test_eligibility_matches_jax():
    from video2music_tpu.ops.pallas_decode_variant import (
        fused_variant_eligible as jax_eligible)
    for version in (None, "1.0", "1.1", "1.2.3", "1.3.3", "2.0", "2.2",
                    "2.3", "3.0", "3.1", "3.2"):
        assert fused_variant_eligible(_cfg(version, port_amt_config)) \
            == jax_eligible(_cfg(version)), version


def test_decode_variant_layer_step_matches_pallas(packed):
    cfg = packed["cfg"]
    D, H = cfg.d_model, cfg.num_heads
    kw = dict(n_heads=H, k_top=cfg.moe.n_experts_per_token, norm=cfg.norm,
              pre_norm=cfg.pre_norm)
    rope = cfg.decoder_layers[0].attn.rope
    for i in packed["layer_ids"]:
        jl, jmeta = packed["layers"][i], packed["metas"][i]
        meta = VariantLayerMeta(**dataclasses.asdict(jmeta))
        pl_ = _port_layer(jl)
        r = np.random.default_rng(20 + i)
        for pos in (0, S - 1):
            x, kc, vc, kx, vx = _inputs(r, meta, D)
            want, k_new, v_new = jax_layer(
                jnp.asarray(x[None]), pos, jl, jmeta, jnp.asarray(kc),
                jnp.asarray(vc), jnp.asarray(kx), jnp.asarray(vx), rope=rope,
                interpret=True, **kw)
            pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
            got = decode_variant_layer_step(
                torch.from_numpy(x[None]), pos, pl_, meta, pk, pv,
                torch.from_numpy(kx), torch.from_numpy(vx),
                rope=_rope(cfg), **kw)
            msg = f"version {packed['version']} layer {i} pos {pos}"
            assert got.shape == (1, D) and got.dtype == torch.float32
            _close(got, want, msg)
            _close(pk, k_new, msg + " k cache")
            _close(pv, v_new, msg + " v cache")


def test_batched_variant_pair_matches_pallas(packed):
    cfg = packed["cfg"]
    D, H = cfg.d_model, cfg.num_heads
    k_top = cfg.moe.n_experts_per_token
    nkw = dict(norm=cfg.norm, pre_norm=cfg.pre_norm)
    rope = cfg.decoder_layers[0].attn.rope
    for i in packed["layer_ids"]:
        jl, jmeta = packed["layers"][i], packed["metas"][i]
        meta = VariantLayerMeta(**dataclasses.asdict(jmeta))
        pl_ = _port_layer(jl)
        r = np.random.default_rng(40 + i)
        for pos in (0, S - 1):
            x, kc, vc, kx, vx = _inputs(r, meta, D, (B,))
            want, k_row, v_row = jax_layer_b(
                jnp.asarray(x), pos, jl, jmeta, jnp.asarray(kc),
                jnp.asarray(vc), jnp.asarray(kx), jnp.asarray(vx),
                n_heads=H, rope=rope, interpret=True, **nkw)
            pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
            got = batched_variant_layer_step(
                torch.from_numpy(x), pos, pl_, meta, pk, pv,
                torch.from_numpy(kx), torch.from_numpy(vx), n_heads=H,
                rope=_rope(cfg), **nkw)
            msg = f"version {packed['version']} layer {i} pos {pos} B={B}"
            assert got.shape == (B, D)
            _close(got, want, msg)
            _close(pk[:, pos], k_row, msg + " k row")
            _close(pv[:, pos], v_row, msg + " v row")
            others = [j for j in range(S) if j != pos]
            assert torch.equal(pk[:, others], torch.from_numpy(kc[:, others]))
            if meta.ffn != "moe":
                continue
            want3 = jax_moe_b(want, jl, jmeta, k_top=k_top, interpret=True,
                              **nkw)
            got3 = batched_variant_moe_ffn(
                torch.from_numpy(np.array(want)), pl_, meta, k_top=k_top,
                **nkw)
            _close(got3, want3, msg + " moe")
