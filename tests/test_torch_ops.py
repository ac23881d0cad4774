"""PyTorch port ops against the JAX package on shared inputs (CPU, f32):
LayerNorm, pairwise RoPE, attention (the plain version of the flash
kernel against the Pallas kernel in interpret mode) and SharedMoE at eval
(dense and gathered routing, including a tie in the gate logits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from video2music_tpu.core.config import MoEConfig
from video2music_tpu.ops.embeddings import apply_rope as jax_apply_rope
from video2music_tpu.ops.moe import MoELayer
from video2music_tpu.ops.pallas_attention import flash_attention as jax_flash
from video2music_tpu_torch.ops import decode_layer as port_decode
from video2music_tpu_torch.ops.embeddings import apply_rope
from video2music_tpu_torch.ops.flash_attention import flash_attention
from video2music_tpu_torch.ops.moe import MoELayer as SharedMoE
from video2music_tpu_torch.ops.norms import LayerNorm
from video2music_tpu_torch.ops.scan import selective_scan
from video2music_tpu_torch.weights import _put_ffn

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=kw.get("rtol", RTOL),
                               atol=kw.get("atol", ATOL))


def test_layer_norm_matches_flax(rng):
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    want = nn.LayerNorm(epsilon=1e-5).apply(
        {"params": {"scale": scale, "bias": bias}}, x)
    ln = LayerNorm(16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("with_positions", [False, True])
def test_pairwise_rope_matches_jax(rng, with_positions):
    x = rng.standard_normal((2, 3, 7, 8)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 3, 7)) if with_positions else None
    want = jax_apply_rope(jnp.asarray(x), positions=pos, max_len=64)
    got = apply_rope(torch.from_numpy(x),
                     positions=None if pos is None else torch.from_numpy(pos),
                     max_len=64)
    _close(got, want)


@pytest.mark.parametrize("variant", ["plain", "bias", "causal"])
def test_attention_matches_pallas_kernel(rng, variant):
    B, H, L, D = 1, 2, 12, 8
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32)
               for _ in range(3))
    bias = (rng.standard_normal((B, H, L, L)).astype(np.float32)
            if variant == "bias" else None)
    causal = variant == "causal"
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     bias=None if bias is None else jnp.asarray(bias),
                     causal=causal, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          bias=None if bias is None else torch.from_numpy(bias),
                          causal=causal)
    _close(got, want)


def test_attention_causal_needs_equal_lengths():
    q = torch.zeros(1, 1, 3, 8)
    k = torch.zeros(1, 1, 5, 8)
    with pytest.raises(ValueError, match="L == S"):
        flash_attention(q, k, k, causal=True)


def test_wrappers_raise_off_cpu_and_cuda():
    """Dispatch is by device only: a tensor on neither the CPU nor CUDA
    reaches no plain fallback."""
    x = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        selective_scan(x, x, torch.zeros(8, 4), torch.zeros(1, 4, 4),
                       torch.zeros(1, 4, 4), torch.zeros(8))
    with pytest.raises(ValueError, match="no kernel for device"):
        port_decode.decode_layer_step(
            x[0, :1], 0, {}, x[0], x[0], x[0], x[0], n_heads=2)


def _moe_pair(rng, D=16, F=24, tie=False):
    cfg = MoEConfig(n_experts=6, n_experts_per_token=2, expert="glu",
                    shared_expert=True)
    jm = MoELayer(cfg=cfg, d_model=D, d_ff=F, dropout_rate=0.0)
    variables = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 4, D)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    if tie:  # gate logits [1, 1, 1, 0, 0, 0] for every token
        params["gate"]["kernel"] = np.zeros_like(params["gate"]["kernel"])
        params["gate"]["bias"] = np.array([1, 1, 1, 0, 0, 0], np.float32)
    pm = SharedMoE(cfg, D, F)
    sd = {}
    _put_ffn(sd, "m", params)
    pm.load_state_dict({k[2:]: v for k, v in sd.items()})
    return jm, {**variables, "params": params}, pm


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("tokens", [5, 1])  # dense routing / gathered top-k
def test_shared_moe_matches_jax(rng, tokens, tie):
    jm, variables, pm = _moe_pair(rng, tie=tie)
    x = rng.standard_normal((1, tokens, 16)).astype(np.float32)
    want, _ = jm.apply(variables, jnp.asarray(x), deterministic=True,
                       mutable=["metrics", "moe_state"])
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    _close(got, want)


def test_plain_moe_tie_picks_first_index(rng):
    """The decode-layer plain MoE (the kernel's reference) also resolves a
    tie in the gate logits to the first index: with logits [1, 1, 1, 0,
    0, 0] experts 0 and 1 are chosen, so zeroing expert 2 changes nothing
    and zeroing expert 1 does."""
    D, F, E = 8, 8, 6
    g = torch.Generator().manual_seed(0)
    p = dict(gate_w=torch.zeros(E, D),
             gate_b=torch.tensor([1., 1., 1., 0., 0., 0.]),
             w1g=torch.randn(2 * F, D, generator=g), b1g=torch.zeros(2 * F),
             w2=torch.randn(D, F, generator=g), b2=torch.zeros(D),
             ew1g=torch.randn(E, 2 * F, D, generator=g),
             eb1g=torch.zeros(E, 2 * F),
             ew2=torch.randn(E, D, F, generator=g), eb2=torch.zeros(E, D))
    x = torch.randn(D, generator=g)
    base = port_decode._moe(x, p, 2)
    for e, changes in ((2, False), (1, True)):
        q = dict(p, ew2=p["ew2"].clone())
        q["ew2"][e] = 0
        assert torch.equal(port_decode._moe(x, q, 2), base) != changes
