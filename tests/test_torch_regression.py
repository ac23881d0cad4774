"""The port's Mamba-family regression against the JAX package (CPU, f32):
the plain selective scan against the Pallas kernel in interpret mode and
the associative-scan path, the scan wrapper's gradients against jax.vjp,
the full-default bimamba+ VideoRegression and every other Mamba-family
backbone (and use_kan on mamba) through regression_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video2music_tpu.core.config import RegressionConfig
from video2music_tpu.models import VideoRegression as JaxRegression
from video2music_tpu.ops.pallas_scan import selective_scan_pallas
from video2music_tpu.ops.scan import selective_scan as jax_scan
from video2music_tpu_torch.models import VideoRegression
from video2music_tpu_torch.ops.scan import MAX_D_STATE, selective_scan
from video2music_tpu_torch.weights import regression_from_jax

torch.set_num_threads(1)


def test_selective_scan_matches_pallas_and_associative(rng):
    b, L, ED, N = 2, 12, 24, 4
    x = rng.standard_normal((b, L, ED)).astype(np.float32)
    delta = rng.uniform(0.01, 0.5, (b, L, ED)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (ED, N)).astype(np.float32)
    B, C = (rng.standard_normal((b, L, N)).astype(np.float32)
            for _ in range(2))
    D = rng.standard_normal(ED).astype(np.float32)
    got = selective_scan(*(torch.from_numpy(a) for a in (x, delta, A, B, C, D)))
    args = tuple(jnp.asarray(a) for a in (x, delta, A, B, C, D))
    # another association order than the sequential walk: atol 1e-5
    for want in (selective_scan_pallas(*args, interpret=True),
                 jax_scan(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("N,L", [(12, 1), (12, 63), (12, 65), (64, 1),
                                 (64, 63), (64, 65), (1024, 3)])
def test_selective_scan_any_d_state(N, L):
    """The plain scan at d_state 12 and 64 (odd widths, and wider than a
    warp) and at moemamba's d_state = d_hidden = 1024 (the most the CUDA
    kernel takes: MAX_D_STATE), over L = 1 and around the kernel's chunks,
    against the Pallas kernel in interpret mode (which pads N to 128) and
    the associative-scan path."""
    assert MAX_D_STATE >= 1024
    rng = np.random.default_rng(N * 1000 + L)
    b, ED = 2, 8
    x = rng.standard_normal((b, L, ED)).astype(np.float32)
    delta = rng.uniform(0.01, 0.5, (b, L, ED)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (ED, N)).astype(np.float32)
    B, C = (rng.standard_normal((b, L, N)).astype(np.float32)
            for _ in range(2))
    D = rng.standard_normal(ED).astype(np.float32)
    got = selective_scan(*(torch.from_numpy(a) for a in (x, delta, A, B, C, D)))
    assert got.shape == (b, L, ED)
    args = tuple(jnp.asarray(a) for a in (x, delta, A, B, C, D))
    # another association order than the sequential walk, over up to 1024
    # terms of C . h: atol 1e-5 scaled by sqrt(N / 4)
    for want in (selective_scan_pallas(*args, interpret=True),
                 jax_scan(*args)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=1e-5 * max(1.0, (N / 4) ** 0.5))


def test_bimamba_plus_regression_matches_jax(rng):
    """Full product defaults: d_model 64, d_hidden 1024, 2 layers,
    d_state 16, expand 2, over a 300-second clip."""
    cfg = RegressionConfig(reg_model="bimamba+", total_vf_dim=768 + 6)
    L = 300
    sem = rng.standard_normal((1, L, 768)).astype(np.float32)
    emo = rng.uniform(size=(1, L, 6)).astype(np.float32)
    jr = JaxRegression(cfg=cfg)
    zeros = np.zeros((1, L), np.float32)
    variables = jr.init({"params": jax.random.PRNGKey(1)}, sem, zeros,
                        zeros, emo)
    (want_ln, want_inst), _ = jr.apply(variables, sem, zeros, zeros, emo,
                                       mutable=["moe_state", "metrics"])
    pr = VideoRegression(cfg).eval()
    pr.load_state_dict(regression_from_jax(jax.device_get(
        variables["params"])))
    with torch.no_grad():
        ln, inst = pr(torch.from_numpy(sem), None, None,
                      torch.from_numpy(emo))
    assert ln.shape == (1, L, 2) and inst.shape == (1, L, 40)
    np.testing.assert_allclose(ln.numpy(), np.asarray(want_ln),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(inst.numpy(), np.asarray(want_inst),
                               rtol=2e-4, atol=2e-5)


# (reg_model, use_kan): the six Mamba-family backbones besides bimamba+,
# and the KAN projections on mamba
ZOO = [("mamba", False), ("mamba+", False), ("moemamba", False),
       ("bimamba", False), ("moe_bimamba+", False),
       ("sharedmoe_bimamba+", False), ("mamba", True)]


@pytest.mark.parametrize("reg_model,use_kan", ZOO,
                         ids=lambda v: str(v))
def test_regression_backbone_matches_jax(reg_model, use_kan, rng):
    """Each backbone at d_model 16, d_hidden 32 (so moemamba runs d_state
    32, d_conv 8, and its MoE experts the odd width 2 d_model + 1 = 33), 2
    layers, over a 24-second clip, through regression_from_jax."""
    cfg = RegressionConfig(reg_model=reg_model, total_vf_dim=10 + 6,
                           d_model=16, d_hidden=32, use_kan=use_kan)
    L = 24
    sem = rng.standard_normal((2, L, 10)).astype(np.float32)
    emo = rng.uniform(size=(2, L, 6)).astype(np.float32)
    jr = JaxRegression(cfg=cfg)
    zeros = np.zeros((2, L), np.float32)
    variables = jr.init({"params": jax.random.PRNGKey(2)}, sem, zeros,
                        zeros, emo)
    (want_ln, want_inst), _ = jr.apply(variables, sem, zeros, zeros, emo,
                                       mutable=["moe_state", "metrics"])
    pr = VideoRegression(cfg).eval()
    pr.load_state_dict(regression_from_jax(jax.device_get(
        variables["params"])))
    with torch.no_grad():
        ln, inst = pr(torch.from_numpy(sem), None, None,
                      torch.from_numpy(emo))
    assert ln.shape == (2, L, 2) and inst.shape == (2, L, 40)
    np.testing.assert_allclose(ln.numpy(), np.asarray(want_ln),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(inst.numpy(), np.asarray(want_inst),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("N", [4, 16])
def test_selective_scan_gradients_match_jax_vjp(N):
    """The scan wrapper's backward (autograd through the plain scan,
    recomputed) against jax.vjp of the JAX associative scan, for all six
    inputs."""
    rng = np.random.default_rng(N)
    b, L, ED = 2, 13, 6
    x = rng.standard_normal((b, L, ED)).astype(np.float32)
    delta = rng.uniform(0.01, 0.5, (b, L, ED)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (ED, N)).astype(np.float32)
    B, C = (rng.standard_normal((b, L, N)).astype(np.float32)
            for _ in range(2))
    D = rng.standard_normal(ED).astype(np.float32)
    g = rng.standard_normal((b, L, ED)).astype(np.float32)
    args = (x, delta, A, B, C, D)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y = selective_scan(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    _, vjp = jax.vjp(jax_scan, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    for name, a, w in zip(("x", "delta", "A", "B", "C", "D"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
