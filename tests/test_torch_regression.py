"""The port's bimamba+ regression against the JAX package (CPU, f32): the
plain selective scan against the Pallas kernel in interpret mode and the
associative-scan path, and the full-default VideoRegression through
regression_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from video2music_tpu.core.config import RegressionConfig
from video2music_tpu.models import VideoRegression as JaxRegression
from video2music_tpu.ops.pallas_scan import selective_scan_pallas
from video2music_tpu.ops.scan import selective_scan as jax_scan
from video2music_tpu_torch.models import VideoRegression
from video2music_tpu_torch.ops.scan import selective_scan
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
