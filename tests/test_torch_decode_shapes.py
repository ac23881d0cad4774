"""Shapes the CUDA decode kernels refuse (CPU, f32): the sampler sends a
covered wiring whose head size, widths or int8 rows the kernels cannot
take to the plain step, as the JAX sampler sends dims Mosaic cannot lower
to its XLA step (``fused_decode_mosaic_ok``), warning when ``fused`` was
asked for explicitly; the kernels' limits are stated once
(``ops/decode_layer.py decode_shape_fault``), and the sampler's predicate
and the wrappers read them. The limits kept elsewhere (rows 1 and 11
above head size 256, the scan above d_state 1024) raise with their
messages."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video2music_tpu.core import constants as JC
from video2music_tpu.core.config import amt_config as jax_amt_config
from video2music_tpu.decode.sampler import GenerateConfig as JaxGenerateConfig
from video2music_tpu.decode.sampler import generate_chords as jax_generate
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu_torch import kernels
from video2music_tpu_torch.core.config import amt_config
from video2music_tpu_torch.decode import sampler
from video2music_tpu_torch.decode.sampler import (GenerateConfig,
                                                  fused_backend,
                                                  generate_chords)
from video2music_tpu_torch.models import VideoMusicTransformer
from video2music_tpu_torch.ops import flash_attention_dropout as fad
from video2music_tpu_torch.ops.decode_layer import (cuda_decode_shapes_ok,
                                                    decode_shape_fault)
from video2music_tpu_torch.ops.scan import require_d_state
from video2music_tpu_torch.weights import amt_from_jax

torch.set_num_threads(1)
L = 12
PLAIN = (sampler._init_plain_caches, sampler._make_plain_step)


def _cfg(factory, version, d_model, heads, d_ff):
    return factory(version, n_layers=2, num_heads=heads, d_model=d_model,
                   d_ff=d_ff, max_seq_video=L, max_seq_chord=L,
                   total_vf_dim=7 + 1 + 1 + 2, dropout=0.0)


def _jax_gumbel(seed, T):
    """The noise jax.random.categorical draws in the JAX sampler's loop."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T - 1):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (1, JC.CHORD_END))))
    return np.stack(out)


# (version, d_model, heads, d_ff): head size 12 (not a multiple of 8),
# head size 18 beside d_model 36 (not a multiple of 8), and the base AMT
# (the variant kernels) at head size 12
REFUSED = [("2.2", 96, 8, 64), ("2.2", 36, 2, 72), (None, 96, 8, 64)]


@pytest.mark.parametrize("version,d_model,heads,d_ff", REFUSED)
def test_refused_shapes_decode_on_the_plain_step(version, d_model, heads,
                                                 d_ff):
    """fused_backend gives the plain step; fused="on" warns (as the JAX
    sampler does); the tokens of "auto" and "on" equal the JAX sampler's
    token for token."""
    cfg = _cfg(amt_config, version, d_model, heads, d_ff)
    assert not cuda_decode_shapes_ok(cfg, 1)
    assert fused_backend(cfg, 1, "auto") == PLAIN
    assert fused_backend(cfg, 4, "auto") == PLAIN
    r = np.random.default_rng(0)
    feats = dict(semantic=r.standard_normal((1, L, 7)).astype(np.float32),
                 key=np.ones((1, 1), np.float32),
                 scene_offset=r.integers(0, 5, (1, L)).astype(np.float32),
                 motion=r.standard_normal((1, L)).astype(np.float32),
                 emotion=r.uniform(size=(1, L, 2)).astype(np.float32))
    jm = JaxAMT(cfg=_cfg(jax_amt_config, version, d_model, heads, d_ff))
    z = jnp.zeros((1, L - 1), jnp.int32)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, z, z, z,
                        *(feats[k] for k in ("semantic", "key",
                                             "scene_offset", "motion",
                                             "emotion")))
    pm = VideoMusicTransformer(cfg).eval()
    pm.load_state_dict(amt_from_jax(jax.device_get(variables["params"])))
    primer = dict(primer=np.asarray([[5, 122]], np.int32),
                  primer_root=np.asarray([[6, 3]], np.int32),
                  primer_attr=np.asarray([[5, 10]], np.int32))
    with pytest.warns(UserWarning, match="lane-tiling"):
        want = jax_generate(
            jm, variables, **{k: jnp.asarray(v) for k, v in feats.items()},
            **{k: jnp.asarray(v) for k, v in primer.items()}, num_primer=2,
            rng=jax.random.PRNGKey(4),
            gcfg=JaxGenerateConfig(target_seq_length=L), fused="on")
    kw = dict(**{k: torch.from_numpy(v) for k, v in {**feats,
                                                      **primer}.items()},
              num_primer=2, gcfg=GenerateConfig(target_seq_length=L))
    noise = torch.from_numpy(_jax_gumbel(4, L))
    with pytest.warns(UserWarning, match="CUDA shape limits"):
        on = generate_chords(pm, fused="on", _gumbel=noise, **kw)
    auto = generate_chords(pm, _gumbel=noise, **kw)
    for k in ("gen_seq", "gen_seq_root", "gen_seq_attr"):
        np.testing.assert_array_equal(auto[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(on[k].numpy(), auto[k].numpy())


# (overrides, B, quantize, kv_quant, kernels take it, plain step, fault
# message)
PREDICATE = [
    (dict(d_model=16, num_heads=2, d_ff=32), 1, None, None, True, False,
     None),
    (dict(d_model=512, num_heads=1, d_ff=1024), 1, None, None, False, True,
     "at most 256"),
    (dict(d_model=16, num_heads=2, d_ff=40), 1, "int8", None, False, True,
     "multiples of 16 (int8 rows)"),
    (dict(d_model=16, num_heads=2, d_ff=40), 2, "int8", None, True, True,
     None),
    (dict(d_model=16, num_heads=2, d_ff=32), 2, None, "int8", False, False,
     "int8 KV caches need"),
    (dict(d_model=16, num_heads=1, d_ff=32), 2, None, "int8", True, False,
     None),
    (dict(d_model=16, num_heads=2, d_ff=32), 1, None, "int8", True, False,
     None),
    (dict(d_model=16, num_heads=2, d_ff=36), 1, None, None, False, True,
     "multiples of 8"),
]


@pytest.mark.parametrize("over,B,quantize,kv_quant,ok,plain,message",
                         PREDICATE)
def test_shape_predicate_and_routing(over, B, quantize, kv_quant, ok, plain,
                                     message):
    """cuda_decode_shapes_ok on the kernels' limits (int8 weight rows count
    at B=1 only, where int8 kernels run; int8 KV caches at B>1 only), the
    plain step where it fails (and for int8 weights at B>1), and the
    wrappers' message. Where only the int8 KV caches are refused, the
    batched kernels keep the config with full-precision caches, and warn
    under "auto" too."""
    cfg = amt_config("2.2", n_layers=2, **over)
    assert cuda_decode_shapes_ok(cfg, B, quantize, kv_quant) is ok
    kv_dropped = kv_quant is not None and not ok and not plain
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        init, _ = fused_backend(cfg, B, quantize=quantize, kv_quant=kv_quant)
    assert (init is sampler._init_plain_caches) is plain
    dropped = [w for w in caught if "full-precision KV" in str(w.message)]
    assert len(dropped) == int(kv_dropped)
    fault = decode_shape_fault(
        cfg.d_model, cfg.num_heads, (cfg.d_ff,),
        int8_rows=quantize is not None and B == 1,
        int8_kv=kv_quant is not None and B > 1)
    assert (fault is None) is ok
    if message:
        assert message in fault


# ---------------------------------------------------------------------------
# the limits kept: rows 1 and 11 above head size 256, the scan above
# d_state 1024 (ValueError on a CUDA tensor, as the wrappers raise)
# ---------------------------------------------------------------------------

def test_flash_attention_head_size_limit_kept():
    """Row 1: the padded instances stop at 256."""
    with pytest.raises(ValueError, match="flash_attention: head_dim 320 "
                       "above 256: the widest instance"):
        kernels.head_instance(320, "flash_attention")


def test_dropout_attention_head_size_limit_kept():
    """Row 11: the wrapper's validation (which runs before the kernel
    launches) refuses head size 320."""
    q = torch.zeros(1, 2, 8, 320)
    seed = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="flash_attention_dropout: "
                       "head_dim 320 above 256"):
        fad._check(q, q, q, None, seed, "flash_attention_dropout")


def test_scan_d_state_limit_kept():
    """Row 12: d_state 1 to 1024."""
    require_d_state(1024, "selective_scan")
    for N in (0, 1025):
        with pytest.raises(ValueError, match=f"selective_scan: d_state {N} "
                           "outside 1..1024"):
            require_d_state(N, "selective_scan")
