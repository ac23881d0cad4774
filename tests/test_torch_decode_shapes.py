"""Shapes the CUDA decode kernels refuse (CPU, f32): the sampler sends a
covered wiring whose widths or int8 rows the kernels cannot take to the
plain step, as the JAX sampler sends dims Mosaic cannot lower to its XLA
step (``fused_decode_mosaic_ok``), warning when ``fused`` was asked for
explicitly; the kernels' limits are stated once (``ops/decode_layer.py
decode_shape_fault``), and the sampler's predicate and the wrappers read
them; int8 KV caches add no limit, and since the decode kernels' attention
takes any even head size the head size adds none either (head size 12
and 512 take the kernels' route). Rows 1 and 11
above head size 256 (the head split across blocks on the card) and the
scan above d_state 1024 (state chunks on the card), limits until they
were lifted, against the JAX package: forward and gradients, the dropout
mask entry for entry, and the attention kernels' plan over head sizes."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video2music_tpu.core import constants as JC
from video2music_tpu.core.config import amt_config as jax_amt_config
from video2music_tpu.decode.sampler import GenerateConfig as JaxGenerateConfig
from video2music_tpu.decode.sampler import generate_chords as jax_generate
from video2music_tpu.models import VideoMusicTransformer as JaxAMT
from video2music_tpu.ops.pallas_attention import flash_attention as jax_flash
from video2music_tpu.ops.pallas_attention_dropout import (
    extract_dropped_probs as jax_extract, flash_attention_dropout as jax_fad)
from video2music_tpu.ops.scan import selective_scan as jax_scan
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
from video2music_tpu_torch.ops.flash_attention import flash_attention
from video2music_tpu_torch.ops.scan import (require_d_state, selective_scan,
                                            state_chunks)
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
# the cases of REFUSED the kernels take since their attention takes any
# even head size: head size 12 at d_model 96 (d_model 36 stays refused
# for its widths)
TAKEN = {("2.2", 96, 8, 64), (None, 96, 8, 64)}


@pytest.mark.parametrize("version,d_model,heads,d_ff", REFUSED)
def test_refused_shapes_decode_on_the_plain_step(version, d_model, heads,
                                                 d_ff):
    """A refused shape: fused_backend gives the plain step and fused="on"
    warns (as the JAX sampler does); a case of TAKEN: the kernels' backend
    (the B=1 and the batched one), with no warning under "on" either. The
    tokens of "auto" and "on" equal the JAX sampler's token for token."""
    cfg = _cfg(amt_config, version, d_model, heads, d_ff)
    taken = (version, d_model, heads, d_ff) in TAKEN
    assert cuda_decode_shapes_ok(cfg, 1) is taken
    assert (fused_backend(cfg, 1, "auto") != PLAIN) is taken
    assert (fused_backend(cfg, 4, "auto") != PLAIN) is taken
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
    if taken:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            on = generate_chords(pm, fused="on", _gumbel=noise, **kw)
    else:
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
    (dict(d_model=512, num_heads=1, d_ff=1024), 1, None, None, True, False,
     None),
    (dict(d_model=16, num_heads=2, d_ff=40), 1, "int8", None, False, True,
     "multiples of 16 (int8 rows)"),
    (dict(d_model=16, num_heads=2, d_ff=40), 2, "int8", None, True, True,
     None),
    (dict(d_model=16, num_heads=2, d_ff=32), 2, None, "int8", True, False,
     None),
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
    at B=1 only, where int8 kernels run; int8 KV caches add none: a head
    size of 8 at B>1 keeps them; nor does a head size of 512), the plain
    step where it fails (and for
    int8 weights at B>1), and the wrappers' message; no routing warns
    under "auto"."""
    cfg = amt_config("2.2", n_layers=2, **over)
    assert cuda_decode_shapes_ok(cfg, B, quantize) is ok
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        init, _ = fused_backend(cfg, B, quantize=quantize, kv_quant=kv_quant)
    assert (init is sampler._init_plain_caches) is plain
    assert not caught, [str(w.message) for w in caught]
    fault = decode_shape_fault(cfg.d_model, cfg.num_heads, (cfg.d_ff,),
                               int8_rows=quantize is not None and B == 1)
    assert (fault is None) is ok
    if message:
        assert message in fault


# ---------------------------------------------------------------------------
# rows 1, 11 and 12 above their former limits: head sizes above 256, d_state
# above 1024, against the JAX package (the wrappers' plain versions on CPU
# tensors; f32, within WIDE_REL of the largest magnitude)
# ---------------------------------------------------------------------------

WIDE = [320, 512]
WIDE_REL = 1e-5
INTERP = pltpu.InterpretParams()


def _rel(got, want, msg=""):
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, msg
    err = np.abs(got - want).max()
    assert err <= WIDE_REL * np.abs(want).max(), f"{msg}: max abs {err}"


@pytest.mark.parametrize("mode", ["plain", "bias", "causal"])
@pytest.mark.parametrize("D", WIDE)
def test_flash_attention_wide_heads_match_jax(D, mode):
    """Row 1 at head sizes 320 and 512 (B=1, H=2, L=S=16): the output and
    the q / k / v gradients against the Pallas flash attention in
    interpret mode (its custom VJP), with a bias or the causal mask."""
    r = np.random.default_rng(D + len(mode))
    q, k, v, g = (r.standard_normal((1, 2, 16, D)).astype(np.float32)
                  for _ in range(4))
    bias = r.standard_normal((1, 2, 16, 16)).astype(np.float32) \
        if mode == "bias" else None
    causal = mode == "causal"

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, bias=None if bias is None
                         else jnp.asarray(bias), causal=causal,
                         interpret=True)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    wants = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = flash_attention(*leaves, causal=causal, bias=None if bias is None
                          else torch.from_numpy(bias))
    _rel(got, want, f"out D={D} {mode}")
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), grads, wants):
        _rel(a, w, f"{name} D={D} {mode}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", WIDE)
def test_dropout_attention_wide_heads_match_jax(D, causal):
    """Row 11 at head sizes 320 and 512 (B=1, H=2, L=S=16, rate 0.1): the
    output and the q / k / v gradients against the Pallas dropout
    attention in interpret mode, and the dropped probabilities (the mask)
    equal to the Pallas kernel's entry for entry."""
    rate, seed = 0.1, 7
    r = np.random.default_rng(D + 3 * causal)
    q, k, v, do = (r.standard_normal((1, 2, 16, D)).astype(np.float32)
                   for _ in range(4))

    def f(q_, k_, v_):
        return jax_fad(q_, k_, v_, causal=causal, dropout_rate=rate,
                       seed=seed, interpret=INTERP)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    wants = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = fad.flash_attention_dropout(*leaves, causal=causal,
                                      dropout_rate=rate, seed=seed)
    _rel(got, want, f"out D={D}")
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(do))
    for name, a, w in zip(("dq", "dk", "dv"), grads, wants):
        _rel(a, w, f"{name} D={D}")
    jm = np.asarray(jnp.asarray(jax_extract(
        jnp.asarray(q), jnp.asarray(k), causal=causal, dropout_rate=rate,
        seed=seed, interpret=INTERP), jnp.float32))
    pm = fad.extract_dropped_probs(torch.from_numpy(q), torch.from_numpy(k),
                                   causal=causal, dropout_rate=rate,
                                   seed=seed).numpy()
    np.testing.assert_array_equal(pm == 0, jm == 0)
    _rel(pm, jm, f"dropped probabilities D={D}")


def test_scan_d_state_1025_matches_jax_vjp():
    """Row 12 at d_state 1025 (two state chunks on the card): the forward
    and all six inputs' gradients (the wrapper's backward recomputes the
    plain scan) against jax.vjp of the JAX package's scan."""
    rng = np.random.default_rng(1025)
    b, L, ED, N = 2, 9, 4, 1025
    assert state_chunks(N) == 2
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
    want, vjp = jax.vjp(jax_scan, *(jnp.asarray(a) for a in args))
    _rel(y, want, "y")
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    for name, a, w in zip(("x", "delta", "A", "B", "C", "D"), got,
                          vjp(jnp.asarray(g))):
        _rel(a, w, name)


@pytest.mark.parametrize("D,plan", [(8, (16, 1)), (256, (256, 1)),
                                    (257, (64, 5)), (512, (64, 8)),
                                    (1024, (64, 16))])
def test_head_instance_plan(D, plan):
    """The attention kernels' plan the wrappers read: (instance width,
    slices), the narrow instances to 256 and 64-column slices above; the
    padded head size is their product; no positive size raises, for the
    scan's d_state too."""
    assert kernels.head_instance(D, "t") == plan
    assert kernels.padded_head(D, "t") == plan[0] * plan[1] >= D
    with pytest.raises(ValueError, match="no positive head size"):
        kernels.head_instance(0, "flash_attention")
    with pytest.raises(ValueError, match="no positive state count"):
        require_d_state(0, "selective_scan")
    require_d_state(2048, "selective_scan")
