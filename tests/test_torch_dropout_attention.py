"""The port's attention with hashed dropout (and flash attention's new
backward) against the JAX package on the CPU: the plain versions of
ops/flash_attention_dropout.py against the Pallas kernel of
ops/pallas_attention_dropout.py run in interpret mode, as the JAX tests
run it. The mask is a hash of its coordinates, so it must be identical,
zero pattern included; f32 outputs and gradients agree within rtol 2e-4 /
atol 2e-5 (another summation order only), bf16 within 2e-2 of the largest
value (8-bit mantissa on the inputs and the rounded probabilities)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video2music_tpu.ops.pallas_attention import flash_attention as jax_flash
from video2music_tpu.ops.pallas_attention_dropout import (
    _drop_mask, extract_dropped_probs as jax_extract,
    flash_attention_dropout as jax_fad)
from video2music_tpu_torch.ops.flash_attention import flash_attention
from video2music_tpu_torch.ops.flash_attention_dropout import (
    dropout_mask, extract_dropped_probs, flash_attention_dropout,
    flash_attention_dropout_bwd, flash_attention_dropout_fwd,
    flash_attention_dropout_plain)

torch.set_num_threads(1)
INTERP = pltpu.InterpretParams()
F32 = dict(rtol=2e-4, atol=2e-5)
BF16_REL = 2e-2


def _inputs(seed, B, H, L, D, bias):
    r = np.random.default_rng(seed)
    q, k, v, do = (r.standard_normal((B, H, L, D)).astype(np.float32)
                   for _ in range(4))
    b = r.standard_normal((B, H, L, L)).astype(np.float32) if bias else None
    return q, k, v, b, do


def _jax_run(q, k, v, b, do, *, causal, rate, seed, dtype=jnp.float32):
    cast = lambda a: jnp.asarray(a, dtype)
    args = [cast(q), cast(k), cast(v)] + ([jnp.asarray(b)] if b is not None
                                          else [])

    def f(q_, k_, v_, *rest):
        return jax_fad(q_, k_, v_, bias=rest[0] if rest else None,
                       causal=causal, dropout_rate=rate, seed=seed,
                       interpret=INTERP)
    out, vjp = jax.vjp(f, *args)
    grads = vjp(cast(do))
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in (out,) + grads]


def _port_run(q, k, v, b, do, *, causal, rate, seed, dtype=torch.float32):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in (q, k, v)]
    bt = None if b is None else torch.tensor(b, requires_grad=True)
    out = flash_attention_dropout(*ts, bias=bt, causal=causal,
                                  dropout_rate=rate, seed=seed)
    out.backward(torch.tensor(do, dtype=dtype))
    grads = [t.grad for t in ts] + ([bt.grad] if bt is not None else [])
    return [x.detach().float().numpy() for x in [out] + grads]


@pytest.mark.parametrize("seed", [0, 7, 123456789, -5, 2 ** 31 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_mask_is_the_tpu_kernels_bit_for_bit(seed, rate):
    B, H, L, S, row0 = 2, 3, 24, 40, 8
    got = dropout_mask(B, H, L + row0, S, rate, seed, "cpu").numpy()
    for bh in range(B * H):
        want = np.asarray(_drop_mask((L, S), rate, jnp.int32(seed), bh, row0))
        np.testing.assert_array_equal(got[bh // H, bh % H, row0:], want)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_f32(causal, use_bias, rate):
    """L = 130 rows cross the TPU kernel's 128-row q-block."""
    B, H, L, D, seed = 1, 2, 130, 16, 11
    q, k, v, b, do = _inputs(3, B, H, L, D, use_bias)
    kw = dict(causal=causal, rate=rate, seed=seed)
    want = _jax_run(q, k, v, b, do, **kw)
    got = _port_run(q, k, v, b, do, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **F32)

    bias_kw = dict(causal=causal, dropout_rate=rate, seed=seed)
    jp = np.asarray(jax_extract(jnp.asarray(q), jnp.asarray(k),
                                bias=None if b is None else jnp.asarray(b),
                                interpret=INTERP, **bias_kw))
    pp = extract_dropped_probs(torch.tensor(q), torch.tensor(k),
                               bias=None if b is None else torch.tensor(b),
                               **bias_kw).numpy()
    np.testing.assert_array_equal(pp == 0, jp == 0)
    np.testing.assert_allclose(pp, jp, rtol=1e-5, atol=1e-7)
    assert 0 < (pp == 0).mean() < 1


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_bf16(causal):
    B, H, L, D, seed = 1, 2, 40, 16, 3
    q, k, v, b, do = _inputs(5, B, H, L, D, True)
    kw = dict(causal=causal, rate=0.1, seed=seed)
    want = _jax_run(q, k, v, b, do, dtype=jnp.bfloat16, **kw)
    got = _port_run(q, k, v, b, do, dtype=torch.bfloat16, **kw)
    for name, g, w in zip(("out", "dq", "dk", "dv", "dbias"), got, want):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= BF16_REL, (name, err)


def test_zero_rate_is_plain_attention():
    q, k, v, _, _ = _inputs(1, 2, 2, 12, 16, False)
    t = [torch.tensor(a) for a in (q, k, v)]
    got = flash_attention_dropout(*t, causal=True, dropout_rate=0.0, seed=4)
    want = flash_attention(*t, causal=True)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_seed_tensor_equals_int_seed_and_changes_the_mask():
    q, k, v, _, _ = _inputs(2, 1, 2, 20, 16, False)
    t = [torch.tensor(a) for a in (q, k, v)]
    a = flash_attention_dropout(*t, dropout_rate=0.3, seed=9)
    b = flash_attention_dropout(*t, dropout_rate=0.3,
                                seed=torch.tensor(9, dtype=torch.int32))
    c = flash_attention_dropout(*t, dropout_rate=0.3, seed=10)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the plain forward is the same function
    torch.testing.assert_close(
        a, flash_attention_dropout_plain(*t, dropout_rate=0.3, seed=9))


def test_causal_needs_equal_lengths_and_cpu_launches_nothing():
    q = torch.zeros(1, 1, 4, 16)
    k = torch.zeros(1, 1, 6, 16)
    with pytest.raises(ValueError, match="requires L == S"):
        flash_attention_dropout(q, k, k, causal=True, dropout_rate=0.1)
    with pytest.raises(ValueError, match="outside"):
        flash_attention_dropout(q, k, k, dropout_rate=1.0)
    flash_attention_dropout_fwd.launches = 0
    flash_attention_dropout_bwd.launches = 0
    qg = q.clone().requires_grad_()
    flash_attention_dropout(qg, k, k, dropout_rate=0.1).sum().backward()
    assert flash_attention_dropout_fwd.launches == 0
    assert flash_attention_dropout_bwd.launches == 0


@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_backward_matches_jax_vjp(causal, use_bias):
    """flash_attention's backward recomputes through the plain version, as
    the JAX kernel's custom VJP recomputes through reference_attention."""
    q, k, v, b, do = _inputs(4, 2, 2, 20, 16, use_bias)
    args = [jnp.asarray(a) for a in (q, k, v)] + (
        [jnp.asarray(b)] if use_bias else [])

    def f(q_, k_, v_, *rest):
        return jax_flash(q_, k_, v_, bias=rest[0] if rest else None,
                         causal=causal, interpret=True)
    out, vjp = jax.vjp(f, *args)
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)] + (
        [torch.tensor(b, requires_grad=True)] if use_bias else [])
    got_out = flash_attention(*ts[:3], bias=ts[3] if use_bias else None,
                              causal=causal)
    got_out.backward(torch.tensor(do))
    got = [got_out.detach().numpy()] + [t.grad.numpy() for t in ts]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F32)
