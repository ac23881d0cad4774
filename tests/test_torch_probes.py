"""The port's two probes (video2music_tpu_torch/tools/, rows 13 and 14 of
the kernel table) against the JAX package's TPU probes under tools/, on the
CPU: the plain versions their functions run on CPU tensors, held to the JAX
probes' own expressions (run through JAX on the CPU, the Pallas kernel of
the dot_general probe in interpret mode). The tools/ files are loaded by
path, as they are scripts, and the compilation-cache setting the kv probe
makes when it is imported is restored.

Tolerances: the kv probe's attention core in bf16 and int8 against
``_attend_core`` within BF16_REL of the largest value (the JAX core rounds
each q * k product and each p * v product to bf16 before its sums, the
port sums in f32); the floor and the no-cache form exactly (integer-valued
slabs, whose f32 sums are exact in any order); the dot_general forms
exactly on integer-valued operands (their products and sums are exact in
f32) and to RTOL / ATOL on normal ones in f32 (another summation order).
"""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from video2music_tpu_torch import kernels
from video2music_tpu_torch.tools import kv_traffic_probe as kvp
from video2music_tpu_torch.tools import probe_dotgeneral as pdg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_REL = 2e-2
RTOL, ATOL = 1e-5, 1e-5
B, S, D, H = 2, 12, 512, 8  # the probe's D and H; a small batch and cache


def _load_tool(name):
    """tools/<name>.py as a module, leaving JAX's compilation-cache setting
    and sys.path as they were."""
    cache = jax.config.jax_compilation_cache_dir
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def jkv():
    return _load_tool("kv_traffic_probe")


@pytest.fixture(scope="module")
def jdot():
    return _load_tool("probe_dotgeneral")


def test_loading_the_tools_restores_the_cache_setting(jkv, jdot):
    assert jax.config.jax_compilation_cache_dir != ".jax_cache"
    assert (jkv.D, jkv.H) == (D, H)


def _slabs(seed, ints=False):
    """q (B, D) and bf16 K / V (B, S, D), normal or small integers; int8 K /
    V with (B, S) scales."""
    r = np.random.default_rng(seed)
    if ints:
        q, k, v = (r.integers(-8, 9, shape).astype(np.float32)
                   for shape in ((B, D), (B, S, D), (B, S, D)))
    else:
        q, k, v = (r.standard_normal(shape).astype(np.float32)
                   for shape in ((B, D), (B, S, D), (B, S, D)))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    k8, v8 = (r.integers(-127, 128, (B, S, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (r.uniform(0.01, 0.1, (B, S)).astype(np.float32)
              for _ in range(2))
    return bf, (k8, v8, ks, vs)


def _jnp(t):
    """A bf16 torch tensor as a JAX bf16 array (through f32: exact)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("pos", [4, S - 1])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_attend_core_matches_the_jax_probe(jkv, mode, pos):
    """Per clip and head, softmax over the rows 0..pos of q . k / sqrt(hd)
    in f32 (int8: the row scales folded into the logits and the
    probabilities), then P . V: the port's plain core against the JAX
    probe's _attend_core over the (B S, D) slab, its output cast to the
    kernel's bf16."""
    (q, k, v), (k8, v8, ks, vs) = _slabs(pos)
    if mode == "bf16":
        got = kvp.attend(q, k, v, pos, H)
        want = jkv._attend_core(_jnp(q).astype(jnp.float32),
                                _jnp(k).reshape(B * S, D),
                                _jnp(v).reshape(B * S, D), S, pos=pos)
    else:
        got = kvp.attend(q, torch.from_numpy(k8), torch.from_numpy(v8), pos,
                         H, torch.from_numpy(ks), torch.from_numpy(vs))
        want = jkv._attend_core(
            _jnp(q).astype(jnp.float32), jnp.asarray(k8).reshape(B * S, D),
            jnp.asarray(v8).reshape(B * S, D), S, pos=pos,
            k_scale=jnp.asarray(ks).reshape(B * S, 1),
            v_scale=jnp.asarray(vs).reshape(B * S, 1))
    want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == (B, D)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err


@pytest.mark.parametrize("mode", ["floor", "noattn"])
def test_floor_and_noattn_match_the_jax_kernel(jkv, mode):
    """The JAX probe's _kernel body for "floor" (column sums of the block's
    K and V rows plus q) and "noattn" (q * 1.0001), run on arrays standing
    in for its refs over one block of B clips, against the port's plain
    versions with block=B: equal (integer-valued slabs)."""
    (q, k, v), _ = _slabs(7, ints=True)
    o = np.zeros((B, D), np.float32)
    pos = np.asarray([S - 1], np.int32)
    jkv._kernel(pos, _jnp(q), _jnp(k).reshape(B * S, D),
                _jnp(v).reshape(B * S, D), o, mode=mode)
    want = np.asarray(jnp.asarray(o).astype(jnp.bfloat16).astype(jnp.float32))
    got = kvp.floor(q, k, v, block=B) if mode == "floor" else kvp.noattn(q)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_noattn_on_normal_values_matches_bit_for_bit(jkv):
    (q, _, _), _ = _slabs(3)
    o = np.zeros((B, D), np.float32)
    jkv._kernel(np.asarray([0], np.int32), _jnp(q), None, None, o,
                mode="noattn")
    want = np.asarray(jnp.asarray(o).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(kvp.noattn(q).float().numpy(), want)


def test_probe_accounting_is_the_jax_probe_s(jkv):
    """Slab bytes at the probe's B=32 (and at row 6's widths), and their
    bounds at 3.35 TB/s."""
    for b in (16, 32, 64):
        sb = kvp.slab_bytes(b, 300, 512)
        assert sb == dict(bf16=2 * b * 300 * 512 * 2,
                          int8=b * 300 * 512 * 2 + b * 300 * 2 * 4)
    sb = kvp.slab_bytes(jkv.B, jkv.S, jkv.D)
    assert (sb["bf16"], sb["int8"]) == (19_660_800, 9_907_200)
    assert round(sb["bf16"] / kvp.HBM_BYTES_PER_S * 1e6, 2) == 5.87
    assert round(sb["int8"] / kvp.HBM_BYTES_PER_S * 1e6, 2) == 2.96


# the dot_general probe's three forms at small shapes: (name, a, b, the
# JAX contraction dims, the port's form)
ROWS, DD, CC = 40, 48, 16
DOT_FORMS = [("NT logits", (ROWS, DD), (CC, DD), ((1,), (1,)), "NT"),
             ("TN pv", (ROWS, CC), (ROWS, DD), ((0,), (0,)), "TN"),
             ("NT tiny-diag", (CC, DD), (CC, DD), ((1,), (1,)), "NT")]


@pytest.mark.parametrize("ints", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,ash,bsh,dims,form", DOT_FORMS)
def test_dot_forms_match_the_jax_probe_kernel(jdot, name, ash, bsh, dims,
                                              form, dtype, ints):
    """Each form through the JAX probe's _kernel under pl.pallas_call in
    interpret mode (f32 out) against the port's probe_dot on CPU tensors
    (the f32 product): exact on integer-valued operands; normal operands
    in f32 within RTOL / ATOL, in bf16 (exact inputs, f32 sums) too."""
    r = np.random.default_rng(len(name) + ints)
    if ints:
        a, b = (r.integers(-4, 5, sh).astype(np.float32) for sh in (ash, bsh))
    else:
        a, b = (r.standard_normal(sh).astype(np.float32) for sh in (ash, bsh))
    ja, jb = (jnp.asarray(x).astype(getattr(jnp, dtype)) for x in (a, b))
    out_shape = jax.eval_shape(
        lambda x, y: jax.lax.dot_general(x, y, (dims, ((), ()))), ja, jb)
    want = np.asarray(pl.pallas_call(
        functools.partial(jdot._kernel, dims=dims),
        out_shape=jax.ShapeDtypeStruct(out_shape.shape, jnp.float32),
        interpret=True)(ja, jb))
    ta, tb = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in (ja, jb))
    got = pdg.probe_dot(ta, tb, form)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if ints:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_probes_dispatch_by_device_and_count_only_kernel_launches():
    """CPU tensors take the plain versions without touching the kernel
    library or the launch counters; the measuring entry points need the
    card."""
    before = (kvp.attend.launches, kvp.floor.launches, kvp.noattn.launches,
              pdg.probe_dot.launches)
    (q, k, v), _ = _slabs(1)
    kvp.attend(q, k, v, 3, H)
    kvp.floor(q, k, v, block=B)
    kvp.noattn(q)
    pdg.probe_dot(torch.ones(4, 8), torch.ones(2, 8), "NT")
    assert (kvp.attend.launches, kvp.floor.launches, kvp.noattn.launches,
            pdg.probe_dot.launches) == before
    assert "probes.cu" in kernels.SOURCES
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
            kvp.probe(B=2, S=12)
        with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
            pdg.probe()
