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


# the edge shapes the redesigned kernels plan for differently (csrc/
# probes.cu): at B=2, S=300 the first cache length whose rows the core
# splits over a cluster of two, and the positions around it
EDGE_B, EDGE_S = 2, 300
SPLIT_ROWS = next(n for n in range(1, EDGE_S + 1)
                  if kvp.attend_plan(EDGE_B, H, n)[0] > 1)


def _edge_slabs(seed, Hh=H):
    """q (2, D) and bf16 K / V (2, 300, D); int8 K / V with row scales."""
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal(sh).astype(np.float32)
               for sh in ((EDGE_B, D), (EDGE_B, EDGE_S, D),
                          (EDGE_B, EDGE_S, D)))
    k8, v8 = (r.integers(-127, 128, (EDGE_B, EDGE_S, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (r.uniform(0.01, 0.1, (EDGE_B, EDGE_S)).astype(np.float32)
              for _ in range(2))
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)],
            (k8, v8, ks, vs))


def _core_against_jax(jkv, mode, pos, Hh):
    """The port's plain core against the JAX probe's _attend_core at B=2,
    S=300, Hh heads of D / Hh, within BF16_REL of the largest value."""
    (q, k, v), (k8, v8, ks, vs) = _edge_slabs(pos + Hh)
    rows = EDGE_B * EDGE_S
    if mode == "bf16":
        got = kvp.attend(q, k, v, pos, Hh)
        want = jkv._attend_core(_jnp(q).astype(jnp.float32),
                                _jnp(k).reshape(rows, D),
                                _jnp(v).reshape(rows, D), EDGE_S, pos=pos)
    else:
        got = kvp.attend(q, torch.from_numpy(k8), torch.from_numpy(v8), pos,
                         Hh, torch.from_numpy(ks), torch.from_numpy(vs))
        want = jkv._attend_core(
            _jnp(q).astype(jnp.float32), jnp.asarray(k8).reshape(rows, D),
            jnp.asarray(v8).reshape(rows, D), EDGE_S, pos=pos,
            k_scale=jnp.asarray(ks).reshape(rows, 1),
            v_scale=jnp.asarray(vs).reshape(rows, 1))
    want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16 and got.shape == (EDGE_B, D)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err


@pytest.mark.parametrize("pos", [0, SPLIT_ROWS - 2, SPLIT_ROWS - 1,
                                 EDGE_S - 1])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_attend_core_edge_positions_match_the_jax_probe(jkv, mode, pos):
    """pos 0, one below and at the first cluster split (rows SPLIT_ROWS - 1
    and SPLIT_ROWS: one block a (clip, head), then two), and pos S - 1, at
    S = 300 and B = 2."""
    assert kvp.attend_plan(EDGE_B, H, SPLIT_ROWS - 1)[0] == 1
    _core_against_jax(jkv, mode, pos, H)


@pytest.mark.parametrize("mode,hd", [("bf16", 8), ("bf16", 128),
                                     ("int8", 16), ("int8", 128)])
def test_attend_core_head_sizes_match_the_jax_probe(jkv, monkeypatch, mode,
                                                    hd):
    """Head sizes 8 and 128 (bf16) and 16 and 128 (int8, whose kernel takes
    multiples of 16): the JAX probe's module-level H set to D / hd, which
    its _attend_core reads (the head and row maps)."""
    monkeypatch.setattr(jkv, "H", D // hd)
    assert kvp.attend_fault(EDGE_B, EDGE_S, D, D // hd, EDGE_S - 1,
                            mode == "int8") is None
    _core_against_jax(jkv, mode, EDGE_S - 1, D // hd)


@pytest.mark.parametrize("Dd,block", [(8, 1), (40, 2)])
def test_floor_groups_match_the_jax_kernel(jkv, Dd, block):
    """The floor over several groups (B = 4 clips in groups of `block`) at
    D 8 and 40: the JAX probe's _kernel body for "floor", run group by
    group on its rows, against the port's plain floor; equal
    (integer-valued slabs)."""
    Bb, Ss = 4, 5
    r = np.random.default_rng(Dd)
    q, k, v = (torch.from_numpy(r.integers(-8, 9, sh).astype(np.float32))
               .to(torch.bfloat16) for sh in ((Bb, Dd), (Bb, Ss, Dd),
                                              (Bb, Ss, Dd)))
    want = np.zeros((Bb, Dd), np.float32)
    for g in range(Bb // block):
        o = np.zeros((block, Dd), np.float32)
        sl = slice(g * block, (g + 1) * block)
        jkv._kernel(np.asarray([Ss - 1], np.int32), _jnp(q[sl]),
                    _jnp(k[sl]).reshape(block * Ss, Dd),
                    _jnp(v[sl]).reshape(block * Ss, Dd), o, mode="floor")
        want[sl] = np.asarray(
            jnp.asarray(o).astype(jnp.bfloat16).astype(jnp.float32))
    got = kvp.floor(q, k, v, block=block)
    assert kvp.floor_fault(Bb, Ss, Dd, block) is None
    np.testing.assert_array_equal(got.float().numpy(), want)


# ragged products: K no multiple of 16 or 64, M and N no multiple of the
# kernel's 64-wide tiles
RAGGED_FORMS = [("NT logits", (70, 37), (65, 37), ((1,), (1,)), "NT"),
                ("TN pv", (100, 65), (100, 72), ((0,), (0,)), "TN"),
                ("NT tiny-diag", (65, 100), (65, 100), ((1,), (1,)), "NT")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,ash,bsh,dims,form", RAGGED_FORMS)
def test_dot_forms_ragged_shapes_match_the_jax_probe_kernel(
        jdot, name, ash, bsh, dims, form, dtype):
    """The three forms at ragged shapes through the JAX probe's _kernel in
    interpret mode against probe_dot on CPU tensors: exact on
    integer-valued operands (products and sums exact in f32)."""
    r = np.random.default_rng(len(name))
    a, b = (r.integers(-4, 5, sh).astype(np.float32) for sh in (ash, bsh))
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
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    M, N = got.shape
    K = ash[1] if form == "NT" else ash[0]
    assert pdg.dot_fault(M, N, K) is None


def test_cold_copies_read_twice_the_l2():
    """The cold timing's copy count: one pass over the copies reads at
    least twice the L2, and there are at least two."""
    from video2music_tpu_torch.tools import L2_BYTES, cold_copies
    for nbytes in (1, 131_072, 9_830_400, 19_660_800, 39_321_600,
                   60_000_000, 200_000_000):
        n = cold_copies(nbytes)
        assert n >= 2 and n * nbytes >= 2 * L2_BYTES
        assert n == 2 or (n - 1) * nbytes < 2 * L2_BYTES  # no more than that
    assert cold_copies(39_321_600) == 3  # the bf16 slabs at B = 64
    assert cold_copies(10, l2_bytes=100) == 20


def test_limit_predicates():
    """Each kernel's limits in one predicate (None: the kernel takes the
    shape): the core at any pos < S, bf16 head sizes that are multiples of
    8 up to 128, int8 multiples of 16 up to 128; the floor at D a multiple
    of 8 (no upper limit) with B a multiple of block; the products at any
    M, N, K >= 1."""
    ok = kvp.attend_fault
    assert ok(32, 300, 512, 8, 299, False) is None
    assert ok(1, 1, 8, 1, 0, False) is None  # one row, head size 8
    assert ok(2, 100_000, 512, 4, 99_999, True) is None  # any pos < S
    assert ok(2, 300, 1024, 8, 299, False) is None  # head size 128
    assert ok(2, 300, 96, 2, 0, False) is None  # head size 48
    for args in ((2, 300, 512, 8, 300, False), (2, 300, 512, 8, -1, False),
                 (2, 300, 512, 3, 0, False), (2, 300, 2048, 8, 0, False),
                 (2, 300, 96, 8, 0, False), (2, 300, 512, 64, 0, True),
                 (2, 300, 80, 2, 0, True)):
        assert isinstance(ok(*args), str), args
    assert kvp.floor_fault(32, 300, 512, 8) is None
    assert kvp.floor_fault(3, 7, 8, 1) is None
    assert kvp.floor_fault(8, 300, 4096, 8) is None  # wider than 2048
    for args in ((30, 300, 512, 8), (4, 300, 36, 2), (4, 0, 512, 2),
                 (4, 300, 512, 0)):
        assert isinstance(kvp.floor_fault(*args), str), args
    assert pdg.dot_fault(1, 1, 1) is None
    assert pdg.dot_fault(2400, 64, 512) is None
    assert pdg.dot_fault(64 * 65535, 1, 1) is None
    for args in ((0, 1, 1), (1, 0, 1), (1, 1, 0), (64 * 65535 + 1, 1, 1)):
        assert isinstance(pdg.dot_fault(*args), str), args


def test_plans_cover_every_row():
    """The plans the wrappers pass to the kernels: the core's cluster (1 to
    8, a power of two) times its rows a block covers the cache; the
    floor's slices cover D and its row ranges are no more than the rows;
    the products' K split keeps at least one K tile a block, and stages by
    16-byte copies only where the operands' rows are whole copies."""
    for B_, H_, rows in ((16, 8, 300), (32, 8, 300), (64, 8, 300),
                         (2, 8, 300), (2, 8, 1), (2, 4, 5000), (1, 1, 31)):
        cluster, per = kvp.attend_plan(B_, H_, rows)
        assert cluster in (1, 2, 4, 8)
        assert cluster * per >= rows > (cluster - 1) * per
    assert kvp.attend_plan(64, 8, 300) == kvp.attend_plan(16, 8, 300) == (
        1, 300)
    assert kvp.attend_plan(2, 8, 300)[0] == 8
    for B_, S_, D_, block in ((16, 300, 512, 8), (64, 300, 512, 8),
                              (3, 7, 8, 1), (16, 33, 2056, 8)):
        width, slices, chunks = kvp.floor_plan(B_, S_, D_, block)
        assert width % 8 == 0 and width <= 256 and width * slices >= D_
        assert 1 <= chunks <= block * S_
    for form, M, N, K, item in (("NT", 2400, 64, 512, 2),
                                ("TN", 64, 512, 2400, 4),
                                ("NT", 64, 64, 512, 2), ("NT", 70, 65, 37, 2),
                                ("TN", 65, 100, 70, 4)):
        cluster, vec = pdg.dot_plan(form, M, N, K, item)
        assert cluster in (1, 2, 4, 8)
        assert -(-K // (128 // item)) >= cluster
        unit = 16 // item
        assert vec == (K % unit == 0 if form == "NT"
                       else M % unit == 0 and N % unit == 0)
