"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``_build/`` beside this file (listed in
``.gitignore``); the library's file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module, and
the CPU has no ``nvcc``. Each wrapper calls :func:`library` only on the
path that launches a kernel on a CUDA tensor.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import signal
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("flash_attention.cu", "decode_layer.cu", "selective_scan.cu",
           "decode_batch.cu", "flash_attention_dropout.cu",
           "decode_variant.cu", "decode_stack.cu", "probes.cu")
HEADERS = ("common.cuh", "batch_decode.cuh", "decode_step.cuh",
           "decode_rows.cuh", "attention_mma.cuh", "attention_tf32.cuh",
           "attention_wide.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_lib = None
_lock = threading.Lock()
build_log = ""  # the compiler's output of the last build (registers, spills)


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile every source (in parallel) and link one ``.so``; returns its
    path. A library already built from the same sources is reused."""
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libv2m_kernels_{_digest()}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objs.append(obj)
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, name),
                 "-o", obj], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                start_new_session=True)))
        logs = []
        for name, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode != 0:
                for _, other in procs:  # leave no compiler running
                    if other.poll() is None:
                        os.killpg(other.pid, signal.SIGKILL)
                        other.wait()
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], *objs,
                               "-o", tmp_so], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_so, so)
    build_log = "\n".join(logs)
    return so


class DecodeLayerArgs(ctypes.Structure):
    """Mirror of ``V2MDecodeLayer`` in csrc/decode_layer.cu (same order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "y",
        "wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo",
        "norm_scale", "norm_bias",
        "w1g", "b1g", "w2", "b2",
        "gate_w", "gate_b", "ew1g", "eb1g", "ew2", "eb2",
        "rope_cos", "rope_sin",
        "k_cache", "v_cache", "k_cross", "v_cross",
        "work", "sel",
        "token_root", "token_attr", "key",
        "emb_root", "emb_attr", "lc_w", "lc_krow", "lc_b",
        "dn_scale", "dn_bias", "wout", "bout", "logits",
        "wqkv_s", "wo_s", "cwq_s", "cwo_s", "w1g_s", "w2_s", "ew1g_s",
        "ew2_s")] + [
        (name, ctypes.c_int) for name in (
            "D", "H", "F", "E", "k_top", "Sm", "n_out", "pos")]


MAX_STACK_LAYERS = 16  # csrc/decode_stack.cu kMaxLayers
MAX_STACK_SPLITS = 16  # csrc/decode_stack.cu kMaxSplits
STACK_TILE_ROWS = 64   # csrc/decode_stack.cu kTileRows
# csrc/decode_stack.cu's probe: phase kinds a layer (Kind) and the u64
# stamps and u32 counters of its buffer (kProbeSlots)
STACK_PROBE_KINDS = ("qkv", "self_attention", "wo", "cross_q",
                     "cross_attention", "cwo", "ffn_up_router", "down")
STACK_PROBE_SLOTS = len(STACK_PROBE_KINDS) * MAX_STACK_LAYERS + 2


class StackLayerArgs(ctypes.Structure):
    """Mirror of ``V2MStackLayer`` in csrc/decode_stack.cu (same order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo",
        "norm_scale", "norm_bias", "w1g", "b1g", "w2", "b2",
        "gate_w", "gate_b", "ew1g", "eb1g", "ew2", "eb2",
        "k_cache", "v_cache", "k_cross", "v_cross")]


class StackArgs(ctypes.Structure):
    """Mirror of ``V2MStack`` in csrc/decode_stack.cu (same order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "y", "rope_cos", "rope_sin", "work", "attn", "sync", "sel",
        "token_root", "token_attr", "key",
        "emb_root", "emb_attr", "lc_w", "lc_krow", "lc_b",
        "dn_scale", "dn_bias", "wout", "bout", "logits", "probe")] + [
        (name, ctypes.c_int) for name in (
            "D", "H", "F", "E", "k_top", "S", "Sm", "n_out", "pos",
            "n_layers", "grid", "smem", "max_splits")] + [
        ("layers", StackLayerArgs * MAX_STACK_LAYERS)]


class BatchLayerArgs(ctypes.Structure):
    """Mirror of ``V2MBatchLayer`` in csrc/decode_batch.cu (same order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "y",
        "wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo",
        "norm_scale", "norm_bias", "w1g", "b1g", "w2", "b2",
        "rope_cos", "rope_sin",
        "k_cache", "v_cache", "k_cross", "v_cross", "work",
        "token_root", "token_attr", "key",
        "emb_root", "emb_attr", "lc_w", "lc_krow", "lc_b",
        "k_scale", "v_scale", "ck_scale", "cv_scale")] + [
        (name, ctypes.c_int) for name in (
            "shallow", "B", "D", "H", "F", "S", "Sm", "pos", "quant")]


class BatchMoeArgs(ctypes.Structure):
    """Mirror of ``V2MBatchMoe`` in csrc/decode_batch.cu (same order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x2", "out", "gate_w", "gate_b", "w1g", "b1g", "w2", "b2",
        "ew1g", "eb1g", "ew2", "eb2", "norm_scale", "norm_bias",
        "dn_scale", "dn_bias", "wout", "bout", "work", "sel")] + [
        (name, ctypes.c_int) for name in (
            "B", "D", "F", "E", "k_top", "n_out", "dense")]


class VariantArgs(ctypes.Structure):
    """Mirror of ``V2MVariant`` in csrc/decode_variant.cu (same order)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "y", "wqkv", "bqkv", "wo", "bo", "lam", "subw", "er",
        "cwq", "cbq", "cwo", "cbo", "clam", "csubw",
        "norm_scale", "norm_bias", "fw1g", "fb1g", "fw2", "fb2",
        "gate_w", "gate_b", "sw1g", "sb1g", "sw2", "sb2",
        "ew1g", "eb1g", "ew2", "eb2", "rope_cos", "rope_sin",
        "k_cache", "v_cache", "k_cross", "v_cross", "work", "sel",
        "wqkv_s", "wo_s", "cwq_s", "cwo_s", "fw1g_s", "fw2_s", "sw1g_s",
        "sw2_s", "ew1g_s", "ew2_s")] + [
        (name, ctypes.c_int) for name in (
            "B", "D", "H", "S", "Sm", "pos", "er_len", "attn", "cross",
            "ffn", "expert", "F", "Fe", "E", "k_top", "rms", "pre_norm",
            "dense")]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    pi = ctypes.POINTER(ctypes.c_int)
    lib.v2m_flash_attention.argtypes = [i, p, p, p, p, i, p, i, i, i, i, i,
                                        f, pi, p]
    lib.v2m_flash_attention.restype = i
    lib.v2m_decode_layer.argtypes = [i, ctypes.POINTER(DecodeLayerArgs), p]
    lib.v2m_decode_layer.restype = i
    lib.v2m_selective_scan.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i,
                                       p]
    lib.v2m_selective_scan.restype = i
    lib.v2m_batched_layer.argtypes = [i, ctypes.POINTER(BatchLayerArgs), p]
    lib.v2m_batched_layer.restype = i
    lib.v2m_batched_moe.argtypes = [i, ctypes.POINTER(BatchMoeArgs), p]
    lib.v2m_batched_moe.restype = i
    lib.v2m_batched_gemv.argtypes = [i, p, p, p, p, i, i, i, p]
    lib.v2m_batched_gemv.restype = i
    lib.v2m_attention_dropout_fwd.argtypes = [i, p, p, p, p, p, p, p, i, i, i,
                                              i, i, f, u, f, i, pi, p]
    lib.v2m_attention_dropout_fwd.restype = i
    lib.v2m_attention_dropout_bwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p,
                                              p, p, p, i, i, i, i, i, f, u, f,
                                              i, pi, p]
    lib.v2m_attention_dropout_bwd.restype = i
    lib.v2m_decode_stack_grid.argtypes = [i, i, i, i, i, i, pi, pi, pi]
    lib.v2m_decode_stack_grid.restype = i
    lib.v2m_decode_stack.argtypes = [i, ctypes.POINTER(StackArgs), p]
    lib.v2m_decode_stack.restype = i
    lib.v2m_kv_probe_attend.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i,
                                        i, i, p]
    lib.v2m_kv_probe_floor.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.v2m_kv_probe_noattn.argtypes = [p, p, i, p]
    lib.v2m_probe_dot.argtypes = [i, i, p, p, p, i, i, i, i, i, p]
    for name in ("v2m_kv_probe_attend", "v2m_kv_probe_floor",
                 "v2m_kv_probe_noattn", "v2m_probe_dot"):
        getattr(lib, name).restype = i
    for name in ("v2m_variant_layer", "v2m_variant_batched_layer",
                 "v2m_variant_batched_moe"):
        fn = getattr(lib, name)
        fn.argtypes = [i, ctypes.POINTER(VariantArgs), p]
        fn.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(build()))
        return _lib


def use_plain(t, what: str) -> bool:
    """Dispatch by device and nothing else: True for a CPU tensor (take the
    plain version), False for a CUDA tensor (launch the kernel); any other
    device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def dtype_code(t, what: str) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, "
                        f"got {t.dtype}")
    return DTYPE_CODES[name]


def require(cond: bool, what: str, msg: str) -> None:
    """Validate what the kernel can take; raise ValueError otherwise."""
    if not cond:
        raise ValueError(f"{what}: {msg}")


def require_like(tensors, ref, what: str) -> None:
    """Every tensor of the dict ``tensors`` must be contiguous, with ref's
    device and dtype."""
    for name, t in tensors.items():
        require(t.device == ref.device and t.dtype == ref.dtype
                and t.is_contiguous(), what,
                f"{name} must be a contiguous {ref.dtype} tensor on "
                f"{ref.device}")


def check(status: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def aligned(t):
    """t, contiguous, with its data at a multiple of 16 bytes: the bf16
    attention kernels copy rows in 16-byte pieces. A copy is made only of
    a tensor that is not (a view at an odd offset)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# the head sizes the attention kernels are built for
# (csrc/flash_attention.cu, csrc/flash_attention_dropout.cu,
# csrc/attention_mma.cuh, csrc/attention_tf32.cuh), and the column slice of the wide form above
# them (csrc/attention_wide.cuh kWide)
HEAD_SIZES = (16, 32, 64, 128, 256)
WIDE_SLICE = 64


def head_instance(D: int, what: str) -> tuple:
    """The attention kernels' plan for head size D: (instance width,
    slices). Up to 256 the smallest of HEAD_SIZES at least D, one slice
    (the wrappers pad q, k, v (and dO, O) with zero columns up to it, as
    the Pallas wrappers pad D to a multiple of 128: zero columns change
    neither q . k nor the kept columns of P . V); above, the head split
    across blocks of WIDE_SLICE output columns each, ceil(D / WIDE_SLICE)
    of them (the wrappers pad D to their sum). Raises on no positive D."""
    if D < 1:
        raise ValueError(f"{what}: head_dim {D}: no positive head size")
    for n in HEAD_SIZES:
        if D <= n:
            return n, 1
    return WIDE_SLICE, -(-D // WIDE_SLICE)


# The wide plan (csrc/attention_wide.cuh): one thread-block cluster a tile
# of WIDE_TILE query rows, its blocks splitting the head's slices and the
# tile's rows; in bf16 the forward's, in f32 the forward's and (its
# cluster) the backward's, a cluster a query or key tile. Its constants as
# the header has them (a CPU test reads them there:
# tests/test_torch_wide_attention.py).
WIDE_TILE = 64                 # query rows a cluster (kTile)
WIDE_CHUNK = 64                # keys a chunk (attention_mma.cuh kChunk)
WIDE_STAGES = 2                # cp.async ring stages (kStages)
WIDE_GROUP = 2                 # slices a block's products hold at once (kGroup)
WIDE_CLUSTER_MIN = 4           # a block owns at most 16 rows (kClusterMin)
WIDE_CLUSTER_MAX = 8           # the portable cluster size (kClusterMax)
WIDE_F32_PAD = 4               # floats an f32 piece's row is padded (kPadF32)
SMEM_MAX = 232448              # dynamic shared bytes a block (kSmemMax)

WidePlan = collections.namedtuple("WidePlan", "cluster slices passes smem")

_TILE_BYTES = WIDE_TILE * (WIDE_CHUNK + 8) * 4  # a 64 x 64 f32 tile (padded)
_PIECE_F32 = WIDE_CHUNK * (WIDE_SLICE + WIDE_F32_PAD) * 4  # an f32 piece


def _own_rows(cluster: int) -> int:
    return -(-WIDE_TILE // cluster)


def wide_smem(cluster: int, S: int, passes: int) -> int:
    """Dynamic shared bytes of a block of the bf16 wide forward
    (plan_smem): a cp.async ring of WIDE_STAGES stages of two 64 x
    WIDE_SLICE bf16 pieces (padded rows), two partial S tiles of WIDE_TILE
    x 64 f32 (padded rows), and the block's own rows of the tile (at most
    ceil(WIDE_TILE / cluster)): with one pass their logits (f32) and
    weights (bf16) over every key, with two two 64-key chunks of
    weights."""
    rows = _own_rows(cluster)
    keys = -(-S // WIDE_CHUNK) * WIDE_CHUNK
    ring = WIDE_STAGES * 2 * WIDE_CHUNK * (WIDE_SLICE + 8) * 2
    part = 2 * _TILE_BYTES
    if passes == 1:
        return ring + part + rows * (6 * keys + 16)
    return ring + part + 2 * rows * (WIDE_CHUNK + 8) * 2


def wide_resident_f32(cluster: int, slices: int) -> bool:
    """Whether a block of the f32 wide forward keeps its q slices in
    shared memory for the whole tile (fwd_resident_f32): the two-pass
    layout with them fits SMEM_MAX."""
    return ((WIDE_STAGES + slices) * _PIECE_F32 + 2 * _TILE_BYTES
            + 2 * _own_rows(cluster) * (WIDE_CHUNK + 8) * 4) <= SMEM_MAX


def wide_smem_f32(cluster: int, slices: int, S: int, passes: int) -> int:
    """Dynamic shared bytes of a block of the f32 wide forward
    (plan_smem_f32): the ring (WIDE_STAGES stages of one f32 piece of 64
    rows x WIDE_SLICE, K or V, or of two, q beside K, where q is not
    resident), the resident q slices, two partial S tiles, and the block's
    own rows: with one pass their logits, then weights in place, over
    every key (8 floats of padding a row), with two two chunks of
    weights."""
    rows = _own_rows(cluster)
    res = wide_resident_f32(cluster, slices)
    pieces = WIDE_STAGES + slices if res else 2 * WIDE_STAGES
    own = (rows * (-(-S // WIDE_CHUNK) * WIDE_CHUNK + 8) * 4 if passes == 1
           else 2 * rows * (WIDE_CHUNK + 8) * 4)
    return pieces * _PIECE_F32 + 2 * _TILE_BYTES + own


def wide_bwd_smem_f32(slices: int, dkv: bool) -> int:
    """Dynamic shared bytes of a block of the f32 wide backward's dQ
    (``dkv`` False) or dK / dV kernel (bwd_smem_f32): the ring (two f32
    pieces a stage of the side it streams), the own side (q and dO for dQ,
    K and V for dK / dV) resident where that fits (bwd_resident_f32), else
    streamed beside the other (four pieces a stage), the partial S and dP
    tiles and the pushed tiles (dS; or (P * mask)^T and dS^T). The launch
    computes it from the plan's slices."""
    tiles = (4 if dkv else 3) * _TILE_BYTES
    resident = (2 * slices + 2 * WIDE_STAGES) * _PIECE_F32 + tiles
    return resident if resident <= SMEM_MAX else \
        4 * WIDE_STAGES * _PIECE_F32 + tiles


def wide_one_pass_keys(cluster: int, slices: int = 0) -> int:
    """The largest S the wide forward takes in one pass with a cluster of
    this size: its block's rows of logits (and, in bf16, weights) over
    every key fit SMEM_MAX beside the ring and the partials; ``slices``
    (the plan's slices a block) gives the f32 forward's cut, which depends
    on them (its q slices resident or streamed), 0 the bf16 one's."""
    rows = _own_rows(cluster)
    if slices:
        room = SMEM_MAX - wide_smem_f32(cluster, slices, 0, 1)
        return room // (4 * rows) // WIDE_CHUNK * WIDE_CHUNK
    room = SMEM_MAX - wide_smem(cluster, 0, 1)
    return room // rows // 6 // WIDE_CHUNK * WIDE_CHUNK


def wide_plan(D: int, S: int, what: str, tiles: int, sms: int,
              f32: bool = False) -> WidePlan:
    """The wide forward's plan for head size D (above 256), S keys,
    ``tiles`` query tiles (B * H * ceil(L / WIDE_TILE)) and a card of
    ``sms`` streaming multiprocessors (device_sms), in bf16 or ``f32``:
    (cluster, slices, passes, smem). A cluster of min(slices of the head,
    WIDE_CLUSTER_MAX) blocks a tile, halved where its grid passes one wave
    of two blocks an SM and a block of the halved cluster still holds its
    slices' products at once (WIDE_GROUP): at head size 512, L = 300, four
    blocks of two slices ran faster than eight of one at B*H = 8 and 16
    and slower at 1 and 4 (bf16, an H100, 132 SMs). Block r owns the
    slices [r nd / C, (r + 1) nd / C), so ``slices`` = ceil(nd / C) at
    most; one pass where S is at most wide_one_pass_keys (f32: with the
    plan's slices), else two; ``smem`` the forward block's dynamic shared
    bytes (wide_smem, wide_smem_f32; the kernels take clusters of
    WIDE_CLUSTER_MIN .. WIDE_CLUSTER_MAX blocks, at most one a slice). The
    f32 backward runs the same cluster. Raises on a head the narrow
    instances take or no keys."""
    nd = head_instance(D, what)[1]
    require(nd > 1, what, f"head_dim {D}: the narrow instances take it, "
            f"no wide plan")
    require(S >= 1, what, f"{S} keys: no wide plan")
    cluster = min(nd, WIDE_CLUSTER_MAX)
    half = cluster // 2
    if (tiles * cluster > 2 * sms and half >= WIDE_CLUSTER_MIN
            and -(-nd // half) <= WIDE_GROUP):
        cluster = half
    slices = -(-nd // cluster)
    passes = 1 if S <= wide_one_pass_keys(cluster, slices if f32 else 0) \
        else 2
    smem = (wide_smem_f32(cluster, slices, S, passes) if f32
            else wide_smem(cluster, S, passes))
    return WidePlan(cluster, slices, passes, smem)


def wide_plan_arg(D: int, S: int, tiles: int, code: int, what: str,
                  device):
    """The plan as the attention entry points take it: four C ints above
    head size 256 (wide_plan in the call's dtype on ``device``'s card; the
    f32 backward reads its cluster), else None (a null pointer)."""
    if head_instance(D, what)[1] == 1:
        return None
    return (ctypes.c_int * 4)(*wide_plan(
        D, S, what, tiles, device_sms(device),
        f32=code == DTYPE_CODES["float32"]))


@functools.cache
def _sms(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sms(device) -> int:
    """The streaming multiprocessors of a CUDA device's card."""
    import torch
    device = torch.device(device)
    return _sms(torch.cuda.current_device() if device.index is None
                else device.index)


def padded_head(D: int, what: str) -> int:
    """The head size the kernels run for D: instance width x slices."""
    width, slices = head_instance(D, what)
    return width * slices


def pad_head(t, Dp: int):
    """t (..., D) with zero columns up to Dp (t itself when D == Dp)."""
    import torch
    D = t.shape[-1]
    return t if D == Dp else torch.nn.functional.pad(t, (0, Dp - D))


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None for an absent operand)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
