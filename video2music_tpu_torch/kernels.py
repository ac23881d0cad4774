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

import ctypes
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
           "decode_variant.cu", "decode_stack.cu")
HEADERS = ("common.cuh", "batch_decode.cuh", "decode_step.cuh",
           "decode_rows.cuh", "attention_mma.cuh")
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
    lib.v2m_flash_attention.argtypes = [i, p, p, p, p, i, p, i, i, i, i, i,
                                        f, p]
    lib.v2m_flash_attention.restype = i
    lib.v2m_decode_layer.argtypes = [i, ctypes.POINTER(DecodeLayerArgs), p]
    lib.v2m_decode_layer.restype = i
    lib.v2m_selective_scan.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.v2m_selective_scan.restype = i
    lib.v2m_batched_layer.argtypes = [i, ctypes.POINTER(BatchLayerArgs), p]
    lib.v2m_batched_layer.restype = i
    lib.v2m_batched_moe.argtypes = [i, ctypes.POINTER(BatchMoeArgs), p]
    lib.v2m_batched_moe.restype = i
    lib.v2m_batched_gemv.argtypes = [i, p, p, p, p, i, i, i, p]
    lib.v2m_batched_gemv.restype = i
    lib.v2m_attention_dropout_fwd.argtypes = [i, p, p, p, p, p, p, p, i, i, i,
                                              i, i, f, u, f, i, p]
    lib.v2m_attention_dropout_fwd.restype = i
    lib.v2m_attention_dropout_bwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p,
                                              p, p, p, i, i, i, i, i, f, u, f,
                                              i, p]
    lib.v2m_attention_dropout_bwd.restype = i
    pi = ctypes.POINTER(ctypes.c_int)
    lib.v2m_decode_stack_grid.argtypes = [i, i, i, i, i, i, i, pi, pi]
    lib.v2m_decode_stack_grid.restype = i
    lib.v2m_decode_stack.argtypes = [i, ctypes.POINTER(StackArgs), p]
    lib.v2m_decode_stack.restype = i
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
# csrc/attention_mma.cuh)
HEAD_SIZES = (16, 32, 64, 128, 256)


def head_instance(D: int, what: str) -> int:
    """The attention kernel instance that takes head size D: the smallest
    of HEAD_SIZES at least D (the wrappers pad q, k, v (and dO, O) with
    zero columns up to it, as the Pallas wrappers pad D to a multiple of
    128: zero columns change neither q . k nor the kept columns of P . V)."""
    for n in HEAD_SIZES:
        if D <= n:
            return n
    raise ValueError(
        f"{what}: head_dim {D} above {HEAD_SIZES[-1]}: the widest instance "
        f"keeps two {HEAD_SIZES[-1]}-wide K/V chunks of 64 rows in shared "
        f"memory and a q row per thread in registers; a wider head needs "
        f"the head dimension split across blocks")


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
