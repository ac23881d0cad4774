"""Do the product forms a tensor-core batched attention needs come out
right on the card (counterpart of tools/probe_dotgeneral.py, row 14 of the
kernel table; kernel csrc/probes.cu)?

    python -m video2music_tpu_torch.tools.probe_dotgeneral

  * NT logits    (rows, D) . (C, D)^T -> (rows, C)
  * TN pv        (rows, C)^T . (rows, D) -> (C, D)
  * NT tiny-diag (C, D) . (C, D)^T -> (C, C)

at rows = 2400, D = 512, C = 64, in f32 (through TF32 on the tensor cores)
and bf16, f32 accumulation, each one launch of csrc/probes.cu dot_kernel
(K split over a thread-block cluster where the output has few tiles).
Prints a line per form with its error relative to the f32 product and its
time warm (the same operands every call) and cold (calls rotating over
enough copies that one pass reads twice the L2) beside ``torch.matmul``'s
(TF32 off for the f32 product; on, as ``matmul_tf32_us``, for the TF32
forms' yardstick), then one JSON line. ``probe_dot`` dispatches by device:
CPU tensors take the plain f32 product (the tests hold it to the JAX
probe's kernel), CUDA tensors the kernel, whose limits :func:`dot_fault`
states.
"""

from __future__ import annotations

import json

import torch

from .. import kernels
from . import (card, cold_copies, cold_us, graph_us, l2_bytes, require_cuda,
               sm_count)

HBM_BYTES_PER_S = 3.35e12
PEAK = {"float32": 495e12, "bfloat16": 989e12}  # TF32, bf16 tensor cores
# error relative to the f32 product's largest value: TF32 keeps 10
# mantissa bits, bf16 inputs are exact in f32 (their products are summed
# in f32)
TOL = {"float32": 5e-3, "bfloat16": 1e-4}
# form: (a's shape, b's shape, the contraction as in the JAX probe)
FORMS = {"NT logits": ("rows D", "C D", "NT"),
         "TN pv": ("rows C", "rows D", "TN"),
         "NT tiny-diag": ("C D", "C D", "NT")}
TILE = 64         # output tile a block computes (csrc/probes.cu)
MAX_CLUSTER = 8   # blocks K is split over
MAX_GRID_Y = 65535


def dot_fault(M: int, N: int, K: int):
    """Why the product's kernel cannot take this shape, or None: M, N, K
    at least 1 and at most 65535 row tiles of 64 (the grid's y)."""
    if min(M, N, K) < 1:
        return f"M={M}, N={N}, K={K}: each must be at least 1"
    if -(-M // TILE) > MAX_GRID_Y:
        return f"M={M}: more than {MAX_GRID_Y} row tiles of {TILE}"
    return None


def dot_plan(form: str, M: int, N: int, K: int, itemsize: int,
             sms: int = 132) -> tuple:
    """(cluster, vec): K split over a thread-block cluster of ``cluster``
    blocks, doubled (up to MAX_CLUSTER) while the output's 64 x 64 tiles
    times twice it stay within the card's SMs and each block keeps at
    least one K tile of 128 bytes; ``vec`` when the operands' contiguous
    rows (K for NT, M and N for TN) are whole 16-byte copies."""
    depth = 128 // itemsize
    tiles = -(-M // TILE) * -(-N // TILE)
    ktiles = -(-K // depth)
    cluster = 1
    while (cluster < MAX_CLUSTER and tiles * cluster * 2 <= sms
           and ktiles >= 2 * cluster):
        cluster *= 2
    unit = 16 // itemsize
    vec = K % unit == 0 if form == "NT" else M % unit == 0 and N % unit == 0
    return cluster, vec


def probe_dot_plain(a, b, form: str):
    """The f32 product: NT a . b^T (contract the last dims), TN a^T . b
    (contract the first)."""
    a, b = a.float(), b.float()
    return a @ b.t() if form == "NT" else a.t() @ b


def probe_dot(a, b, form: str):
    """:func:`probe_dot_plain` on the card's tensor cores: f32 out, a and b
    f32 (TF32) or bf16."""
    what = "probe_dotgeneral"
    if kernels.use_plain(a, what):
        return probe_dot_plain(a, b, form)
    code = kernels.dtype_code(a, what)
    kernels.require_like({"b": b}, a, what)
    kernels.require(a.is_contiguous() and a.dim() == 2 and b.dim() == 2
                    and form in ("NT", "TN"), what,
                    "2-D contiguous operands, form NT or TN")
    if form == "NT":  # a (M, K), b (N, K)
        (M, K), N = a.shape, b.shape[0]
        kernels.require(b.shape[1] == K, what, "NT: a (M, K), b (N, K)")
    else:  # TN: a (K, M), b (K, N)
        (K, M), N = a.shape, b.shape[1]
        kernels.require(b.shape[0] == K, what, "TN: a (K, M), b (K, N)")
    fault = dot_fault(M, N, K)
    kernels.require(fault is None, what, str(fault))
    cluster, vec = dot_plan(form, M, N, K, a.element_size(),
                            sm_count(a.device))
    vec = vec and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    out = torch.empty(M, N, device=a.device, dtype=torch.float32)
    status = kernels.library().v2m_probe_dot(
        code, 0 if form == "NT" else 1, kernels.ptr(a), kernels.ptr(b),
        kernels.ptr(out), M, N, K, cluster, int(vec), kernels.stream_of(a))
    kernels.check(status, what)
    probe_dot.launches += 1
    return out


probe_dot.launches = 0


def bound_us(a, b, out, K: int, dtype: str) -> tuple:
    """(us, "bytes" or "operations"): the larger of the bytes (inputs read
    once, the f32 output written once) at 3.35 TB/s and the 2 M N K
    operations at the dtype's tensor-core peak."""
    M, N = out.shape
    t_bytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
               + out.numel() * 4) / HBM_BYTES_PER_S
    t_ops = 2 * M * N * K / PEAK[dtype]
    return (max(t_bytes, t_ops) * 1e6,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(a, b, form: str):
    """The one torch.matmul call for the same product."""
    return (lambda: a @ b.t()) if form == "NT" else (lambda: a.t() @ b)


def cold_dot_us(a, b, form: str, l2: int, call=None) -> float:
    """``probe_dot`` (or ``call(a, b, form)``'s product) with the caches
    cold: each call on its own copies of a and b."""
    n = cold_copies(a.numel() * a.element_size()
                    + b.numel() * b.element_size(), l2)
    copies = [(a.clone(), b.clone()) for _ in range(n)]
    make = call or (lambda x, y, f: (lambda: probe_dot(x, y, f)))
    return cold_us([make(x, y, form) for x, y in copies])


def probe(rows: int = 2400, D: int = 512, C: int = 64,
          iters: int = 50) -> dict:
    """Each form in f32 and bf16 on the card: ok, error, times warm and
    cold, torch.matmul's (TF32 off, and on for the f32 forms); returns the
    JSON object."""
    dev = require_cuda("probe_dotgeneral")
    torch.backends.cuda.matmul.allow_tf32 = False
    l2 = l2_bytes(dev)
    dims = dict(rows=rows, D=D, C=C)
    out = {}
    for dtype in ("float32", "bfloat16"):
        for name, (ash, bsh, form) in FORMS.items():
            g = torch.Generator(device=dev).manual_seed(len(out))
            a, b = (torch.randn(*(dims[d] for d in sh.split()), generator=g,
                                device=dev).to(getattr(torch, dtype))
                    for sh in (ash, bsh))
            got = probe_dot(a, b, form)
            want = probe_dot_plain(a, b, form)
            err = (got - want).abs().max().item() / max(
                want.abs().max().item(), 1e-30)
            us = graph_us(lambda: probe_dot(a, b, form), iters)
            cold = cold_dot_us(a, b, form, l2)
            lib_us = graph_us(library_call(a, b, form), iters)
            lib_cold = cold_dot_us(a, b, form, l2, call=library_call)
            K = a.shape[1] if form == "NT" else a.shape[0]
            bound, by = bound_us(a, b, got, K, dtype)
            tag = f"{name} {'f32' if dtype == 'float32' else 'bf16'}"
            ok = err <= TOL[dtype]
            out[tag] = dict(ok=ok, rel_err=err, us=round(us, 3),
                            cold_us=round(cold, 3),
                            matmul_us=round(lib_us, 3),
                            cold_matmul_us=round(lib_cold, 3),
                            bound_us=round(bound, 3), bound_by=by,
                            route="tf32" if dtype == "float32" else "bf16")
            if dtype == "float32":  # the TF32 forms' yardstick
                torch.backends.cuda.matmul.allow_tf32 = True
                out[tag]["matmul_tf32_us"] = round(
                    graph_us(library_call(a, b, form), iters), 3)
                torch.backends.cuda.matmul.allow_tf32 = False
            print(f"{tag}: {'ok' if ok else 'FAIL'}, rel_err={err:.2e} "
                  f"(limit {TOL[dtype]:.0e}), {us:.2f} us warm, {cold:.2f} "
                  f"us cold, torch.matmul {lib_us:.2f} / {lib_cold:.2f} us"
                  + (f", TF32 {out[tag]['matmul_tf32_us']:.2f} us"
                     if dtype == "float32" else ""), flush=True)
    out["card"] = card()
    return out


def main() -> None:
    result = probe()
    print(json.dumps(result), flush=True)
    if not all(v["ok"] for k, v in result.items() if k != "card"):
        raise SystemExit("probe_dotgeneral: a form disagrees with the f32 "
                         "product")


if __name__ == "__main__":
    main()
