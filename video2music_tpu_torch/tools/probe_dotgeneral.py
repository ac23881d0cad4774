"""Do the product forms a tensor-core batched attention needs come out
right on the card (counterpart of tools/probe_dotgeneral.py, row 14 of the
kernel table; kernel csrc/probes.cu)?

    python -m video2music_tpu_torch.tools.probe_dotgeneral

  * NT logits    (rows, D) . (C, D)^T -> (rows, C)
  * TN pv        (rows, C)^T . (rows, D) -> (C, D)
  * NT tiny-diag (C, D) . (C, D)^T -> (C, C)

at rows = 2400, D = 512, C = 64, in f32 (through TF32 on the tensor cores)
and bf16, f32 accumulation. Prints a line per form with its error relative
to the f32 product and its time beside ``torch.matmul``'s (TF32 off), then
one JSON line. ``probe_dot`` dispatches by device: CPU tensors take the
plain f32 product (the tests hold it to the JAX probe's kernel), CUDA
tensors the kernel.
"""

from __future__ import annotations

import json

import torch

from .. import kernels
from . import card, graph_us, require_cuda

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
    kernels.require(a.is_contiguous() and a.dim() == 2 and b.dim() == 2,
                    what, "2-D contiguous operands")
    if form == "NT":  # a (M, K), b (N, K)
        (M, K), N = a.shape, b.shape[0]
        kernels.require(b.shape[1] == K, what, "NT: a (M, K), b (N, K)")
        strides = (K, 1, K, 1)
    else:  # TN: a (K, M), b (K, N)
        (K, M), N = a.shape, b.shape[1]
        kernels.require(b.shape[0] == K, what, "TN: a (K, M), b (K, N)")
        strides = (1, M, 1, N)
    lib = kernels.library()
    out = torch.empty(M, N, device=a.device, dtype=torch.float32)
    splits = lib.v2m_probe_dot_splits(M, N, K)  # K split over the grid
    work = None if splits == 1 else torch.empty(
        splits, M, N, device=a.device, dtype=torch.float32)
    status = lib.v2m_probe_dot(
        code, kernels.ptr(a), kernels.ptr(b), kernels.ptr(out),
        kernels.ptr(work), M, N, K, *strides, kernels.stream_of(a))
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


def probe(rows: int = 2400, D: int = 512, C: int = 64,
          iters: int = 50) -> dict:
    """Each form in f32 and bf16 on the card: ok, error, times; returns
    the JSON object."""
    dev = require_cuda("probe_dotgeneral")
    torch.backends.cuda.matmul.allow_tf32 = False
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
            mm = (lambda: a @ b.t()) if form == "NT" else (lambda: a.t() @ b)
            lib_us = graph_us(mm, iters)
            K = a.shape[1] if form == "NT" else a.shape[0]
            bound, by = bound_us(a, b, got, K, dtype)
            tag = f"{name} {'f32' if dtype == 'float32' else 'bf16'}"
            ok = err <= TOL[dtype]
            out[tag] = dict(ok=ok, rel_err=err, us=round(us, 3),
                            matmul_us=round(lib_us, 3),
                            bound_us=round(bound, 3), bound_by=by,
                            route="tf32" if dtype == "float32" else "bf16")
            print(f"{tag}: {'ok' if ok else 'FAIL'}, rel_err={err:.2e} "
                  f"(limit {TOL[dtype]:.0e}), {us:.2f} us, torch.matmul "
                  f"{lib_us:.2f} us", flush=True)
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
