#!/usr/bin/env python3
"""Time design alternatives of two hand-written kernels side by side on one
NVIDIA GPU: the cooperative whole-run decode kernel (csrc/decode_stack.cu)
and the selective scan (csrc/selective_scan.cu).

    python3 chip_variants.py        # from the root of a checkout

Each alternative is the committed source with one setting changed, built
with nvcc into its own library in a temporary directory and called through
the port's wrappers (its grid from its own v2m_decode_stack_grid), so all
of them run in one process on one card beside the committed design:
  * the cooperative kernel: 132 blocks of 256 threads, one an SM, and
    64-row attention tiles (kept); two blocks an SM (264 blocks, registers
    capped at 128 a thread); 132 blocks of 512 threads; 32-row tiles (more
    splits a head); every expert's [w1|wg] rows of a warp's routed unit
    prefetched to L2 before the MoE up phase's barrier: the six-layer
    bf16 / f32 run with the embed and the head and the three-layer MoE
    segment, pos 150, full width;
  * the scan: chunks of up to 256 steps (kept) or of 64; blocks of 128
    (kept) or 256 threads: b = 1 and 16, L = 300, ED = 128, N = 16.
Prints one line per alternative with its device ms (CUDA-graph replay) and
its largest error against the plain version, then the card's name and power
limit. Needs the CUDA toolkit; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))

# [(committed text, alternative text)] per alternative; a stack
# alternative with attention tiles of other than kernels.STACK_TILE_ROWS
# rows names them (its splits follow them, as the wrapper's do)
STACK = {
    "two blocks an SM": [("__launch_bounds__(NW * 32, 1)",
                          "__launch_bounds__(NW * 32, 2)")],
    "512 threads a block": [("constexpr int kStackWarps = 8;",
                             "constexpr int kStackWarps = 16;")],
    "32-row attention tiles": [("constexpr int kTileRows = 64;",
                                "constexpr int kTileRows = 32;")],
    "every expert's up rows to L2": [(
        "      mark(i, 16);\n",
        "      if (F + warp < slots * F)  // the rows of the warp's routed "
        "unit\n"
        "        for (int e = 0; e < E; ++e) {\n"
        "          prefetch_row<T>(ew1g + ((size_t)e * 2 * F + warp % F) * D,"
        " D, lane);\n"
        "          prefetch_row<T>(ew1g + ((size_t)e * 2 * F + F + warp % F)"
        " * D, D, lane);\n"
        "        }\n"
        "      mark(i, 16);\n")],
}
TILE_ROWS = {"32-row attention tiles": 32}
SCAN = {
    "chunks of 64 steps": [("constexpr int kMaxChunk = 256;",
                            "constexpr int kMaxChunk = 64;")],
    "256 threads a block": [("constexpr int kThreads = 128;",
                             "constexpr int kThreads = 256;")],
}


def start_build(tmp, name, source, edits):
    """Start nvcc on `source` with `edits` applied, in tmp/name; returns
    (process, library path)."""
    from video2music_tpu_torch import kernels
    d = os.path.join(tmp, name.replace(" ", "_"))
    shutil.copytree(kernels.CSRC, d)
    path = os.path.join(d, source)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in {source}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(d, "lib.so")
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS[:-2],
                             "-shared", path, "-o", so])
    return proc, so


def load(proc, so, source):
    """The built library, its entry points declared."""
    from video2music_tpu_torch import kernels
    if proc.wait() != 0:
        raise SystemExit(f"nvcc failed on {so}")
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    pi = ctypes.POINTER(ctypes.c_int)
    if source == "decode_stack.cu":
        lib.v2m_decode_stack_grid.argtypes = [i, i, i, i, i, i, pi, pi, pi]
        lib.v2m_decode_stack.argtypes = [i, ctypes.POINTER(kernels.StackArgs),
                                         vp]
    else:
        lib.v2m_selective_scan.argtypes = [i, vp, vp, vp, vp, vp, vp, vp,
                                           vp, i, i, i, i, vp]
    return lib


def stack_designs(v2m, libs):
    import torch

    import chip_smoke as cs
    from video2music_tpu_torch import kernels
    from video2music_tpu_torch.decode.fused import rope_tables
    from video2music_tpu_torch.ops import decode_stack as ds

    cfg = v2m.amt_cfg
    D, S, Sm = cfg.d_model, cfg.max_seq_chord, cfg.max_seq_video
    pos, dev = S // 2, v2m.device
    tokens = (torch.tensor([3], device=dev, dtype=torch.int32),
              torch.tensor([5], device=dev, dtype=torch.int32),
              torch.tensor([1.0], device=dev))
    gen = torch.Generator().manual_seed(97)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        model, _ = v2m._models(name)
        kw = dict(n_heads=cfg.num_heads, k_top=cfg.moe.n_experts_per_token,
                  rope=rope_tables(model, dev))
        packed = ds.pack_monolith(model)
        caches = [tuple(torch.randn(n, D, generator=gen).to(dev, dtype)
                        for n in (S, S, Sm, Sm))
                  for _ in cfg.decoder_layers]
        want = ds.decode_flat_monolith_plain(
            *tokens, pos, packed["layers"], packed,
            [tuple(c.clone() for c in cc) for cc in caches], **kw)
        seg = [s for s in ds.pack_decoder_segments(model)
               if s["kind"] == "moe"][0]
        cut = slice(seg["start"], seg["start"] + len(seg["layers"]))
        seg_caches = [torch.stack([c[j] for c in caches[cut]])
                      for j in range(4)]
        x = torch.randn(1, D, generator=gen).to(dev, dtype)
        for design, lib in libs.items():
            plans, seg_plans = {}, {}
            ds.decode_flat_monolith_step(
                *tokens, pos, packed["layers"], packed,
                [tuple(c.clone() for c in cc) for cc in caches],
                plans=plans, **kw)
            ds.decode_segment_step(x, pos, seg, *seg_caches,
                                   plans=seg_plans, **kw)
            run, seg_run = plans["run"], seg_plans["run"]
            if lib is not None:
                smem, blocks = ctypes.c_int(), ctypes.c_int()
                a = run.args
                if design in TILE_ROWS:
                    a.max_splits = min(kernels.MAX_STACK_SPLITS,
                                       -(-max(S, Sm) // TILE_ROWS[design]))
                    seg_run.args.max_splits = a.max_splits
                splits = ctypes.c_int(a.max_splits)
                cs.fail_unless(lib.v2m_decode_stack_grid(
                    run.code, a.D, a.H, a.F, a.E, a.k_top,
                    ctypes.byref(splits), ctypes.byref(smem),
                    ctypes.byref(blocks)) == 0, f"{design}: no grid")
                for r in (run, seg_run):
                    r.lib = lib
                    r.args.max_splits = splits.value
                    r.args.smem, r.args.grid = smem.value, blocks.value
            err = cs.errors(run.launch(pos, tokens=tokens), want)[1]
            ms = cs.time_ms(lambda: run.launch(pos, tokens=tokens))[0]
            ms_seg = cs.time_ms(lambda: seg_run.launch(pos, x=x))[0]
            print(f"stack design {design} [{name}]: grid {run.args.grid} "
                  f"blocks; six layers with the ends {ms:.4f} ms, MoE "
                  f"segment {ms_seg:.4f} ms (device); max rel error "
                  f"{err:.2e}", flush=True)


def scan_designs(v2m, libs):
    import torch

    import chip_smoke as cs
    from video2music_tpu_torch import kernels
    from video2music_tpu_torch.ops.scan import (selective_scan,
                                                selective_scan_plain)

    dev = v2m.device
    ED = v2m.model_reg.backbone.layers[0].mamba_forward.cfg.d_inner
    gen = torch.Generator().manual_seed(2468)
    N, L = 16, 300
    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 16):
            x = torch.randn(b, L, ED, generator=gen).to(dev, dtype)
            dt = (torch.rand(b, L, ED, generator=gen) * 0.1).to(dev, dtype)
            A = (-0.5 - 4 * torch.rand(ED, N, generator=gen)).to(dev)
            Bm, Cm = (torch.randn(b, L, N, generator=gen).to(dev, dtype)
                      for _ in range(2))
            Dv = torch.randn(ED, generator=gen).to(dev)
            want = selective_scan_plain(x, dt, A, Bm, Cm, Dv)
            for design, lib in libs.items():
                y = torch.empty_like(x)

                def go(lib=lib, y=y):
                    if lib is None:
                        y.copy_(selective_scan(x, dt, A, Bm, Cm, Dv))
                        return
                    cs.fail_unless(lib.v2m_selective_scan(
                        kernels.dtype_code(x, "scan"), *(kernels.ptr(t) for t
                        in (x, dt, A, Bm, Cm, Dv, y, None)), b, L, ED, N,
                        kernels.stream_of(x)) == 0, f"{design}: launch")
                go()
                err = cs.errors(y, want)[1]
                if lib is None:  # the wrapper's output, not the copy's time
                    ms = cs.time_ms(
                        lambda: selective_scan(x, dt, A, Bm, Cm, Dv))[0]
                else:
                    ms = cs.time_ms(go)[0]
                print(f"scan design {design} [{str(dtype)[6:]}] b={b}: "
                      f"{ms:.4f} ms (device); max rel error {err:.2e}",
                      flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from video2music_tpu_torch import kernels
    from video2music_tpu_torch.pipeline.api import Video2music

    kernels.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        builds = {(src, n): start_build(tmp, n, src, e)  # all in parallel
                  for src, table in (("decode_stack.cu", STACK),
                                     ("selective_scan.cu", SCAN))
                  for n, e in table.items()}
        libs = {key: load(*built, key[0]) for key, built in builds.items()}
        stack = {"kept": None}
        stack.update({n: libs["decode_stack.cu", n] for n in STACK})
        scan = {"kept": None}
        scan.update({n: libs["selective_scan.cu", n] for n in SCAN})
        v2m = Video2music(seed=0, device="cuda")
        stack_designs(v2m, stack)
        scan_designs(v2m, scan)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
