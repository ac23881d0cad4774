#!/usr/bin/env python3
"""Rows 1-12 of the port's kernel table at their chip_smoke.py shapes, in
the checkout named on the command line, on one NVIDIA GPU.

    python3 chip_row_times.py CHECKOUT TAG [OUT_DIR]

builds CHECKOUT's kernels (into its own video2music_tpu_torch/_build/),
runs its chip_smoke.py kernel phases ("kernels", "stack kernels",
"batched kernels", "int8 KV kernels", "dropout kernels", "variant
kernels", "head sizes", "raw video kernels": every kernel against its
plain version, then timed by CUDA-graph replay) on a full-width
Video2music of seed 0, and prints one line ``[TAG] ROWS {json}``: for
every timed form, "<kernel> <form>": [bf16 ms, f32 ms]. Then the f32 train
step of the train_amt command line (AMT 2.2, motion_type 1, TrainConfig's
defaults: float32, B=32, L=300): ms per step (CUDA events over 5 steps)
and the device share of row 11's kernels in 3 steps under torch.profiler,
``[TAG] F32_STEP {json}``; the same step at -num_heads 1 (head size 512:
row 11 on the wide kernels), ``[TAG] F32_STEP_HD512 {json}``; and the
count of each tensor-core instruction
kind in the library's SASS, ``[TAG] HMMA {json}`` (cuobjdump -sass). With
OUT_DIR (relative to the directory it was started from) the rows also go
to OUT_DIR/rows_TAG.json and every kernel's registers, shared memory and
stack (cuobjdump -res-usage) to OUT_DIR/resusage_TAG.txt. To hold a
change to its parent, unpack the
parent's ``git archive`` into a git-ignored directory and run parent,
change, change, parent in one call, each in its own process (a process
imports one checkout).
"""

import collections
import json
import os
import re
import subprocess
import sys
import time


def cuobjdump(kernels, flag: str) -> str:
    """cuobjdump's output for the built kernel library (nvcc's toolkit)."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    return subprocess.run([tool, flag, kernels.build()], capture_output=True,
                          text=True, check=True).stdout


# row 11's kernels by name in a trace: chip_smoke.ROW11_TRACE_NAMES (head
# sizes to 256) and the wide instances above (csrc/attention_wide.cuh; a
# train step runs no row 1 forward)
ROW11_WIDE_NAMES = ("attention_fwd_wide", "attention_dq_wide",
                    "attention_dkv_wide")


def f32_train_step(cs, B=32, L=300, steps=5, traced=3, num_heads=8):
    """ms per f32 train step of the train_amt CLI's model (at its
    -num_heads) and the device share of row 11's kernels in ``traced``
    steps (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from video2music_tpu_torch.core.config import TrainConfig, amt_config
    from video2music_tpu_torch.train import (create_train_state,
                                             make_amt_train_step)

    cfg = amt_config("2.2", num_heads=num_heads,
                     total_vf_dim=768 + 1 + 512 + 6)
    tcfg = TrainConfig(batch_size=B)
    state = create_train_state(cfg, tcfg, device="cuda")
    step = make_amt_train_step(tcfg)
    batch = cs.zoo_batch("amt", B, L, seed=0)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        state, _ = step(state, batch)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(traced):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(r[0] for r in rows)
    row11 = sum(r[0] for r in rows
                if any(n in r[1] for n in
                       cs.ROW11_TRACE_NAMES + ROW11_WIDE_NAMES))
    return dict(B=B, num_heads=num_heads, ms_step=ms,
                device_ms_step=total / 1e3 / traced,
                row11_ms_step=row11 / 1e3 / traced,
                row11_share=row11 / max(total, 1e-9))


def main() -> int:
    out_dir = os.path.abspath(sys.argv[3]) if len(sys.argv) > 3 else None
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("chip_row_times: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from video2music_tpu_torch import kernels
    t0 = time.perf_counter()
    kernels.library()
    print(f"[{tag}] built in {time.perf_counter() - t0:.1f} s", flush=True)
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from video2music_tpu_torch.pipeline.api import Video2music
    v2m = Video2music(seed=0, device="cuda")
    report = {n: {} for n in cs.KERNELS}
    for name, fn, args in (
            ("kernels", cs.kernel_phase, (report, v2m)),
            ("stack kernels", cs.stack_kernel_phase, (report, v2m)),
            ("batched kernels", cs.batched_kernel_phase, (report, v2m)),
            ("int8 KV kernels", cs.int8_kv_kernel_phase, (report, v2m)),
            ("dropout kernels", cs.dropout_kernel_phase,
             (report, v2m.amt_cfg)),
            ("variant kernels", cs.variant_kernel_phase, (report, v2m)),
            ("head sizes", cs.head_size_phase, (report, card)),
            ("raw video kernels", cs.raw_video_kernel_phase,
             (report, card))):
        t = time.perf_counter()
        fn(*args)
        print(f"[{tag}] phase {name}: {time.perf_counter() - t:.1f} s",
              flush=True)
    rows = {}
    for name, r in report.items():
        for k, v in r.items():
            if k.startswith("ms") and isinstance(v, dict) \
                    and torch.bfloat16 in v:
                rows[f"{name} {k}"] = [v[torch.bfloat16][0],
                                       v[torch.float32][0]]
    del v2m
    torch.cuda.empty_cache()
    step = f32_train_step(cs)
    torch.cuda.empty_cache()
    step512 = f32_train_step(cs, num_heads=1)
    hmma = collections.Counter(re.findall(r"HMMA\.[\w.]+",
                                          cuobjdump(kernels, "-sass")))
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"rows_{tag}.json"), "w") as f:
            json.dump(rows, f)
        with open(os.path.join(out_dir, f"resusage_{tag}.txt"), "w") as f:
            f.write(cuobjdump(kernels, "-res-usage"))
    print(f"[{tag}] card: {card}")
    print(f"[{tag}] ROWS {json.dumps(rows)}")
    print(f"[{tag}] F32_STEP {json.dumps(step)}")
    print(f"[{tag}] F32_STEP_HD512 {json.dumps(step512)}")
    print(f"[{tag}] HMMA {json.dumps(dict(sorted(hmma.items())))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
