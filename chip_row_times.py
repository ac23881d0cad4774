#!/usr/bin/env python3
"""Rows 1-12 of the port's kernel table at their chip_smoke.py shapes, in
the checkout named on the command line, on one NVIDIA GPU.

    python3 chip_row_times.py CHECKOUT TAG [OUT_DIR]

builds CHECKOUT's kernels (into its own video2music_tpu_torch/_build/),
runs its chip_smoke.py kernel phases ("kernels", "stack kernels",
"batched kernels", "int8 KV kernels", "dropout kernels", "variant
kernels": every kernel against its plain version, then timed by CUDA-graph
replay) on a full-width Video2music of seed 0, and prints one line
``[TAG] ROWS {json}``: for every timed form, "<kernel> <form>": [bf16 ms,
f32 ms]; with OUT_DIR (relative to the directory it was started from)
the same object also goes to OUT_DIR/rows_TAG.json. To hold a change to
its parent, unpack the parent's ``git archive`` into a git-ignored
directory and run parent, change, change, parent in one call, each in
its own process (a process imports one checkout).
"""

import json
import os
import sys
import time


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
            ("variant kernels", cs.variant_kernel_phase, (report, v2m))):
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
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"rows_{tag}.json"), "w") as f:
            json.dump(rows, f)
    print(f"[{tag}] card: {cs.card_line()}")
    print(f"[{tag}] ROWS {json.dumps(rows)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
