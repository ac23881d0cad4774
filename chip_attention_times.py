#!/usr/bin/env python3
"""Time the encoder attention kernel (row 1) and the dropout attention
forward (row 11) of the checkout this script sits in, on one NVIDIA GPU.

    python3 chip_attention_times.py

Prints one line: row 1 in float32 and bfloat16 at the AMT encoder's B=1
and B=16 shapes (H=8, L=S=300, D=64), CLIP ViT-L/14's (B=30, H=16, L=577)
and, where the wrapper takes ``scale=``, MaxViT-T's stage 0 (B=1920, H=2,
L=49, D=32, a bias shared by every window) and stage 3 (B=30, H=16), each
with its error against the plain version; then the dropout forward at the
training shape (B=16, H=8, L=300, rate 0.1), causal and not. Device ms
per call from a replayed CUDA graph (chip_smoke.time_ms), the least of 3.
Run it from two checkouts in turns (parent, change, change, parent) to
compare them on one card.
"""

import inspect
import os
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_attention_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from video2music_tpu_torch import kernels
    from video2music_tpu_torch.ops import flash_attention_dropout as fad
    from video2music_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    kernels.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    takes_scale = "scale" in inspect.signature(flash_attention).parameters
    out = []
    for tag, B, H, L, D, bias_heads, scale in (
            ("b1", 1, 8, 300, 64, 0, None), ("b16", 16, 8, 300, 64, 0, None),
            ("clip", 30, 16, 577, 64, 0, None),
            ("maxvit_s0", 1920, 2, 49, 32, 2, 64 ** -0.5),
            ("maxvit_s3", 30, 16, 49, 32, 16, 512 ** -0.5)):
        if bias_heads and not takes_scale:
            continue
        kw = {} if not bias_heads else dict(scale=scale, bias=(
            0.02 * torch.randn(1, H, L, L, generator=gen)).cuda())
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(B, H, L, D, generator=gen).to("cuda", dt)
                       for _ in range(3))
            err = cs.errors(flash_attention(q, k, v, **kw),
                            flash_attention_plain(q, k, v, **kw))[1]
            ms = min(cs.time_ms(lambda: flash_attention(q, k, v, **kw))[0]
                     for _ in range(3))
            out.append(f"{tag} {str(dt)[6:]} {ms:.4f} ms (rel err {err:.1e})")
    seed = torch.tensor([7], dtype=torch.int32, device="cuda")
    for causal in (False, True):
        q, k, v = (torch.randn(16, 8, 300, 64, generator=gen)
                   .to("cuda", torch.bfloat16) for _ in range(3))
        ms = min(cs.time_ms(lambda: fad.flash_attention_dropout_fwd(
            q, k, v, None, seed, causal, 0.1))[0] for _ in range(3))
        out.append(f"dropout fwd{' causal' if causal else ''} {ms:.4f} ms")
    print(f"{cs.card_line()} | " + "; ".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
