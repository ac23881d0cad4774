"""CLI: the published MaxViT-T weights into the port
(``python -m video2music_tpu_torch.cli.convert_maxvit``).

    python -m video2music_tpu_torch.cli.convert_maxvit \\
        --model /path/to/maxvit_t-bc5ab103.pth --out weights/maxvit_t.pt

The counterpart of the JAX package's tools/convert_maxvit.py. ``--model``
is a local file of torchvision's ``maxvit_t`` ImageNet weights (the state
dict ``MaxVit_T_Weights.IMAGENET1K_V1`` names, the reference's motion
embedder, video2music.py:298-305); nothing is fetched, and a path that
does not exist raises. The weights load into torchvision's own
``maxvit_t()`` graph (strict), so torchvision must be installed (the
reference pins 0.18.1); without it the script raises. Writes ``--out``, a
``torch.save``d state dict of features.maxvit.MaxViT with every BatchNorm
folded (features.maxvit.convert_torchvision_maxvit), which
``extract_features -maxvit_params`` and ``Video2music(maxvit_params=...)``
read.

On ``-device`` (``cuda`` unless given; without CUDA it raises) the
converted model is held to torchvision's with the reference's classifier
swap (global average pooling, 512-d) on two seeded images, in float32
(largest error over the largest magnitude at most CHECK_REL).
"""

from __future__ import annotations

import argparse
import os

import torch
from torch import nn

from ..features.maxvit import (MaxViT, convert_torchvision_maxvit,
                               maxvit_t_config)
from ..train.step import resolve_device
from .train_amt import add_device_flag

CHECK_REL = 1e-3  # f32 on both sides; other summation orders only


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert torchvision maxvit_t weights into the port's "
                    "MaxViT")
    p.add_argument("--model", required=True,
                   help="local file of torchvision's maxvit_t weights")
    p.add_argument("--out", default="weights/maxvit_t.pt")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if not os.path.isfile(args.model):
        raise FileNotFoundError(f"--model {args.model!r} is not a local "
                                "weights file")
    try:
        from torchvision.models import maxvit_t
    except ImportError as e:
        raise RuntimeError(
            "convert_maxvit loads the weights into torchvision's maxvit_t "
            "graph, and torchvision is not installed (the reference pins "
            "torchvision 0.18.1)") from e

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tv = maxvit_t()
    tv.load_state_dict(torch.load(args.model, map_location="cpu",
                                  weights_only=True))
    cfg = maxvit_t_config()
    state = convert_torchvision_maxvit(tv.state_dict(), cfg)

    # the reference's feature extractor (video2music.py:299-302)
    tv.classifier = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten())
    tv = tv.eval().to(device)
    with torch.device(device):
        model = MaxViT(cfg)
    model.load_state_dict(state)
    model.eval()
    size = cfg.image_size
    x = torch.randn(2, size, size, 3,
                    generator=torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        got, want = model(x), tv(x.permute(0, 3, 1, 2))
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"  features: max error / max |torchvision| {rel:.3e} "
          f"(at most {CHECK_REL})")
    if not rel <= CHECK_REL:
        raise RuntimeError(f"convert_maxvit: the converted model differs "
                           f"from torchvision's ({rel:.3e} > {CHECK_REL})")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    torch.save(state, args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
