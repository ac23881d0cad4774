"""CLI: the published CLIP weights into the port
(``python -m video2music_tpu_torch.cli.convert_clip``).

    python -m video2music_tpu_torch.cli.convert_clip \\
        --model /path/to/clip-vit-large-patch14-336 \\
        --out weights/clip_l14_336.pt

The counterpart of the JAX package's tools/convert_clip.py. ``--model`` is
a local HuggingFace checkpoint directory (openai/clip-vit-large-patch14-336,
the reference's CLIP, as ``save_pretrained`` writes it: config, weights,
tokenizer files); nothing is fetched, and a path that does not exist
raises. Writes

  * ``--out``: a ``torch.save``d state dict of features.clip.CLIP at the
    checkpoint's own config (features.clip.convert_hf_clip), which
    ``extract_features -clip_params`` and ``Video2music(clip_params=...)``
    read;
  * ``<out without .pt>_text_embeds.npy``: the (6, projection_dim)
    unnormalised text embeddings of the six emotion prompts from HF's
    ``get_text_features`` (``extract_features -text_embeds``,
    ``Video2music(emotion_text_embeds=...)``): the runtime needs no
    tokenizer.

On ``-device`` (``cuda`` unless given; without CUDA it raises) the
prompts run through HF's text tower, and the converted image and text
towers are held to HF's forward on two seeded images and the prompts, in
float32 (largest error over the largest magnitude at most CHECK_REL).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..features.clip import (CLIP, CLIPConfig, CLIPTextConfig,
                             CLIPVisionConfig, EMOTION_PROMPTS,
                             convert_hf_clip)
from ..train.step import resolve_device
from .train_amt import add_device_flag

CHECK_REL = 1e-3  # f32 on both sides; other summation orders only


def clip_config(hf_config) -> CLIPConfig:
    """The port's CLIPConfig of a HF ``CLIPConfig`` (ViT-L/14@336 for the
    reference's checkpoint)."""
    v, t = hf_config.vision_config, hf_config.text_config
    return CLIPConfig(
        vision=CLIPVisionConfig(
            hidden_size=v.hidden_size, layers=v.num_hidden_layers,
            heads=v.num_attention_heads, patch_size=v.patch_size,
            image_size=v.image_size,
            mlp_ratio=v.intermediate_size // v.hidden_size,
            projection_dim=hf_config.projection_dim),
        text=CLIPTextConfig(
            hidden_size=t.hidden_size, layers=t.num_hidden_layers,
            heads=t.num_attention_heads, vocab_size=t.vocab_size,
            context_length=t.max_position_embeddings,
            mlp_ratio=t.intermediate_size // t.hidden_size,
            projection_dim=hf_config.projection_dim))


def _check(name, got, want):
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"  {name}: max error / max |HF| {rel:.3e} (at most {CHECK_REL})")
    if not rel <= CHECK_REL:
        raise RuntimeError(f"convert_clip: the converted {name} differs from "
                           f"HF's forward ({rel:.3e} > {CHECK_REL})")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert HF CLIP weights into the port's CLIP")
    p.add_argument("--model", required=True,
                   help="local HF checkpoint directory of "
                        "openai/clip-vit-large-patch14-336")
    p.add_argument("--out", default="weights/clip_l14_336.pt")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if not os.path.isdir(args.model):
        raise FileNotFoundError(f"--model {args.model!r} is not a local "
                                "checkpoint directory")
    from transformers import CLIPModel, CLIPTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hf = CLIPModel.from_pretrained(args.model, local_files_only=True)
    hf = hf.float().eval().to(device)
    tok = CLIPTokenizer.from_pretrained(args.model, local_files_only=True)
    cfg = clip_config(hf.config)
    state = convert_hf_clip(hf.state_dict(), cfg)

    ids = tok(list(EMOTION_PROMPTS), padding=True, return_tensors="pt")
    ids = {k: v.to(device) for k, v in ids.items()}
    with torch.device(device):
        model = CLIP(cfg)
    model.load_state_dict(state)
    model.eval()
    gen = torch.Generator().manual_seed(0)
    size = cfg.vision.image_size
    pixels = torch.randn(2, size, size, 3, generator=gen).to(device)
    with torch.no_grad():
        text_embeds = hf.get_text_features(**ids)
        _check("text tower", model.encode_text(ids["input_ids"]),
               text_embeds)
        _check("image tower", model.encode_image(pixels),
               hf.get_image_features(pixels.permute(0, 3, 1, 2)))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    torch.save(state, args.out)
    embeds_path = args.out.removesuffix(".pt") + "_text_embeds.npy"
    np.save(embeds_path, text_embeds.cpu().numpy())
    print(f"wrote {args.out} and {embeds_path} "
          f"{tuple(text_embeds.shape)}")


if __name__ == "__main__":
    main()
