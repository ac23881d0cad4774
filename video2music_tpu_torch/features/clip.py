"""CLIP (vision and text towers) for the semantic and emotion features
(counterpart of features/clip.py).

The reference runs OpenAI CLIP ViT-L/14@336px one frame at a time
(reference: ``video2music.py:149-209``); here a chunk of frames runs in one
forward. Semantic features are the raw ``encode_image`` outputs; emotion
probabilities are ``softmax(logit_scale * norm(img) @ norm(text).T)`` over
six prompts, against precomputed text embeddings. Each block's attention
runs through the port's encoder attention kernel (ops/flash_attention.py,
csrc/flash_attention.cu): non-causal over the 577 patch tokens of the
vision tower, causal over the 77 tokens of the text tower. The JAX module
computes it as plain einsums with f32 logits and softmax and the weights
rounded to v's dtype, which is what that kernel computes.

Layouts follow the JAX module at the public functions: pixels are NHWC,
``projection`` is (width, projection_dim). Inside, the patch embedding is
a ``Conv2d`` over NCHW and q | k | v are one ``qkv`` Linear.
``weights.clip_from_jax`` bridges the JAX params.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import flash_attention
from ..ops.norms import LayerNorm

# OpenAI CLIP preprocessing constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

EMOTION_PROMPTS = ("exciting", "fearful", "tense", "sad", "relaxing",
                   "neutral")


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    layers: int = 24
    heads: int = 16
    patch_size: int = 14
    image_size: int = 336
    mlp_ratio: int = 4
    projection_dim: int = 768


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    hidden_size: int = 768
    layers: int = 12
    heads: int = 12
    vocab_size: int = 49408
    context_length: int = 77
    mlp_ratio: int = 4
    projection_dim: int = 768


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: CLIPVisionConfig = CLIPVisionConfig()
    text: CLIPTextConfig = CLIPTextConfig()


def clip_vit_l14_336_config() -> CLIPConfig:
    """ViT-L/14@336px, the reference's checkpoint (video2music.py:151)."""
    return CLIPConfig()


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class _Block(nn.Module):
    """Pre-LN transformer block with a QuickGELU MLP."""

    def __init__(self, d: int, heads: int, mlp_ratio: int,
                 causal: bool = False):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.ln1 = LayerNorm(d)
        self.qkv = nn.Linear(d, 3 * d)
        self.out_proj = nn.Linear(d, d)
        self.ln2 = LayerNorm(d)
        self.fc1 = nn.Linear(d, d * mlp_ratio)
        self.fc2 = nn.Linear(d * mlp_ratio, d)

    def forward(self, x):
        B, L, D = x.shape
        qkv = self.qkv(self.ln1(x)).view(B, L, 3, self.heads,
                                         D // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous()
        attn = flash_attention(q, k, v, causal=self.causal)
        x = x + self.out_proj(attn.transpose(1, 2).reshape(B, L, D))
        return x + self.fc2(quick_gelu(self.fc1(self.ln2(x))))


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        c, D = cfg, cfg.hidden_size
        n_tok = (c.image_size // c.patch_size) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, D, c.patch_size, c.patch_size,
                                     bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.position_embedding = nn.Parameter(torch.zeros(n_tok, D))
        self.ln_pre = LayerNorm(D)
        self.blocks = nn.ModuleList(_Block(D, c.heads, c.mlp_ratio)
                                    for _ in range(c.layers))
        self.ln_post = LayerNorm(D)
        self.projection = nn.Parameter(torch.zeros(D, c.projection_dim))

    def forward(self, pixels):
        """pixels (B, H, W, 3) normalized -> (B, projection_dim)."""
        x = self.patch_embed(pixels.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                   # (B, gh gw, D)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(x.dtype)
        x = self.ln_pre(x)
        for block in self.blocks:
            x = block(x)
        return self.ln_post(x[:, 0]) @ self.projection.to(x.dtype)


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg
        self.token_embedding = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(c.context_length, c.hidden_size))
        self.blocks = nn.ModuleList(
            _Block(c.hidden_size, c.heads, c.mlp_ratio, causal=True)
            for _ in range(c.layers))
        self.ln_final = LayerNorm(c.hidden_size)
        self.projection = nn.Parameter(
            torch.zeros(c.hidden_size, c.projection_dim))

    def forward(self, token_ids):
        """token_ids (B, L) int -> (B, projection_dim), pooled at each
        sequence's largest token id (the EOT token, OpenAI convention)."""
        x = self.token_embedding(token_ids)
        x = x + self.position_embedding[:x.shape[1]].to(x.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device),
                   token_ids.argmax(dim=-1)]
        return pooled @ self.projection.to(x.dtype)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTower(cfg.vision)
        self.text = TextTower(cfg.text)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, pixels):
        return self.visual(pixels)

    def encode_text(self, token_ids):
        return self.text(token_ids)

    def forward(self, pixels, token_ids):
        """(logits_per_image, logits_per_text) as in OpenAI CLIP."""
        img = self.encode_image(pixels)
        txt = self.encode_text(token_ids)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        logits_per_image = self.logit_scale.exp() * img @ txt.t()
        return logits_per_image, logits_per_image.t()

    def emotion_probs(self, pixels, text_embeds):
        """Zero-shot emotion probabilities against precomputed
        (unnormalized) text embeddings (reference: video2music.py:189-198)."""
        return self.semantic_and_emotion(pixels, text_embeds)[1]

    def semantic_and_emotion(self, pixels, text_embeds):
        """(raw image embeddings, zero-shot emotion probs) from ONE vision
        tower pass. The emotion head runs in float32 against the float32
        text embeddings, as the JAX pipeline keeps them."""
        img = self.encode_image(pixels)
        n = img.float() / img.float().norm(dim=-1, keepdim=True)
        txt = text_embeds.float()
        txt = txt / txt.norm(dim=-1, keepdim=True)
        logits = self.logit_scale.float().exp() * n @ txt.t()
        return img, torch.softmax(logits, dim=-1)


def resize_crop_frames(frames: np.ndarray, image_size: int = 336,
                       backend: str = "pil") -> np.ndarray:
    """uint8 (B, H, W, 3) RGB -> uint8 (B, S, S, 3): resize the shorter side
    to S (bicubic) and center crop; normalization is left to
    :func:`normalize_pixels` on the device (a quarter of the f32 upload).

    backend="pil" reproduces the reference preprocessing exactly
    (torchvision Resize(BICUBIC) on PIL images, via clip.load,
    video2music.py:151); backend="cv2" is the serving fast path (INTER_AREA
    resize; pixels differ from PIL's antialiased bicubic by a few LSBs)."""
    if backend == "cv2":
        return _resize_crop_cv2(frames, image_size)
    from PIL import Image

    out = np.empty((frames.shape[0], image_size, image_size, 3), np.uint8)
    for i, frame in enumerate(frames):
        im = Image.fromarray(frame)
        w, h = im.size
        scale = image_size / min(w, h)
        im = im.resize((int(round(w * scale)), int(round(h * scale))),
                       Image.BICUBIC)
        w, h = im.size
        left, top = (w - image_size) // 2, (h - image_size) // 2
        im = im.crop((left, top, left + image_size, top + image_size))
        out[i] = np.asarray(im, np.uint8)
    return out


def _resize_crop_cv2(frames: np.ndarray, image_size: int) -> np.ndarray:
    """cv2 shorter-side resize + center crop (same geometry as the PIL
    path; INTER_AREA ~ antialiased downscale, INTER_CUBIC upscale)."""
    import cv2

    # frames may be an (N, H, W, 3) array or a list of frames with
    # per-clip resolutions (extract_features_batch flattens clips)
    out = np.empty((len(frames), image_size, image_size, 3), np.uint8)
    for i, frame in enumerate(frames):
        h, w = frame.shape[:2]
        scale = image_size / min(w, h)
        nw, nh = int(round(w * scale)), int(round(h * scale))
        interp = cv2.INTER_AREA if scale < 1.0 else cv2.INTER_CUBIC
        im = cv2.resize(np.ascontiguousarray(frame), (nw, nh),
                        interpolation=interp)
        left, top = (nw - image_size) // 2, (nh - image_size) // 2
        out[i] = im[top:top + image_size, left:left + image_size]
    return out


def normalize_pixels(u8, mean=None, std=None):
    """uint8 frames (a tensor, on the device) -> CLIP-normalized float32."""
    mean = CLIP_MEAN if mean is None else mean
    std = CLIP_STD if std is None else std
    x = u8.float() / 255.0
    return ((x - torch.as_tensor(mean, device=x.device))
            / torch.as_tensor(std, device=x.device))


def preprocess_frames(frames: np.ndarray, image_size: int = 336) -> np.ndarray:
    """uint8 (B, H, W, 3) RGB -> normalized float32 (B, S, S, 3), on the
    host: the OpenAI preprocess (bicubic shorter-side resize, center crop,
    [0, 1], CLIP mean / std)."""
    u8 = resize_crop_frames(frames, image_size)
    return (u8.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
