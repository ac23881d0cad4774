"""MaxViT-T feature extractor for the motion embeddings (counterpart of
features/maxvit.py).

The reference embeds per-second frame-difference images with
torchvision's ``maxvit_t`` whose classifier is replaced by global average
pooling: 512-d motion features (reference: ``video2music.py:298-341``).
Architecture: a conv stem (64 channels), four stages of [MBConv ->
window attention -> grid attention] with channels (64, 128, 256, 512),
depths (2, 2, 5, 2), squeeze-excitation MBConvs, partition 7 at 224x224,
relative-position biases, BatchNorms folded to inference form
(``FoldedBN``). The graph follows torchvision 0.18's (the repo's
tools/torch_maxvit_mirror.py reconstructs it): NCHW convolutions, and
attention over windows cut from the NCHW map.

Each partition attention runs through the port's encoder attention kernel
(ops/flash_attention.py, csrc/flash_attention.cu) over 49 tokens, with
torchvision's scale -- the FULL channel width, C ** -0.5, not the head
width -- and the (heads, 49, 49) relative-position bias shared by every
window, read in place by the kernel. Pixels are NHWC at the public
functions, as in the JAX module; ``weights.maxvit_from_jax`` bridges its
params.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.flash_attention import flash_attention
from ..ops.norms import LayerNorm

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class MaxViTConfig:
    channels: tuple = (64, 128, 256, 512)
    depths: tuple = (2, 2, 5, 2)
    stem_channels: int = 64
    partition: int = 7
    head_dim: int = 32
    mbconv_expansion: int = 4
    se_ratio: float = 0.25
    mlp_ratio: int = 4
    image_size: int = 224


def maxvit_t_config() -> MaxViTConfig:
    return MaxViTConfig()


def _gelu(x):
    return F.gelu(x, approximate="none")


class FoldedBN(nn.Module):
    """Inference-form BatchNorm over NCHW: y = x * scale + bias."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class SqueezeExcite(nn.Module):
    def __init__(self, ch: int, se_ch: int):
        super().__init__()
        self.fc1 = nn.Conv2d(ch, se_ch, 1)
        self.fc2 = nn.Conv2d(se_ch, ch, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.silu(self.fc1(s))))


class MBConv(nn.Module):
    """Pre-norm MBConv with SE (torchvision's MaxVit layout)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 expansion: int = 4, se_ratio: float = 0.25):
        super().__init__()
        mid = out_ch * expansion
        # torch AvgPool2d(3, 2, padding 1, count_include_pad): the padded
        # zeros count in every mean, as in the JAX module's explicit padding
        self.pool = (nn.AvgPool2d(3, 2, padding=1, count_include_pad=True)
                     if stride == 2 else None)
        self.down_proj = (nn.Conv2d(in_ch, out_ch, 1)
                          if stride == 2 or in_ch != out_ch else None)
        self.pre_norm = FoldedBN(in_ch)
        self.conv_a = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.bn_a = FoldedBN(mid)
        self.conv_b = nn.Conv2d(mid, mid, 3, stride, 1, groups=mid,
                                bias=False)
        self.bn_b = FoldedBN(mid)
        self.se = SqueezeExcite(mid, max(1, int(out_ch * se_ratio)))
        self.conv_proj = nn.Conv2d(mid, out_ch, 1)

    def forward(self, x):                                  # NCHW
        res = x if self.pool is None else self.pool(x)
        if self.down_proj is not None:
            res = self.down_proj(res)
        h = _gelu(self.bn_a(self.conv_a(self.pre_norm(x))))
        h = _gelu(self.bn_b(self.conv_b(h)))
        return res + self.conv_proj(self.se(h))


def _rel_position_index(p: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(p), np.arange(p),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (p - 1)
    return (rel[..., 0] * (2 * p - 1) + rel[..., 1]).astype(np.int32)


class PartitionAttention(nn.Module):
    """Window ("block") or grid attention with a relative-position bias,
    then the MLP, over windows of p*p tokens.

    Window mode cuts the map into (H/p) x (W/p) windows of p x p
    neighbours; grid mode into g x g groups (g = H / p) of the p x p
    positions strided by g across the map (torchvision's partition with
    window g and the (-2, -3) axis swap). Both attend over p*p tokens with
    the ((2p-1)^2, heads) bias table."""

    def __init__(self, ch: int, partition: int, head_dim: int, grid: bool,
                 mlp_ratio: int = 4):
        super().__init__()
        self.p, self.grid = partition, grid
        self.heads, self.head_dim = ch // head_dim, head_dim
        self.ln1 = LayerNorm(ch)
        self.qkv = nn.Linear(ch, 3 * ch)
        self.rel_bias = nn.Parameter(
            torch.zeros((2 * partition - 1) ** 2, self.heads))
        self.register_buffer("rel_index", torch.tensor(
            _rel_position_index(partition).reshape(-1), dtype=torch.long),
            persistent=False)
        self.proj = nn.Linear(ch, ch)
        self.ln2 = LayerNorm(ch)
        self.fc1 = nn.Linear(ch, ch * mlp_ratio)
        self.fc2 = nn.Linear(ch * mlp_ratio, ch)

    def _cut(self, x):
        """NCHW -> (windows, p*p, C)."""
        B, C, H, W = x.shape
        p = self.p
        if self.grid:
            g = H // p
            x = x.reshape(B, C, p, g, p, g).permute(0, 3, 5, 2, 4, 1)
        else:
            x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 3, 5, 1)
        return x.reshape(-1, p * p, C)

    def _join(self, t, shape):
        """(windows, p*p, C) -> NCHW of ``shape``."""
        B, C, H, W = shape
        p = self.p
        if self.grid:
            g = H // p
            t = t.reshape(B, g, g, p, p, C).permute(0, 5, 3, 1, 4, 2)
        else:
            t = t.reshape(B, H // p, W // p, p, p, C).permute(0, 5, 1, 3, 2, 4)
        return t.reshape(B, C, H, W)

    def bias(self):
        """(1, heads, p*p, p*p) float32: one bias for every window."""
        n = self.p * self.p
        b = self.rel_bias.float()[self.rel_index].view(n, n, self.heads)
        return b.permute(2, 0, 1).unsqueeze(0)

    def forward(self, x):                                  # NCHW
        t = self._cut(x)
        n, L, C = t.shape
        qkv = self.qkv(self.ln1(t)).view(n, L, 3, self.heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous()
        attn = flash_attention(q, k, v, bias=self.bias(), scale=C ** -0.5)
        t = t + self.proj(attn.transpose(1, 2).reshape(n, L, C))
        t = t + self.fc2(_gelu(self.fc1(self.ln2(t))))
        return self._join(t, x.shape)


class MaxViT(nn.Module):
    """pixels (B, H, W, 3) normalized -> (B, channels[-1]) pooled
    features (the reference's use: no classifier)."""

    def __init__(self, cfg: MaxViTConfig):
        super().__init__()
        c = self.cfg = cfg
        self.stem_conv1 = nn.Conv2d(3, c.stem_channels, 3, 2, 1, bias=False)
        self.stem_bn = FoldedBN(c.stem_channels)
        self.stem_conv2 = nn.Conv2d(c.stem_channels, c.stem_channels, 3, 1,
                                    1)
        self.layers = nn.ModuleDict()
        in_ch = c.stem_channels
        for s, (ch, depth) in enumerate(zip(c.channels, c.depths)):
            for d in range(depth):
                self.layers[f"s{s}_b{d}_mbconv"] = MBConv(
                    in_ch, ch, 2 if d == 0 else 1, c.mbconv_expansion,
                    c.se_ratio)
                in_ch = ch
                for kind in ("window", "grid"):
                    self.layers[f"s{s}_b{d}_{kind}"] = PartitionAttention(
                        ch, c.partition, c.head_dim, grid=kind == "grid",
                        mlp_ratio=c.mlp_ratio)

    def forward(self, pixels):
        x = _gelu(self.stem_bn(self.stem_conv1(pixels.permute(0, 3, 1, 2))))
        x = self.stem_conv2(x)
        for layer in self.layers.values():
            x = layer(x)
        return x.mean(dim=(2, 3))


def resize_crop_diff_frames(frames: np.ndarray, image_size: int = 224,
                            backend: str = "pil") -> np.ndarray:
    """uint8 RGB diff images -> uint8 (B, 224, 224, 3) (resize + crop only;
    normalize on the device with :func:`normalize_diff_pixels`).

    backend: "pil" = reference-exact (torchvision transforms on PIL);
    "cv2" = serving fast path (see features.clip.resize_crop_frames)."""
    if backend == "cv2":
        from .clip import _resize_crop_cv2
        return _resize_crop_cv2(frames, image_size)
    from PIL import Image

    out = np.empty((frames.shape[0], image_size, image_size, 3), np.uint8)
    for i, frame in enumerate(frames):
        im = Image.fromarray(frame)
        w, h = im.size
        scale = image_size / min(w, h)  # MaxVit_T transforms: resize_size=224
        im = im.resize((int(round(w * scale)), int(round(h * scale))),
                       Image.BICUBIC)
        w, h = im.size
        left, top = (w - image_size) // 2, (h - image_size) // 2
        im = im.crop((left, top, left + image_size, top + image_size))
        out[i] = np.asarray(im, np.uint8)
    return out


def normalize_diff_pixels(u8):
    """uint8 diff frames (a tensor, on the device) -> ImageNet-normalized
    float32."""
    x = u8.float() / 255.0
    return ((x - torch.as_tensor(IMAGENET_MEAN, device=x.device))
            / torch.as_tensor(IMAGENET_STD, device=x.device))


def preprocess_diff_frames(frames: np.ndarray,
                           image_size: int = 224) -> np.ndarray:
    """uint8 RGB diff images -> ImageNet-normalized (B, 224, 224, 3) on the
    host (torchvision MaxVit_T_Weights.IMAGENET1K_V1.transforms: resize
    224 bicubic + center crop + normalize)."""
    u8 = resize_crop_diff_frames(frames, image_size)
    return (u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def motion_diff_frames(frame_pairs: list) -> np.ndarray:
    """|cur - prev| RGB diff images with a leading zero row, matching the
    reference's capture loop (video2music.py:311-335). ``frame_pairs``:
    list of (prev, cur) CONSECUTIVE-frame BGR pairs at 1-second boundaries
    (see pipeline.video_io.second_boundary_pairs) -- each diff spans ~1/fps,
    not a full second."""
    import cv2

    if not frame_pairs:
        return np.zeros((1, 2, 2, 3), np.uint8)
    diffs = [np.zeros_like(frame_pairs[0][0])[..., ::-1]]
    for prev, cur in frame_pairs:
        diff = cv2.absdiff(cur, prev)
        diffs.append(cv2.cvtColor(diff, cv2.COLOR_BGR2RGB))
    return np.stack(diffs)


def scalar_motion(frame_pairs: list) -> np.ndarray:
    """motion_type=0 scalar motion: mean RGB absdiff of consecutive frames
    at each second boundary, with a leading zero (reference:
    video2music.py:269-295 'origin' path that produced the dataset's
    motion .lab files)."""
    import cv2

    vals = [0.0]
    for prev, cur in frame_pairs:
        diff = cv2.absdiff(cur, prev)
        vals.append(float(cv2.cvtColor(diff, cv2.COLOR_BGR2RGB).mean()))
    return np.asarray(vals, np.float32)


# ---------------------------------------------------------------------------
# weight conversion from torchvision's maxvit_t state dict
# ---------------------------------------------------------------------------

def _fold_bn(t, prefix, eps=1e-3):
    """BatchNorm running stats (``t``: name -> f32 array) -> inference
    scale / bias (the JAX package's _fold_bn). MaxVit builds its
    BatchNorm2d with eps=1e-3 (torchvision MaxVit.__init__), not torch's
    default 1e-5."""
    w, b, mean, var = (t(f"{prefix}.{k}") for k in (
        "weight", "bias", "running_mean", "running_var"))
    scale = w / np.sqrt(var + eps)
    return {"scale": scale, "bias": b - mean * scale}


def convert_torchvision_maxvit(state_dict,
                               cfg: MaxViTConfig = MaxViTConfig()):
    """torchvision ``maxvit_t().state_dict()`` (stem ``stem.0/1``, blocks
    ``blocks.{s}.layers.{d}.layers.{MBconv,window_attention,
    grid_attention}``) -> the state dict of :class:`MaxViT`, for
    ``load_state_dict``, every BatchNorm folded into a FoldedBN's scale and
    bias. Takes torch tensors or numpy arrays.

    The key map is the JAX package's convert_torchvision_maxvit
    (features/maxvit.py:323): torchvision's names to the JAX module's tree
    (conv kernels (kh, kw, in, out), Linear weights (in, out)), which
    ``weights.maxvit_from_jax`` then lays out for this module, as it does
    any JAX MaxViT tree."""
    from ..weights import f32_array, maxvit_from_jax

    sd = state_dict
    t = lambda k: f32_array(sd[k])
    conv = lambda k: {"kernel": np.transpose(t(k + ".weight"), (2, 3, 1, 0))}
    conv_b = lambda k: {**conv(k), "bias": t(k + ".bias")}
    lin = lambda k: {"kernel": t(k + ".weight").T, "bias": t(k + ".bias")}
    ln = lambda k: {"scale": t(k + ".weight"), "bias": t(k + ".bias")}

    params = {"stem_conv1": conv("stem.0.0"),
              "stem_bn": _fold_bn(t, "stem.0.1"),
              "stem_conv2": conv_b("stem.1.0")}
    for s, depth in enumerate(cfg.depths):
        for d in range(depth):
            base = f"blocks.{s}.layers.{d}.layers"
            mb = f"{base}.MBconv"
            m = {"pre_norm": _fold_bn(t, f"{mb}.layers.pre_norm")}
            if f"{mb}.proj.1.weight" in sd:  # downsample: avgpool + conv
                m["down_proj"] = conv_b(f"{mb}.proj.1")
            elif f"{mb}.proj.weight" in sd:
                m["down_proj"] = conv_b(f"{mb}.proj")
            m["conv_a"] = conv(f"{mb}.layers.conv_a.0")
            m["bn_a"] = _fold_bn(t, f"{mb}.layers.conv_a.1")
            m["conv_b"] = conv(f"{mb}.layers.conv_b.0")
            m["bn_b"] = _fold_bn(t, f"{mb}.layers.conv_b.1")
            m["se"] = {
                "fc1": conv_b(f"{mb}.layers.squeeze_excitation.fc1"),
                "fc2": conv_b(f"{mb}.layers.squeeze_excitation.fc2")}
            m["conv_proj"] = conv_b(f"{mb}.layers.conv_c")
            params[f"s{s}_b{d}_mbconv"] = m
            for kind, name in (("window", "window_attention"),
                               ("grid", "grid_attention")):
                p = f"{base}.{name}"
                a = f"{p}.attn_layer"
                params[f"s{s}_b{d}_{kind}"] = {
                    "ln1": ln(f"{a}.0"), "qkv": lin(f"{a}.1.to_qkv"),
                    "rel_bias": t(f"{a}.1.relative_position_bias_table"),
                    "proj": lin(f"{a}.1.merge"),
                    "ln2": ln(f"{p}.mlp_layer.0"),
                    "fc1": lin(f"{p}.mlp_layer.1"),
                    "fc2": lin(f"{p}.mlp_layer.3")}
    return maxvit_from_jax(params)
