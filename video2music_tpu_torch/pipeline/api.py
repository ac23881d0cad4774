"""The product API of the port: ``Video2music().generate(video)`` (or
``generate(features=...)``) and ``Video2music().generate_batch(requests)``
(counterpart of pipeline/api.py).

Raw video in: ``extract_features`` decodes a clip in one streaming pass
(pipeline/video_io.py ``ClipStream``, scene scores inline), and every 30
decoded seconds uploads a chunk of uint8 frames, normalizes it on the
device and runs CLIP's vision tower once for semantic and emotion
features (features/clip.py) and MaxViT on the frame differences for
motion (features/maxvit.py), with no host sync until the final fetch;
scene cuts come from features/scene.py. ``extract_features_batch`` does
the same for several clips (decode in a thread pool, frames of all clips
in shared chunks, sliced back per clip); the DynamicBatcher calls it for
requests that carry a ``video``. A muxed mp4 with the FluidSynth render
(and timed captions) is written where fluidsynth and ffmpeg exist.

``generate_batch`` runs, eagerly and once for B clips, the four stages the
JAX package traces into one program — encoder, cross-K/V priming, the
300-step KV-cached constrained decode (decode/sampler.py: B=1 through the
B=1 kernels, B>1 through the batched ones) and the regression forward —
then, per clip, the same host-side post-process: MIDI and per-instrument
stems through ``data.native.render_clip`` (or the ``midi`` writers, the
port's copies of the JAX package's), ``inst.csv``, and a FluidSynth render
where FluidSynth exists. ``generate`` is a batch of one; the
DynamicBatcher of pipeline/serving.py drives ``generate_batch``.

The wirings: every AMT version ``amt_config`` builds (``music_gen_version``
None for the base AMT, the V1.x strings, 2.0-2.3 with 2.2 the default,
3.0-3.2; ``amt_overrides`` such as ``kv_heads`` on top), each with a
Mamba-family regression (``reg_model`` mamba, mamba+, moemamba, bimamba,
bimamba+ the default, moe_bimamba+, sharedmoe_bimamba+). Where a decode
kernel covers the wiring the decode runs through it (decode/sampler.py);
KAN 2.3 and grouped-query attention decode on the plain step, as in the
JAX package.
``quantize="int8"`` (weight-only int8 decode) covers the wirings with a
decode kernel: at B=1 the decode kernels read int8 weights, at B>1 the plain
step runs on fake-quantized weights, as in the JAX package
(decode/sampler.py). ``kv_quant="int8"`` (``generate_batch``) keeps the
batched 2.x step's KV caches as int8 rows with row scales. The regression
takes any of the fourteen backbones (models/regression.py).
Weights come from the port's own checkpoints (``amt_checkpoint`` /
``reg_checkpoint``, the files ``train.train_amt`` / ``train_regression``
write; :meth:`Video2music.load_checkpoints` swaps them while serving,
through ``DynamicBatcher.submit_control``), from
:mod:`video2music_tpu_torch.weights` (random from a seed, or bridged from a
JAX param tree, :meth:`Video2music.load_state_dicts`;
``weights.clip_from_jax`` / ``maxvit_from_jax`` for the extractors). A
JAX package orbax checkpoint raises ValueError: its rewriter is still to
come (ROADMAP.md, Queue 1 item 1).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import constants as C
from ..core.config import RegressionConfig, amt_config
from ..core.vocab import chord_inv_dict
from ..data import native as _native
from ..midi import Chord, MIDIFile, add_chord, chord_offsets, voice
from ..midi.arpeggio import density_bucket, velocity_from_loudness

from ..decode.sampler import GenerateConfig, generate_chords
from ..features import scene as scene_mod
from ..features.clip import (CLIP, clip_vit_l14_336_config, normalize_pixels,
                             resize_crop_frames)
from ..features.maxvit import (MaxViT, maxvit_t_config, motion_diff_frames,
                               normalize_diff_pixels, resize_crop_diff_frames,
                               scalar_motion)
from ..models import VideoMusicTransformer, VideoRegression
from ..weights import init_weights_
from . import video_io
from .primer import TRANSPOSE_KEY, parse_primer, resolve_key_and_primer

ARPEGGIO_INSTRUMENTS = frozenset(
    (3, 7, 8, 11, 14, 27, 31, 37, 38, 39))
LEFT_PAN = frozenset((13, 14, 16, 25, 28, 29, 34, 39))
CENTER_PAN = frozenset((7, 15, 17, 20, 21, 23, 24, 30, 32, 33, 35, 36, 37,
                        38))
PAN_VALS = {"left": 32, "center": 64, "right": 96}
LOW_VELOCITY_INSTRUMENTS = frozenset((14,))
BASE_TEMPO = 120
CHORD_DURATION_BEATS = 2  # 1 second per chord at 120 bpm
INSTRUMENT_THRESHOLD = 0.35
MAX_SECONDS = 300


def _inst_policy(n_inst: int = C.INSTRUMENT_SIZE):
    """The per-instrument render policy (pan/arpeggio/velocity sets above)
    as flat rows for the native renderer (data/native.render_clip)."""
    pan = np.asarray([
        PAN_VALS["left"] if i in LEFT_PAN else
        PAN_VALS["center"] if i in CENTER_PAN else PAN_VALS["right"]
        for i in range(n_inst)], np.int32)
    return dict(
        arp=np.asarray([i in ARPEGGIO_INSTRUMENTS
                        for i in range(n_inst)], np.uint8),
        vel=np.asarray([1.15 if i in LOW_VELOCITY_INSTRUMENTS else 1.0
                        for i in range(n_inst)], np.float64),
        pan_ctrl_correct=np.full(n_inst, 10, np.int32),
        pan_param_correct=pan,
        # reference quirk: pan value lands in the controller-number byte
        pan_ctrl_quirk=pan,
        pan_param_quirk=np.zeros(n_inst, np.int32),
    )


_INST_POLICY = _inst_policy()


@dataclasses.dataclass
class GenerateResult:
    chords: List[str]
    chord_ids: np.ndarray
    midi_path: Optional[str]
    audio_path: Optional[str]
    video_path: Optional[str]
    densities: List[int]
    velocities: List[int]
    instruments: np.ndarray
    key: str


def smooth_emotion(emotion: np.ndarray, window: int = 5) -> np.ndarray:
    """Grouped 1-d average over time, zero padded (reference:
    video2music.py:827-831). emotion: (L, 6)."""
    k = np.ones(window, np.float32) / window
    pad = window // 2
    padded = np.pad(emotion, ((pad, pad), (0, 0)))
    out = np.empty_like(emotion)
    for c in range(emotion.shape[1]):
        out[:, c] = np.convolve(padded[:, c], k, mode="valid")
    return out


def _pad_to(arr: np.ndarray, length: int) -> np.ndarray:
    if arr.shape[0] >= length:
        return arr[:length]
    pad_shape = (length - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.zeros(pad_shape, arr.dtype)], axis=0)


def _gc_quiet(fn):
    """Run the whole extraction (decode, resize loops, device fetches)
    under ``video_io.gc_quiet``: cyclic-GC passes over a large live heap
    cost whole seconds inside per-frame host loops. ``ClipStream`` guards
    its own decode loop; this extends the guard over the tail flush and
    the fetches (reentrant)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with video_io.gc_quiet():
            return fn(*args, **kwargs)
    return wrapper


def _upload(u8: np.ndarray, device) -> torch.Tensor:
    """uint8 host frames to ``device`` without waiting for the device: from
    pinned memory, a non-blocking copy queued behind the running chunks."""
    t = torch.from_numpy(np.ascontiguousarray(u8))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


_FEATURES = ("semantic", "scene_offset", "motion", "emotion")
_GCFG = GenerateConfig(target_seq_length=MAX_SECONDS, max_conseq_N=0,
                       max_conseq_chord=2)


def _prepare(features, key, primer) -> dict:
    """One request's host-side inputs: features padded to MAX_SECONDS, the
    key and primer resolved (the flat emotion argmax of the reference),
    the primer parsed, the emotion smoothed."""
    L = MAX_SECONDS
    pad = lambda name: _pad_to(np.asarray(features[name], np.float32), L)
    emotion = pad("emotion")
    key, key_feature, primer = resolve_key_and_primer(key, primer, emotion)
    ids, roots, attrs = parse_primer(primer)
    return dict(n_sec=min(int(features["semantic"].shape[0]), L), key=key,
                key_feature=key_feature, semantic=pad("semantic"),
                scene_offset=pad("scene_offset"), motion=pad("motion"),
                emotion=smooth_emotion(emotion), primer_ids=ids,
                primer_roots=roots, primer_attrs=attrs)


class Video2music:
    """Video2music on PyTorch, from a video or from precomputed features.

    Models are built from the JAX package's configs, initialised from
    ``seed`` with a torch.Generator, and kept in float32 on ``device``
    ("cuda" unless given; without CUDA the constructor raises, and
    ``device="cpu"`` runs the plain versions of the kernels); a bfloat16
    copy is made at the first bfloat16 ``generate``.

    The feature extractors are optional: ``clip_params`` (a state dict of
    features.clip.CLIP, e.g. ``weights.clip_from_jax``) with
    ``emotion_text_embeds`` (the six prompts' (6, projection_dim) text
    embeddings), and ``maxvit_params`` (features.maxvit.MaxViT) for
    ``motion_type`` 1 and 2. They are built on ``device`` at ``clip_cfg`` /
    ``maxvit_cfg`` (CLIP ViT-L/14@336 and MaxViT-T unless given) and kept
    in ``extractor_dtype`` ("bfloat16" unless "float32"). Without them,
    ``generate`` needs ``features``. ``resize_backend``: "cv2" (the
    serving default) or "pil" (the reference's exact preprocessing).
    """

    def __init__(self, *, music_gen_version: str = "2.2",
                 reg_model: str = "bimamba+", motion_type: int = 1,
                 amt_checkpoint: Optional[str] = None,
                 reg_checkpoint: Optional[str] = None,
                 clip_params=None, emotion_text_embeds=None,
                 maxvit_params=None, seed: int = 0,
                 amt_overrides: Optional[dict] = None,
                 reg_overrides: Optional[dict] = None,
                 extractor_dtype: str = "bfloat16",
                 resize_backend: str = "cv2",
                 clip_cfg=None, maxvit_cfg=None, device=None):
        self.motion_type = motion_type
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Video2music: CUDA is not available (torch.cuda.is_available()"
                " is False); pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        motion_dim = {0: 1, 1: 512, 2: 768}[motion_type]
        total_vf = 768 + 1 + motion_dim + 6  # reference: video2music.py:609
        self.amt_cfg = amt_config(music_gen_version, total_vf_dim=total_vf,
                                  **(amt_overrides or {}))
        self.reg_cfg = RegressionConfig(reg_model=reg_model,
                                        total_vf_dim=768 + 6,
                                        **(reg_overrides or {}))
        gen = torch.Generator().manual_seed(seed)
        self.model = init_weights_(VideoMusicTransformer(self.amt_cfg), gen)
        self.model_reg = init_weights_(VideoRegression(self.reg_cfg), gen)
        self.model.to(self.device).eval()
        self.model_reg.to(self.device).eval()
        if extractor_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown extractor_dtype {extractor_dtype!r}")
        self.extractor_dtype = extractor_dtype
        self.resize_backend = resize_backend
        self._clip_cfg = clip_cfg or clip_vit_l14_336_config()
        self._maxvit_cfg = maxvit_cfg or maxvit_t_config()
        self.clip = self._extractor(CLIP, self._clip_cfg, clip_params)
        self.maxvit = self._extractor(MaxViT, self._maxvit_cfg, maxvit_params)
        self.emotion_text_embeds = None if emotion_text_embeds is None else \
            torch.as_tensor(np.asarray(emotion_text_embeds, np.float32),
                            device=self.device)
        self.last_extract_timings: Dict[str, float] = {}
        self._bf16 = None
        # stage times (ms) and regression outputs of the last generate
        self.last_timings: Dict[str, float] = {}
        self.last_regression: Dict[str, np.ndarray] = {}
        self.load_checkpoints(amt_checkpoint, reg_checkpoint)

    def load_checkpoints(self, amt_checkpoint: Optional[str] = None,
                         reg_checkpoint: Optional[str] = None) -> None:
        """(Re)load the AMT and / or regression weights from port
        checkpoints (train/checkpoint.py files, e.g.
        ``weights/best_loss_weights`` of ``train_amt`` and
        ``weights/best_rmse_weights`` of ``train_regression``), in place:
        the serving hot-reload hook. Both files are read and checked before
        either model changes; the cached bfloat16 copies built from the old
        weights are dropped (every decode pack, int8 or not, is built from
        the models at each ``generate_batch``, and the extractors keep
        their own weights). Not thread-safe against a running generate:
        in serving, route it through ``DynamicBatcher.submit_control``,
        which runs it between batches. A file that is not a port
        checkpoint, or one of another wiring, raises ValueError."""
        from ..train.checkpoint import load_weights

        pending = []
        for path, model, kind in ((amt_checkpoint, self.model,
                                   "VideoMusicTransformer"),
                                  (reg_checkpoint, self.model_reg,
                                   "VideoRegression")):
            if path:
                state = load_weights(path, model_class=kind)
                own = model.state_dict()
                if sorted(state) != sorted(own) or any(
                        state[k].shape != own[k].shape for k in own):
                    raise ValueError(
                        f"{path!r} holds a {kind} of another wiring than "
                        f"this Video2music's (differing tensors: "
                        f"{sorted(set(state) ^ set(own))[:6] or 'shapes'})")
                pending.append((model, state))
        for model, state in pending:
            model.load_state_dict(state)
        if pending:
            self._bf16 = None

    def _extractor(self, cls, cfg, state):
        """An extractor built on the device from its state dict, in
        ``extractor_dtype``, or None without one."""
        if state is None:
            return None
        with torch.device(self.device):
            model = cls(cfg)
        model.load_state_dict(state)
        return model.to(self.device, getattr(torch, self.extractor_dtype)) \
            .eval()

    def load_state_dicts(self, amt_state=None, reg_state=None) -> None:
        """Load float32 state dicts (e.g. weights.amt_from_jax output) into
        the models; drops the cached bfloat16 copies."""
        if amt_state is not None:
            self.model.load_state_dict(amt_state)
        if reg_state is not None:
            self.model_reg.load_state_dict(reg_state)
        self._bf16 = None

    def _models(self, compute_dtype: str):
        if compute_dtype == "float32":
            return self.model, self.model_reg
        if compute_dtype != "bfloat16":
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        if self._bf16 is None:
            self._bf16 = tuple(copy.deepcopy(m).to(torch.bfloat16)
                               for m in (self.model, self.model_reg))
        return self._bf16

    def generate(self, video: Optional[str] = None,
                 primer: Optional[str] = "", key: Optional[str] = None,
                 transposition_value: int = 0,
                 custom_sound_font: bool = False, temperature: float = 1.0,
                 *, features: Optional[Dict[str, np.ndarray]] = None,
                 output_dir: str = "./output", seed: int = 0,
                 correct_panning: bool = False,
                 sound_font: Optional[str] = None,
                 caption_overlays=None,
                 compute_dtype: str = "bfloat16",
                 quantize: Optional[str] = None,
                 _gumbel=None) -> GenerateResult:
        """One clip from precomputed ``features`` (semantic (n, 768),
        emotion (n, 6), scene_offset (n,), motion (n,) or (n, M)), written
        to ``output_dir``: a batch of one (:meth:`generate_batch`), which
        decodes through the B=1 kernels; or, without ``features``, from the
        ``video`` file, whose features :meth:`extract_features` extracts
        and onto which the render is muxed (with ``caption_overlays``)
        where fluidsynth and ffmpeg exist. ``_gumbel`` is the sampler's
        test seam (decode/sampler.py). ``last_regression`` holds this
        clip's regression outputs."""
        del custom_sound_font  # the sound font is chosen by sound_font
        if features is None:
            if video is None:
                raise ValueError("need a video path or precomputed features")
            features = self.extract_features(video)
        request = dict(features=features, primer=primer, key=key,
                       transposition_value=transposition_value,
                       sound_font=sound_font, output_dir=output_dir,
                       video=video, caption_overlays=caption_overlays)
        (result,) = self.generate_batch(
            [request], temperature=temperature, seed=seed,
            correct_panning=correct_panning, compute_dtype=compute_dtype,
            quantize=quantize, _gumbel=_gumbel)
        self.last_regression = {k: v[0]
                                for k, v in self.last_regression.items()}
        return result

    def generate_batch(self, requests, *, output_dir: str = "./output",
                       temperature=1.0, seed: int = 0,
                       correct_panning: bool = False,
                       compute_dtype: str = "bfloat16",
                       quantize: Optional[str] = None,
                       kv_quant: Optional[str] = None,
                       n_real: Optional[int] = None,
                       on_decoded=None, defer_render: bool = False,
                       _gumbel=None):
        """Decode B clips at once (the JAX ``generate_batch`` contract).

        Args:
          requests: list of dicts — ``features`` (required; the
            DynamicBatcher extracts them for a request with a ``video``),
            optional ``primer``, ``key``, ``transposition_value``,
            ``video`` (muxed onto), ``sound_font``, ``caption_overlays``,
            ``output_dir`` (default ``output_dir/clip_{i:03d}``).
          temperature: one float for the batch, or one per request.
          quantize: None or "int8", weight-only int8 decode.
          kv_quant: None or "int8", int8 KV caches of the batched 2.x step
            (ignored at B=1; a 3.x batch warns and keeps full-precision
            caches; exclusive with ``quantize``).
          n_real: only the first ``n_real`` requests are real; the rest are
            padding clones that decode but are not rendered or returned.
          on_decoded: optional ``fn(i, {"chords", "chord_ids", "key"})``,
            called per real request once ``gen_seq`` is fetched, before any
            render.
          defer_render: return a zero-arg closure that renders and returns
            the results, instead of the results (the DynamicBatcher hands
            it to its render thread).
          _gumbel: the sampler's test seam, (T-1, B, CHORD_END) noise.
        Returns:
          list of GenerateResult, one per real request, or the closure.
        Each output array is fetched once for the whole batch.
        ``last_timings`` holds the batch's encode / prime / decode /
        regression times, and postprocess / total once rendered.
        """
        if not requests:
            return (lambda: []) if defer_render else []
        if n_real is None:
            n_real = len(requests)
        t_start = time.perf_counter()
        prepped = [dict(_prepare(req["features"], req.get("key"),
                                 req.get("primer", "")),
                        out_dir=req.get("output_dir", os.path.join(
                            output_dir, f"clip_{i:03d}")))
                   for i, req in enumerate(requests)]
        temps = np.asarray(temperature, np.float32).reshape(-1)
        if temps.shape[0] == 1:
            temps = np.repeat(temps, len(requests))
        if temps.shape[0] != len(requests):
            raise ValueError(
                f"temperature: expected 1 or {len(requests)} values, got "
                f"{temps.shape[0]}")
        model, model_reg = self._models(compute_dtype)
        dt = getattr(torch, compute_dtype)
        dev = self.device
        stack = lambda rows: torch.as_tensor(np.stack(rows), device=dev)
        pad = lambda k, value: stack([np.concatenate(
            [np.asarray(p[k], np.int32),
             np.full(MAX_SECONDS - len(p[k]), value, np.int32)])
            for p in prepped])
        feats = {k: stack([p[k] for p in prepped]).to(dt) for k in _FEATURES}
        gen = torch.Generator(device=dev).manual_seed(seed)
        out = generate_chords(
            model, key=torch.tensor([[p["key_feature"]] for p in prepped],
                                    device=dev, dtype=dt),
            primer=pad("primer_ids", C.CHORD_PAD),
            primer_root=pad("primer_roots", C.CHORD_ROOT_PAD),
            primer_attr=pad("primer_attrs", C.CHORD_ATTR_PAD),
            num_primer=torch.tensor([len(p["primer_ids"]) for p in prepped],
                                    device=dev),
            generator=gen, gcfg=_GCFG,
            temperature=torch.as_tensor(temps, device=dev),
            quantize=quantize, kv_quant=kv_quant, _gumbel=_gumbel, **feats)
        gen_host = out["gen_seq"].cpu().numpy()
        if on_decoded is not None:
            inv = chord_inv_dict()
            for i, p in enumerate(prepped[:n_real]):
                ids = gen_host[i][:p["n_sec"]]
                on_decoded(i, {"chords": [inv.get(int(c), "N") for c in ids],
                               "chord_ids": ids, "key": p["key"]})
        t_reg = time.perf_counter()
        with torch.no_grad():
            ln_nd, inst = model_reg(**feats)
        ln_host = ln_nd.float().cpu().numpy()
        inst_host = inst.float().cpu().numpy()
        self.last_regression = dict(ln_nd=ln_host, instrument=inst_host)
        timings = dict(out["timings_ms"],
                       regression=(time.perf_counter() - t_reg) * 1e3)
        self.last_timings = timings

        def render():
            t_post = time.perf_counter()
            results = [self._postprocess(
                gen_host[i], ln_host[i], inst_host[i], p["emotion"],
                p["n_sec"], p["key"], req.get("transposition_value", 0),
                p["out_dir"], req.get("video"), correct_panning,
                req.get("sound_font"), req.get("caption_overlays"))
                for i, (req, p) in enumerate(zip(requests[:n_real],
                                                 prepped[:n_real]))]
            t_end = time.perf_counter()
            timings.update(postprocess=(t_end - t_post) * 1e3,
                           total=(t_end - t_start) * 1e3)
            return results

        return render if defer_render else render()

    # ------------------------------------------------------------------
    # raw video in: the device stage of extraction, a function of decoded
    # (resized) frames, then the host stages around it

    def _need_extractors(self) -> None:
        if self.clip is None or self.emotion_text_embeds is None:
            raise ValueError(
                "CLIP params / emotion text embeddings not loaded; pass "
                "features= to generate() or supply clip_params + "
                "emotion_text_embeds")
        if self.motion_type != 0 and self.maxvit is None:
            raise ValueError("maxvit_params required for motion_type>=1")

    @torch.no_grad()
    def clip_chunk(self, u8: np.ndarray):
        """Resized uint8 RGB frames (n, S, S, 3) -> (semantic (n, 768),
        emotion (n, 6)) float32 on the device, from one vision-tower pass;
        queued, not waited for."""
        dt = getattr(torch, self.extractor_dtype)
        pixels = normalize_pixels(_upload(u8, self.device)).to(dt)
        img, probs = self.clip.semantic_and_emotion(
            pixels, self.emotion_text_embeds)
        return img.float(), probs

    @torch.no_grad()
    def motion_chunk(self, u8: np.ndarray) -> torch.Tensor:
        """Resized uint8 RGB difference images (n, S, S, 3) -> MaxViT
        features (n, 512) float32 on the device; queued, not waited for."""
        dt = getattr(torch, self.extractor_dtype)
        return self.maxvit(normalize_diff_pixels(
            _upload(u8, self.device)).to(dt)).float()

    @_gc_quiet
    def extract_features(self, video_path: str) -> Dict[str, np.ndarray]:
        """Video file -> feature dict (semantic, emotion, scene_offset,
        motion), each per second, unpadded (the JAX package's
        ``extract_features``).

        One streaming decode pass (``video_io.ClipStream``) scores scene
        cuts inline and keeps only the frames extraction consumes; every
        30 decoded seconds a 30-frame CLIP chunk (and a 30-pair MaxViT
        chunk) is resized on the host, uploaded as uint8 and queued on the
        device (:meth:`clip_chunk`, :meth:`motion_chunk`), so the device
        works while the host decodes; one fetch at the end. Per-stage
        host seconds of the last call are left in
        ``last_extract_timings``."""
        self._need_extractors()
        T: Dict[str, float] = {}
        t0 = time.perf_counter()
        tick = lambda name: T.__setitem__(name, time.perf_counter() - t0)
        clip_size = self._clip_cfg.vision.image_size
        mv_size = self._maxvit_cfg.image_size
        CH = 30

        buf_1fps: List[np.ndarray] = []
        buf_pairs: List[tuple] = []
        clip_devs: List[tuple] = []
        motion_devs: List[torch.Tensor] = []
        all_pairs: List[tuple] = []    # only kept for motion_type=0
        first_motion_chunk = True

        def flush_clip():
            if buf_1fps:
                clip_devs.append(self.clip_chunk(resize_crop_frames(
                    np.stack(buf_1fps), clip_size,
                    backend=self.resize_backend)))
                buf_1fps.clear()

        def flush_motion():
            nonlocal first_motion_chunk
            if not buf_pairs:
                return
            # motion_diff_frames prepends the reference's leading zero
            # row; only the FIRST chunk keeps it
            diffs = motion_diff_frames(buf_pairs)
            if not first_motion_chunk:
                diffs = diffs[1:]
            first_motion_chunk = False
            motion_devs.append(self.motion_chunk(resize_crop_diff_frames(
                diffs, mv_size, backend=self.resize_backend)))
            buf_pairs.clear()

        cs = video_io.ClipStream(video_path, MAX_SECONDS)
        for f1, pair in cs:
            if f1 is not None:
                buf_1fps.append(f1)
                if len(buf_1fps) == CH:
                    flush_clip()
            if pair is not None:
                if self.motion_type == 0:
                    all_pairs.append(pair)
                else:
                    buf_pairs.append(pair)
                    if len(buf_pairs) == CH:
                        flush_motion()
        flush_clip()
        flush_motion()
        tick("decode+dispatch")

        t0 = time.perf_counter()
        n_sec = sum(sem.shape[0] for sem, _ in clip_devs)
        scene_offset = self._scene_offset(cs.scores, cs.n_frames_capped,
                                          cs.fps, n_sec)
        tick("scene_decisions")

        t0 = time.perf_counter()
        if self.motion_type == 0:
            motion = scalar_motion(all_pairs)
        elif motion_devs:
            motion = torch.cat(motion_devs).cpu().numpy()
        else:  # no pair (a sub-second clip): MaxViT on the leading zero row
            motion = self.motion_chunk(resize_crop_diff_frames(
                motion_diff_frames([]), mv_size,
                backend=self.resize_backend)).cpu().numpy()
        if clip_devs:
            semantic = torch.cat([d[0] for d in clip_devs]).cpu().numpy()
            emotion = torch.cat([d[1] for d in clip_devs]).cpu().numpy()
        else:
            semantic = np.zeros((0, 768), np.float32)
            emotion = np.zeros((0, 6), np.float32)
        tick("device_fetch")
        self.last_extract_timings = T
        return {"semantic": semantic, "emotion": emotion,
                "scene_offset": scene_offset, "motion": motion}

    @staticmethod
    def _scene_offset(scores, n_frames_capped, fps, n_sec) -> np.ndarray:
        """Per-second seconds-since-cut from the streamed scene scores, + 1
        (the training loader's and the reference's int(sceneID) + 1; 0
        stays the pad value)."""
        cuts = scene_mod.detect_cuts(scores=scores)
        spans = scene_mod.scenes_from_cuts(cuts, n_frames_capped, fps)
        ids = scene_mod.scene_ids_per_second(spans, n_sec)
        return np.asarray(scene_mod.scene_offsets(ids), np.float32) + 1.0

    @_gc_quiet
    def extract_features_batch(self, video_paths) -> List[Dict[str, np.ndarray]]:
        """Feature extraction for several clips through shared extractor
        calls (the JAX package's ``extract_features_batch``): host decode
        in a small thread pool (cv2 releases the GIL), the frames of every
        clip concatenated and run in chunks of up to MAX_SECONDS frames,
        scene decisions while the device works, results sliced back per
        clip (each with its own leading zero motion row). Returns one
        ``extract_features``-shaped dict per path, equal to per-clip
        extraction (frames are independent batch rows)."""
        from concurrent.futures import ThreadPoolExecutor

        if not video_paths:
            return []
        self._need_extractors()
        T: Dict[str, float] = {}
        t0 = time.perf_counter()
        tick = lambda name: T.__setitem__(name, time.perf_counter() - t0)
        with ThreadPoolExecutor(min(4, len(video_paths))) as pool:
            streams = list(pool.map(
                lambda p: video_io.stream_clip(p, MAX_SECONDS), video_paths))
        tick("decode+scene_scores")

        t0 = time.perf_counter()
        pix = [resize_crop_frames(s["frames_1fps"],
                                  self._clip_cfg.vision.image_size,
                                  backend=self.resize_backend)
               for s in streams]
        n_secs = [p.shape[0] for p in pix]
        all_pix = np.concatenate(pix, axis=0)
        clip_devs = [self.clip_chunk(all_pix[s:s + MAX_SECONDS])
                     for s in range(0, all_pix.shape[0], MAX_SECONDS)]
        tick("resize+clip_dispatch")

        t0 = time.perf_counter()
        scene_offsets = [self._scene_offset(s["scores"],
                                            s["n_frames_capped"], s["fps"], n)
                         for s, n in zip(streams, n_secs)]
        tick("scene_decisions")

        t0 = time.perf_counter()
        motion_devs = []
        # motion_diff_frames yields len(pairs) + 1 rows a clip
        n_mrows = [len(s["pairs"]) + 1 for s in streams]
        if self.motion_type != 0:
            all_diff = resize_crop_diff_frames(
                [d for s in streams for d in motion_diff_frames(s["pairs"])],
                self._maxvit_cfg.image_size, backend=self.resize_backend)
            motion_devs = [self.motion_chunk(all_diff[s:s + MAX_SECONDS])
                           for s in range(0, all_diff.shape[0], MAX_SECONDS)]
        tick("motion_prep+dispatch")

        t0 = time.perf_counter()
        sem = torch.cat([d[0] for d in clip_devs]).cpu().numpy()
        emo = torch.cat([d[1] for d in clip_devs]).cpu().numpy()
        mot = torch.cat(motion_devs).cpu().numpy() if motion_devs else None
        tick("device_fetch")
        self.last_extract_timings = T

        results = []
        off = moff = 0
        for s, n_sec, n_m, scene_offset in zip(streams, n_secs, n_mrows,
                                               scene_offsets):
            if mot is None:
                motion = scalar_motion(s["pairs"])
            else:
                motion = mot[moff:moff + n_m]
                moff += n_m
            results.append({"semantic": sem[off:off + n_sec],
                            "emotion": emo[off:off + n_sec],
                            "scene_offset": scene_offset, "motion": motion})
            off += n_sec
        return results

    def _postprocess(self, chord_ids, ln_nd, inst_probs, emotion, n_sec,
                     key, transposition_value, output_dir, video,
                     correct_panning, sound_font, caption_overlays
                     ) -> GenerateResult:
        """Host-side symbolic rendering of one clip's decoded arrays
        (reference: video2music.py:849-1052), as the JAX pipeline's."""
        os.makedirs(output_dir, exist_ok=True)
        chord_ids = chord_ids[:n_sec]
        ln_nd = ln_nd[:n_sec]
        inst_probs = inst_probs[:n_sec]

        note_density = np.clip(np.round(ln_nd[:, 0]), 0, 40).astype(int)
        loudness_lv = np.clip((ln_nd[:, 1] * 100).astype(int), 0, 50)
        emotion_idx = np.argmax(emotion[:n_sec], axis=1)
        velocities = [velocity_from_loudness(loudness_lv[i], emotion_idx[i])
                      for i in range(n_sec)]
        densities = [density_bucket(note_density[i], emotion_idx[i])
                     for i in range(n_sec)]
        inst_bin = (inst_probs >= INSTRUMENT_THRESHOLD).astype(np.float32)

        inv = chord_inv_dict()
        chords = [inv.get(int(i), "N") for i in chord_ids]
        offsets = chord_offsets(chords)
        midi_chords = voice([
            [] if s == "N" else Chord(s.replace(":", "")).getMIDI(
                key[0].lower(), 4)
            for s in chords])
        trans = TRANSPOSE_KEY.get(key, transposition_value)

        midi_path = os.path.join(output_dir, "output.mid")
        stems_dir = os.path.join(output_dir, "stems")
        rendered = _native.render_clip(
            midi_chords, offsets, densities, velocities,
            np.isin(emotion_idx, (0, 1, 2)), inst_bin,
            arp_inst=_INST_POLICY["arp"], vel_factor=_INST_POLICY["vel"],
            pan_ctrl=(_INST_POLICY["pan_ctrl_correct"] if correct_panning
                      else _INST_POLICY["pan_ctrl_quirk"]),
            pan_param=(_INST_POLICY["pan_param_correct"] if correct_panning
                       else _INST_POLICY["pan_param_quirk"]),
            chord_dur=CHORD_DURATION_BEATS, tempo=BASE_TEMPO)
        if rendered is not None:
            main_bytes, stem_bytes = rendered
            with open(midi_path, "wb") as f:
                f.write(main_bytes)
            os.makedirs(stems_dir, exist_ok=True)
            for inst_id, data in stem_bytes.items():
                with open(os.path.join(stems_dir,
                                       f"inst_{inst_id:02d}.mid"),
                          "wb") as f:
                    f.write(data)
        else:  # pure-Python fallback (no toolchain): identical output
            generated = MIDIFile(1)
            generated.addTempo(0, 0, BASE_TEMPO)
            track_files: Dict[int, MIDIFile] = {}
            for i, chord in enumerate(midi_chords):
                add_chord(generated, chord, offsets[i], densities[i], trans,
                          i * CHORD_DURATION_BEATS, CHORD_DURATION_BEATS,
                          velocities[i], int(emotion_idx[i]),
                          arpeggio_chord=True)
                for inst_id in np.nonzero(inst_bin[i])[0]:
                    inst_id = int(inst_id)
                    if inst_id not in track_files:
                        mf = MIDIFile(1)
                        mf.addTempo(0, 0, BASE_TEMPO)
                        pan = (PAN_VALS["left"] if inst_id in LEFT_PAN else
                               PAN_VALS["center"] if inst_id in CENTER_PAN
                               else PAN_VALS["right"])
                        if correct_panning:
                            mf.addControllerEvent(0, 0, 0, 10, pan)
                        else:
                            # reference quirk: pan value as controller number
                            mf.addControllerEvent(0, 0, 0, pan, 0)
                        track_files[inst_id] = mf
                    arp = (inst_id in ARPEGGIO_INSTRUMENTS
                           or int(emotion_idx[i]) in (0, 1, 2))
                    vel = velocities[i] * (
                        1.15 if inst_id in LOW_VELOCITY_INSTRUMENTS else 1.0)
                    add_chord(track_files[inst_id], chord, offsets[i],
                              densities[i], trans, i * CHORD_DURATION_BEATS,
                              CHORD_DURATION_BEATS, vel, int(emotion_idx[i]),
                              arpeggio_chord=arp)
            with open(midi_path, "wb") as f:
                generated.writeFile(f)
            os.makedirs(stems_dir, exist_ok=True)
            for inst_id, mf in track_files.items():
                with open(os.path.join(stems_dir,
                                       f"inst_{inst_id:02d}.mid"),
                          "wb") as f:
                    mf.writeFile(f)
        np.savetxt(os.path.join(output_dir, "inst.csv"), inst_bin,
                   delimiter=",", fmt="%.0f")

        audio_path = None
        out_video = None
        if video_io.has_fluidsynth():
            audio_path = os.path.join(output_dir, "output.flac")
            video_io.midi_to_audio(midi_path, audio_path, sound_font)
            if video is not None and video_io.has_ffmpeg():
                out_video = os.path.join(output_dir, "output.mp4")
                # caption_overlays: timed captions burned in by ffmpeg's
                # drawtext (video_io.chord_caption_overlays)
                video_io.mux_audio_onto_video(video, audio_path, out_video,
                                              overlays=caption_overlays)

        return GenerateResult(
            chords=chords, chord_ids=chord_ids, midi_path=midi_path,
            audio_path=audio_path, video_path=out_video,
            densities=densities, velocities=velocities,
            instruments=inst_bin, key=key)
