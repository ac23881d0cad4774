"""Scene-cut detection: a from-scratch reimplementation of PySceneDetect's
AdaptiveDetector content logic as batched numpy/JAX frame-score math.

The reference runs ``scenedetect.AdaptiveDetector`` over the video
(reference: ``video2music.py:211-237``, ``script/scene_feature.py``;
requirements pin scenedetect 0.6.1). The 0.6.1 algorithm, reproduced
quirk-for-quirk:

  1. content score per frame = mean over the three HSV channels of the
     mean absolute pixel delta to the previous frame (ContentDetector's
     default hue/sat/lum weights 1/1/1, no edge component). The hue delta
     is a PLAIN absolute difference of the 0..179 H channel — scenedetect
     does NOT wrap hue around 180, so red-to-red transitions score high;
     reproduced as-is.
  2. only frames with a FULL +-window_width neighborhood are evaluated
     (the detector buffers 2w+1 scores and decides for the middle one;
     the first/last w frames can never cut);
  3. adaptive ratio = min(score / average, 255) with average =
     sum(neighborhood excluding self) / (2*window_width); a zero average
     maps to ratio 255 when the score clears min_content_val, else 0;
  4. a cut fires when ratio >= adaptive_threshold AND score >=
     min_content_val AND (it is the first cut OR at least min_scene_len
     frames passed since the last cut).

Scores come from cv2's SIMD uint8 HSV path (the same backend scenedetect
itself scores with; numpy-float fallback without cv2); the ratio/decision
logic is one vectorized pass — only the min-scene-length suppression stays
sequential (over the few candidate frames). tests/test_features.py checks
against an independent stateful transcription of the 0.6.1 detector loop
on synthetic clips.

Outputs mirror the reference's .lab conventions: per-second scene ids from
scene end-times (ceil seconds, video2music.py:222-229) and per-second
seconds-since-cut offsets (video2music.py:239-265).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _rgb_to_hsv_arrays(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB (T, H, W, 3) -> float32 HSV in OpenCV ranges
    (H in [0,180), S,V in [0,255]) without requiring cv2."""
    f = frames.astype(np.float32) / 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    maxc = np.max(f, axis=-1)
    minc = np.min(f, axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    # hue
    rc = np.where(delta > 0, (maxc - r) / np.maximum(delta, 1e-12), 0.0)
    gc = np.where(delta > 0, (maxc - g) / np.maximum(delta, 1e-12), 0.0)
    bc = np.where(delta > 0, (maxc - b) / np.maximum(delta, 1e-12), 0.0)
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)
    return np.stack([h * 180.0, s * 255.0, v * 255.0], axis=-1)


def auto_downscale(frames, target_width: int = 256):
    """Integer-stride downscale before scoring, mirroring PySceneDetect's
    auto-downscale (factor ~ width // 256); content deltas are stable under
    downscaling and the host cost drops by factor^2. ``frames`` may be an
    array (T, H, W, 3) or a sequence of (H, W, 3) frames — sequences are
    downscaled per frame without materializing the stacked clip (a 1-min
    720p clip stacked is ~GBs and measured ~90 s under memory pressure)."""
    if isinstance(frames, np.ndarray):
        factor = max(1, frames.shape[2] // target_width)
        if factor == 1:
            return frames
        return frames[:, ::factor, ::factor]
    if not len(frames):
        return frames
    factor = max(1, frames[0].shape[1] // target_width)
    if factor == 1:
        return frames
    return [f[::factor, ::factor] for f in frames]


class ContentScorer:
    """Incremental per-frame content scorer for streaming decode.

    Feed frames one at a time with :meth:`update` (e.g. straight out of
    the video decoder — ``pipeline.video_io.stream_clip`` does this so the
    full clip is never materialized), read :meth:`scores` at the end.
    Identical math to :func:`content_scores`, which is now a thin loop
    over this class.

    Fast paths, in preference order:

    1. the native fused kernel (``native/v2m_native.cpp:v2m_hsv_score``):
       OpenCV-bit-exact integer HSV conversion + |delta| accumulation in
       ONE strided C pass — no contiguous copy, no temporaries, no
       per-frame Python work beyond a single ctypes call (the cv2 chain
       below is four passes and three allocations per frame);
    2. cv2's SIMD uint8 HSV conversion + absdiff (the same integer HSV
       planes scenedetect 0.6.1 itself scores — measured ~150x over the
       whole-clip numpy-float pass);
    3. numpy float conversion (no cv2, no toolchain).

    Paths 1 and 2 produce bit-identical scores on uint8 input
    (parity-tested in tests/test_features.py); the float fallback agrees
    approximately (float vs integer HSV rounding).
    """

    def __init__(self, *, bgr: bool = False, downscale: bool = True,
                 target_width: int = 256):
        self.bgr = bgr
        self.downscale = downscale
        self.target_width = target_width
        self._factor: Optional[int] = None
        self._prev = None
        self._scores: List[float] = [ ]
        self._native_bufs = None  # (prev_hsv, cur_hsv) once shaped
        try:
            from ..data import native
            self._native = native if native.available() else None
        except Exception:
            self._native = None
        try:
            import cv2
            self._cv2 = cv2
        except ImportError:
            self._cv2 = None

    def _native_update(self, frame: np.ndarray) -> bool:
        """Score via the fused C kernel; False -> caller falls back."""
        if self._native is None or frame.dtype != np.uint8 \
                or frame.strides[-1] != 1:
            return False
        if self._native_bufs is None:
            shape = (frame.shape[0], frame.shape[1], 3)
            self._native_bufs = (np.empty(shape, np.uint8),
                                 np.empty(shape, np.uint8))
        prev_hsv, cur_hsv = self._native_bufs
        if cur_hsv.shape[:2] != frame.shape[:2]:
            return False
        score = self._native.hsv_score(
            frame, prev_hsv if self._prev is not None else None, cur_hsv,
            self.bgr)
        if score is None:
            return False
        self._scores.append(0.0 if self._prev is None else score)
        # swap: cur becomes prev for the next frame
        self._native_bufs = (cur_hsv, prev_hsv)
        self._prev = cur_hsv
        return True

    def update(self, frame: np.ndarray) -> None:
        if self._factor is None:
            self._factor = (max(1, frame.shape[1] // self.target_width)
                            if self.downscale else 1)
        if self._factor > 1:
            frame = frame[::self._factor, ::self._factor]
        if self._native_update(frame):
            return
        # fall back consistently: _prev (a valid HSV array either way)
        # carries over, but never resume the native path mid-stream —
        # its double buffers would no longer hold the last frame's HSV
        self._native = None
        cv2 = self._cv2
        if cv2 is not None and frame.dtype == np.uint8:
            code = cv2.COLOR_BGR2HSV if self.bgr else cv2.COLOR_RGB2HSV
            # scenedetect 0.6.1 quirk preserved: plain |dH| on the 0..179
            # hue channel, no wraparound (cv2 absdiff of the H plane)
            hsv = cv2.cvtColor(np.ascontiguousarray(frame), code)
            self._scores.append(
                0.0 if self._prev is None
                else float(np.mean(cv2.absdiff(hsv, self._prev))))
        else:
            rgb = frame[..., ::-1] if self.bgr else frame
            hsv = _rgb_to_hsv_arrays(np.asarray(rgb)[None])[0]
            # same 0.6.1 no-wraparound quirk on the float path
            self._scores.append(
                0.0 if self._prev is None
                else float(np.mean(np.abs(hsv - self._prev))))
        self._prev = hsv

    def scores(self) -> np.ndarray:
        return np.asarray(self._scores)


def content_scores(frames, downscale: bool = True,
                   bgr: bool = False) -> np.ndarray:
    """Per-frame HSV content score; score[0] = 0 (no previous frame).
    ``frames``: (T, H, W, 3) array or sequence of (H, W, 3) frames."""
    scorer = ContentScorer(bgr=bgr, downscale=downscale)
    for frame in frames:
        scorer.update(np.asarray(frame))
    return scorer.scores()


def adaptive_ratios(scores: np.ndarray, window_width: int = 2,
                    min_content_val: float = 15.0) -> np.ndarray:
    """Vectorized 0.6.1 adaptive ratio per frame; NaN where the
    +-window_width neighborhood is incomplete (never evaluated)."""
    T = len(scores)
    w = window_width
    ratios = np.full(T, np.nan)
    if T < 2 * w + 1:
        return ratios
    # neighborhood sums via a sliding window, excluding the center
    csum = np.concatenate([[0.0], np.cumsum(scores)])
    idx = np.arange(w, T - w)
    window_sum = csum[idx + w + 1] - csum[idx - w]  # inclusive 2w+1 window
    avg = (window_sum - scores[idx]) / (2.0 * w)
    zero = np.abs(avg) < 0.00001
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.minimum(scores[idx] / avg, 255.0)
    r = np.where(zero, np.where(scores[idx] >= min_content_val, 255.0, 0.0),
                 r)
    ratios[idx] = r
    return ratios


def detect_cuts(frames=None, *, adaptive_threshold: float = 3.0,
                min_scene_len: int = 15, window_width: int = 2,
                min_content_val: float = 15.0, bgr: bool = False,
                scores: Optional[np.ndarray] = None) -> List[int]:
    """Frame indices where new scenes start (excluding frame 0) —
    scenedetect 0.6.1 AdaptiveDetector semantics (see module docstring).

    Pass either ``frames`` or precomputed per-frame ``scores`` (e.g. from
    a :class:`ContentScorer` fed during streaming decode)."""
    if scores is None:
        if frames is None:
            raise ValueError("need frames or scores")
        scores = content_scores(frames, bgr=bgr)
    ratios = adaptive_ratios(scores, window_width, min_content_val)
    candidates = np.flatnonzero(
        (ratios >= adaptive_threshold) & (scores >= min_content_val))
    cuts: List[int] = []
    last_cut = None
    for i in candidates:
        if last_cut is None or i - last_cut >= min_scene_len:
            cuts.append(int(i))
            last_cut = int(i)
    return cuts


def scenes_from_cuts(cuts: Sequence[int], n_frames: int,
                     fps: float) -> List[Tuple[float, float]]:
    """Cut frame indices -> (start_sec, end_sec) scene spans."""
    bounds = [0] + list(cuts) + [n_frames]
    return [(bounds[i] / fps, bounds[i + 1] / fps)
            for i in range(len(bounds) - 1)]


def scene_ids_per_second(scene_list: Sequence[Tuple[float, float]],
                         n_seconds: int) -> List[int]:
    """Scene spans -> per-second scene ids (ceil of scene end, reference:
    video2music.py:222-229); all zeros when no scenes were detected."""
    if not scene_list:
        return [0] * n_seconds
    out = {}
    sec = 0
    for idx, (_, end) in enumerate(scene_list):
        for s in range(sec, math.ceil(end)):
            out[s] = idx
            sec += 1
    return [out.get(i, scene_list and len(scene_list) - 1)
            for i in range(min(len(out), n_seconds))] + \
           [len(scene_list) - 1] * max(0, n_seconds - len(out))


def scene_offsets(scene_ids: Sequence[int]) -> List[int]:
    """Seconds-since-scene-change (reference: video2music.py:253-262)."""
    if not scene_ids:
        return []
    out = []
    current, offset = scene_ids[0], 0
    for sid in scene_ids:
        if sid != current:
            current, offset = sid, 0
        out.append(offset)
        offset += 1
    return out
