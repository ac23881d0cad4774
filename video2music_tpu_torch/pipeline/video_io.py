"""Host-side video IO: frame extraction and audio/video muxing.

The reference shells out to ffmpeg for 1-fps JPEG extraction
(``video2music.py:144-147``) and uses moviepy (ffmpeg underneath) to mux the
rendered audio back onto the video (``:1033-1052``). Here frames are read
directly with cv2 (no JPEG round-trip, frames go to the feature extractors
as one batched array) and the mux is a single ffmpeg invocation.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import subprocess
import threading
from typing import List, Tuple

import numpy as np


_gc_quiet_lock = threading.Lock()
_gc_quiet_depth = 0


@contextlib.contextmanager
def _gc_quiet():
    """Pause the cyclic GC around host frame loops (reentrant).

    After jax/flax model construction the interpreter holds ~270k tracked
    objects; a decode loop allocating ~1500 numpy frames then triggers
    repeated collections that each scan that whole graph. Measured on the
    product pipeline (60 s clip, single-core host): 90.5 s with GC on vs
    1.5 s with the long-lived objects frozen out — a 60x swing from GC
    alone. ``freeze()`` moves everything currently alive into the
    permanent generation (so the closing collection doesn't scan it
    either); ``disable()`` stops collections during the loop. Frame
    arrays themselves die by refcount, so nothing cyclic accumulates.

    Reentrancy: batch extraction decodes several clips concurrently; a
    depth counter keeps the GC off until the LAST loop exits rather than
    re-enabling when the first finishes."""
    global _gc_quiet_depth
    with _gc_quiet_lock:
        if _gc_quiet_depth == 0:
            gc.disable()
            gc.freeze()
        _gc_quiet_depth += 1
    try:
        yield
    finally:
        with _gc_quiet_lock:
            _gc_quiet_depth -= 1
            if _gc_quiet_depth == 0:
                gc.unfreeze()
                gc.enable()


# Public alias: host-side frame loops OUTSIDE this module (pipeline
# extraction's resize/flush/fetch phases) pay the same multi-second GC tax
# per ~1k allocations once jax/flax's ~270k tracked objects are live —
# measured 2.1 s for a 60-iteration cv2.resize loop GC-on vs 0.2 s inside
# this guard.
gc_quiet = _gc_quiet


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def has_fluidsynth() -> bool:
    return shutil.which("fluidsynth") is not None


def read_frames(video_path: str, max_seconds: int = 300):
    """Decode the video once; returns (frames_1fps_rgb, frames_all_bgr, fps,
    duration_sec). frames_1fps matches the reference's ffmpeg 1-fps select
    (first frame of each second); frames_all feed scene/motion extraction."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {video_path!r}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    frames_all: List[np.ndarray] = []
    frames_1fps: List[np.ndarray] = []
    next_second = 0.0
    idx = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        t = idx / fps
        if t < max_seconds:
            frames_all.append(frame)
            if t >= next_second:
                frames_1fps.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                next_second += 1.0
        idx += 1
    cap.release()
    duration = idx / fps
    return np.stack(frames_1fps), frames_all, fps, duration


class ClipStream:
    """Incremental single-pass decode: iterate to receive
    ``(frame_1fps_rgb_or_None, pair_or_None)`` events as frames decode;
    scene scores accumulate inline. After iteration completes, the
    summary attributes are set: ``fps``, ``duration``, ``n_frames``,
    ``n_frames_capped``, ``scores``.

    This is the engine under :func:`stream_clip`; consume it directly to
    overlap work with the decode (``pipeline.api.extract_features``
    dispatches a 30-frame extractor chunk to the TPU every time 30
    seconds of video have decoded, so H2D + device compute ride inside
    the host decode wall-clock). Selection semantics are identical to
    ``read_frames`` + ``second_boundary_pairs`` + ``content_scores``
    (parity-tested)."""

    def __init__(self, video_path: str, max_seconds: int = 300,
                 scene_scores: bool = True):
        self.path = str(video_path)
        self.max_seconds = max_seconds
        self.want_scores = scene_scores
        self.fps: float = 0.0
        self.duration: float = 0.0
        self.n_frames: int = 0
        self.n_frames_capped: int = 0
        self.scores = None

    def __iter__(self):
        import cv2

        from ..features.scene import ContentScorer

        cap = cv2.VideoCapture(self.path)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video {self.path!r}")
        self.fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        scorer = ContentScorer(bgr=True) if self.want_scores else None
        with _gc_quiet():
            next_second = 0.0
            prev_time = 0
            prev_frame = None
            idx = 0
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                t = idx / self.fps
                if t < self.max_seconds:
                    self.n_frames_capped += 1
                    if scorer is not None:
                        scorer.update(frame)
                    f1 = None
                    pair = None
                    if t >= next_second:
                        f1 = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                        next_second += 1.0
                    if idx >= 1 and t - prev_time >= 1.0:
                        pair = (prev_frame, frame)
                        prev_time = int(t)
                    prev_frame = frame
                    if f1 is not None or pair is not None:
                        yield f1, pair
                else:
                    # past the cap: only count frames for the duration
                    # (grab skips decode-to-BGR and the copy)
                    idx += 1
                    while cap.grab():
                        idx += 1
                    break
                idx += 1
        cap.release()
        self.n_frames = idx
        self.duration = idx / self.fps
        self.scores = scorer.scores() if scorer is not None else None


def stream_clip(video_path: str, max_seconds: int = 300,
                scene_scores: bool = True) -> dict:
    """ONE streaming decode pass producing exactly what feature extraction
    needs, without ever materializing the full clip.

    Returns a dict:
      * ``frames_1fps``: uint8 RGB (n_sec, H, W, 3) — the reference's
        1-fps ffmpeg select (first frame of each second), for CLIP;
      * ``pairs``: list of (prev, cur) BGR consecutive-frame pairs at each
        1-second boundary, for MaxViT motion (see
        :func:`second_boundary_pairs` for the reference semantics);
      * ``scores``: per-frame scene content scores (or None), computed
        incrementally via ``features.scene.ContentScorer`` — feed them to
        ``detect_cuts(scores=...)``;
      * ``fps``, ``duration``, ``n_frames`` (all decoded frames) and
        ``n_frames_capped`` (frames under ``max_seconds`` — the length
        ``read_frames`` would have given ``frames_all``).

    Selection semantics are identical to ``read_frames`` +
    ``second_boundary_pairs`` + ``content_scores`` (parity-tested in
    tests/test_pipeline.py). The difference is performance: retaining a
    60 s clip is ~1 GB of arrays, and on a host where the interpreter
    already holds a jitted model the allocation churn made the naive path
    take ~90 s/clip (GC passes over ~270k live objects — see
    :func:`_gc_quiet`). Streaming keeps only what extraction consumes
    (~100 MB) and runs the loop with the GC paused: ~2 s/clip. Built on
    :class:`ClipStream`; consume that directly to overlap work with the
    decode."""
    cs = ClipStream(video_path, max_seconds, scene_scores)
    frames_1fps: List[np.ndarray] = []
    pairs: List[Tuple[np.ndarray, np.ndarray]] = []
    for f1, pair in cs:
        if f1 is not None:
            frames_1fps.append(f1)
        if pair is not None:
            pairs.append(pair)
    return dict(frames_1fps=np.stack(frames_1fps) if frames_1fps else
                np.zeros((0, 2, 2, 3), np.uint8),
                pairs=pairs, scores=cs.scores,
                fps=cs.fps, duration=cs.duration, n_frames=cs.n_frames,
                n_frames_capped=cs.n_frames_capped)


def frames_per_second(frames_all: List[np.ndarray], fps: float
                      ) -> List[np.ndarray]:
    """One BGR frame per second."""
    out = []
    next_second = 0.0
    for idx, frame in enumerate(frames_all):
        if idx / fps >= next_second:
            out.append(frame)
            next_second += 1.0
    return out


def second_boundary_pairs(frames_all: List[np.ndarray], fps: float
                          ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(previous frame, frame) pairs at each 1-second boundary.

    The reference's motion loop updates prev_frame EVERY frame and diffs
    when a second has elapsed (video2music.py:311-335), so each diff spans
    ~1/fps — consecutive frames — not a full second. The first boundary has
    no pair (the reference emits a zeros row for it)."""
    pairs = []
    prev_time = 0
    for idx in range(1, len(frames_all)):
        t = idx / fps
        if t - prev_time >= 1.0:
            pairs.append((frames_all[idx - 1], frames_all[idx]))
            prev_time = int(t)
    return pairs


def midi_to_audio(midi_path: str, audio_path: str,
                  sound_font: str | None = None) -> None:
    """FluidSynth render (reference: video2music.py:994-996 via midi2audio)."""
    cmd = ["fluidsynth", "-ni"]
    if sound_font:
        cmd.append(str(sound_font))
    cmd += [str(midi_path), "-F", str(audio_path), "-r", "44100"]
    subprocess.run(cmd, check=True, capture_output=True)


def mix_audio(paths: List[str], out_path: str) -> None:
    """Overlay-mix rendered stems (replaces the pydub overlay loop,
    reference: video2music.py:997-1031) with one ffmpeg amix."""
    cmd = ["ffmpeg", "-y"]
    for p in paths:
        cmd += ["-i", str(p)]
    cmd += ["-filter_complex",
            f"amix=inputs={len(paths)}:duration=longest:normalize=0",
            str(out_path)]
    subprocess.run(cmd, check=True, capture_output=True)


def _drawtext_escape(text: str) -> str:
    """Escape a string for ffmpeg drawtext's text= option."""
    out = []
    for ch in text:
        if ch in ":\\'%":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def _find_font() -> str:
    import glob
    for pattern in ("/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
                    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                    "/usr/share/fonts/**/*.ttf"):
        hits = glob.glob(pattern, recursive="*" in pattern)
        if hits:
            return hits[0]
    return ""


def drawtext_filter(overlays) -> str:
    """ffmpeg -vf drawtext chain for timed centered captions — the
    host-side equivalent of the reference's moviepy TextClip+ImageMagick
    overlays (reference: generate.py:68-72,694-709: white 24pt text,
    centered, 20px from the top, enabled for [start, end)).

    overlays: iterable of (text, start_sec, end_sec).
    """
    font = _find_font()
    fontopt = f":fontfile={font}" if font else ""
    parts = []
    for text, start, end in overlays:
        parts.append(
            "drawtext=text='" + _drawtext_escape(str(text)) + "'"
            + fontopt
            + ":fontsize=24:fontcolor=white:x=(w-text_w)/2:y=20"
            + f":enable='between(t,{float(start)},{float(end)})'")
    return ",".join(parts)


def chord_caption_overlays(num_primer: int, duration: float):
    """The reference's two captions: "Prime Chords" over the primer span,
    "Generated Chords" for the rest (reference: generate.py:700-701)."""
    return [("Prime Chords", 0.0, float(num_primer)),
            ("Generated Chords", float(num_primer), float(duration))]


def mux_audio_onto_video(video_path: str, audio_path: str,
                         out_path: str, overlays=None) -> None:
    """Attach audio to video, trimming to the shorter stream
    (reference: video2music.py:1033-1052 via moviepy). With ``overlays``
    (see drawtext_filter) the captions are burned in — that path re-encodes
    (libx264, like the reference's write_videofile at generate.py:704-709)
    instead of stream-copying."""
    cmd = ["ffmpeg", "-y", "-i", str(video_path), "-i", str(audio_path),
           "-map", "0:v:0", "-map", "1:a:0"]
    if overlays:
        cmd += ["-vf", drawtext_filter(overlays), "-c:v", "libx264",
                "-c:a", "aac"]
    else:
        cmd += ["-c:v", "copy"]
    cmd += ["-shortest", str(out_path)]
    subprocess.run(cmd, check=True, capture_output=True)
