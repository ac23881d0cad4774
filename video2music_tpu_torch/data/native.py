"""ctypes bindings for the C++ feature-file parsers (native/v2m_native.cpp).

The port's copy of the JAX package's ``data/native.py``. The shared library
is built lazily with g++ on first use from the repository's
``native/v2m_native.cpp`` into the port's git-ignored ``_build/`` (never
next to the source, where the JAX package keeps its own build); every entry
point transparently falls back to the pure-Python parsers in
``data/parsers.py`` when the toolchain or library is unavailable, so the
framework never hard-depends on the native path. This is host code: no
device or kernel path falls back here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from ..core import constants as C

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "v2m_native.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD_DIR, "libv2m_native.so")

_lib = None
_lock = threading.Lock()
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                # build beside the target and rename: processes that build
                # at once never load a half-written library
                os.makedirs(_BUILD_DIR, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
                os.close(fd)
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                        check=True, capture_output=True)
                    os.replace(tmp, _SO)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            lib = ctypes.CDLL(_SO)
        except Exception:
            _build_failed = True
            return None
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.v2m_parse_scalar_lab.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_int32, ctypes.c_float]
        lib.v2m_parse_scalar_lab.restype = ctypes.c_int32
        lib.v2m_parse_emotion_lab.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_int32, ctypes.c_int32]
        lib.v2m_parse_emotion_lab.restype = ctypes.c_int32
        lib.v2m_parse_chord_lab.argtypes = [
            ctypes.c_char_p, i64p, i64p, i64p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.v2m_parse_chord_lab.restype = ctypes.c_int32
        lib.v2m_parse_instrument_csv.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_int32, ctypes.c_int32]
        lib.v2m_parse_instrument_csv.restype = ctypes.c_int32
        lib.v2m_hsv_score.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        lib.v2m_hsv_score.restype = ctypes.c_int64
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.v2m_render_clip.argtypes = [
            i32p, i32p, i32p, i32p, i32p, u8p, u8p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, f64p, i32p, i32p,
            ctypes.c_double, ctypes.c_double,
            u8p, ctypes.c_int64, i64p]
        lib.v2m_render_clip.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def parse_scalar_lab(path: str, max_seq: int, pad: float = 0.0,
                     offset: float = 0.0) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.full(max_seq, pad, np.float32)
    rc = lib.v2m_parse_scalar_lab(path.encode(), out, max_seq, offset)
    return None if rc < 0 else out


def parse_emotion_lab(path: str, max_seq: int,
                      n_emotions: int = 6) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.full((max_seq, n_emotions), C.EMOTION_PAD, np.float32)
    rc = lib.v2m_parse_emotion_lab(path.encode(), out, max_seq, n_emotions)
    return None if rc < 0 else out


def parse_chord_lab(path: str, max_seq: int
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        int, int]]:
    lib = _load()
    if lib is None:
        return None
    chord = np.full(max_seq, C.CHORD_PAD, np.int64)
    root = np.full(max_seq, C.CHORD_ROOT_PAD, np.int64)
    attr = np.full(max_seq, C.CHORD_ATTR_PAD, np.int64)
    key = ctypes.c_int32(0)
    last = ctypes.c_int32(max_seq)
    rc = lib.v2m_parse_chord_lab(path.encode(), chord, root, attr, max_seq,
                                 ctypes.byref(key), ctypes.byref(last))
    if rc < 0:
        return None
    return chord, root, attr, int(key.value), int(last.value)


def hsv_score(frame: np.ndarray, prev_hsv: Optional[np.ndarray],
              cur_hsv: np.ndarray, bgr: bool) -> Optional[float]:
    """Fused OpenCV-exact uint8 HSV convert + mean |delta| vs ``prev_hsv``
    (features/scene.py's per-frame content score) in one native pass.

    ``frame`` may be any (H, W, 3) uint8 view with unit channel stride —
    downscaled slices pass through without a contiguous copy. Fills
    ``cur_hsv`` (C-contiguous (H, W, 3) uint8) with the HSV planes; returns
    the mean over all channels (0.0 for the first frame), or None when the
    native library is unavailable or the layout unsupported (caller falls
    back to cv2/numpy)."""
    lib = _load()
    if lib is None:
        return None
    if (frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3
            or frame.strides[2] != 1):
        return None
    h, w = frame.shape[:2]
    total = lib.v2m_hsv_score(
        ctypes.c_void_p(frame.ctypes.data), h, w,
        frame.strides[0], frame.strides[1], 1 if bgr else 0,
        ctypes.c_void_p(0 if prev_hsv is None else prev_hsv.ctypes.data),
        ctypes.c_void_p(cur_hsv.ctypes.data),
        0 if prev_hsv is None else 1)
    return total / (h * w * 3.0)


def parse_instrument_csv(path: str, max_seq: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    out = np.full((max_seq, C.INSTRUMENT_SIZE), C.INSTRUMENT_PAD, np.float32)
    rc = lib.v2m_parse_instrument_csv(path.encode(), out, max_seq,
                                      C.INSTRUMENT_SIZE)
    return None if rc < 0 else out


def render_clip(midi_chords, offsets, densities, velocities, arp_emo,
                inst_bin, *, arp_inst, vel_factor, pan_ctrl, pan_param,
                chord_dur: float, tempo: float):
    """Native per-clip MIDI render (native/v2m_native.cpp:v2m_render_clip):
    the main chord SMF plus one stem per selected instrument, byte-identical
    to the midi/arpeggio + midi/writer Python loop in
    ``pipeline/api._postprocess`` (tested in tests/test_native.py).

    Args:
      midi_chords: list of per-second voiced note lists (len 0..5+); the
        Python semantics map to an effective length (skip when < 4 notes,
        the fifth only when exactly 5 — arpeggio.add_chord).
      offsets/densities/velocities: per-second ints.
      arp_emo: per-second bool — emotion forces arpeggio on stems.
      inst_bin: (n_sec, n_inst) selection mask (any numeric dtype).
      arp_inst/vel_factor/pan_ctrl/pan_param: per-instrument policy rows.
    Returns:
      (main_smf_bytes, {inst_id: stem_smf_bytes}) or None when the native
      library is unavailable (caller falls back to the Python loop).
    """
    lib = _load()
    if lib is None:
        return None
    n_sec = len(midi_chords)
    inst_bin = np.ascontiguousarray(inst_bin, np.uint8)
    n_inst = inst_bin.shape[1] if inst_bin.ndim == 2 else 0
    chords = np.zeros((n_sec, 5), np.int32)
    eff = np.zeros(n_sec, np.int32)
    for i, ch in enumerate(midi_chords):
        n = len(ch)
        if n < 4:
            continue
        eff[i] = 5 if n == 5 else 4
        chords[i, :min(n, 5)] = ch[:5]
    cap = int(64 + (n_sec * 20 + 16) * 5 * (1 + n_inst))
    sizes = np.zeros(1 + n_inst, np.int64)
    call_args = (
        np.ascontiguousarray(chords), np.ascontiguousarray(eff),
        np.ascontiguousarray(offsets, np.int32),
        np.ascontiguousarray(densities, np.int32),
        np.ascontiguousarray(velocities, np.int32),
        np.ascontiguousarray(arp_emo, np.uint8),
        inst_bin, n_sec, n_inst, 0,  # trans pre-zeroed: live-path quirk
        np.ascontiguousarray(arp_inst, np.uint8),
        np.ascontiguousarray(vel_factor, np.float64),
        np.ascontiguousarray(pan_ctrl, np.int32),
        np.ascontiguousarray(pan_param, np.int32),
        float(chord_dur), float(tempo))
    out = np.zeros(cap, np.uint8)
    total = lib.v2m_render_clip(*call_args, out, cap, sizes)
    if total < 0:
        # capacity heuristic undershot (the true worst case — multi-byte
        # VLQ deltas on sparse sequences — can exceed it): retry once with
        # a doubled buffer before conceding to the ~25x slower Python
        # render path; the C side bounds-checks, so -1 is always safe.
        cap *= 2
        out = np.zeros(cap, np.uint8)
        sizes[:] = 0
        total = lib.v2m_render_clip(*call_args, out, cap, sizes)
    if total < 0:
        return None
    main = out[:sizes[0]].tobytes()
    stems = {}
    off = int(sizes[0])
    for inst in range(n_inst):
        n = int(sizes[1 + inst])
        if n:
            stems[inst] = out[off:off + n].tobytes()
            off += n
    return main, stems
