"""Feature-file parsers: ``.lab`` / ``.npy`` / ``.csv`` -> fixed-length numpy.

Pure-numpy transcriptions of the per-line parsing in the reference's
``VevoDataset.createSample`` (reference: ``dataset/vevo_dataset.py:241-532``),
with identical padding values, truncation rules (``time >= max_seq`` breaks),
and id conventions. No torch, no pandas — a single pass over each file.
"""

from __future__ import annotations

import csv
from typing import Iterable, Optional, Tuple

import numpy as np

from ..core import constants as C
from ..core.vocab import chord_attr_dict, chord_dict, chord_root_dict


def _lines(source) -> Iterable[str]:
    if isinstance(source, (list, tuple)):
        return source
    with open(source, encoding="utf-8") as f:
        return f.read().splitlines()


def parse_chord_lab(source, max_seq: int = C.MAX_SEQ_CHORD):
    """Chord .lab -> (chord, root, attr) int arrays (max_seq,), key string,
    last chord time (for END insertion).

    Format: optional ``key <tonic> <mode>`` line, then ``<sec> <symbol>``
    lines (reference: vevo_dataset.py:252-291).
    """
    chord = np.full(max_seq, C.CHORD_PAD, np.int64)
    root = np.full(max_seq, C.CHORD_ROOT_PAD, np.int64)
    attr = np.full(max_seq, C.CHORD_ATTR_PAD, np.int64)
    cdic, rdic, adic = chord_dict(), chord_root_dict(), chord_attr_dict()
    key = ""
    last_time = max_seq
    for line in _lines(source):
        arr = line.strip().split(" ")
        if not arr or arr[0] == "":
            continue
        if arr[0] == "key":
            key = arr[1] + " " + arr[2]
            continue
        t = int(arr[0])
        if t >= max_seq:
            break
        last_time = t
        sym = arr[1]
        chord[t] = cdic[sym]
        parts = sym.split(":")
        if len(parts) == 1:
            if parts[0] == "N":
                root[t], attr[t] = rdic["N"], adic["N"]
            else:
                root[t], attr[t] = rdic[parts[0]], 1
        else:
            root[t], attr[t] = rdic[parts[0]], adic[parts[1]]
    return chord, root, attr, key, last_time


def parse_chord_lab_key(source) -> str:
    """Only the key header of a chord .lab (used on the un-normalized file to
    recover the original key for key_val, reference: vevo_dataset.py:292-304)."""
    for line in _lines(source):
        arr = line.strip().split(" ")
        if arr and arr[0] == "key":
            return arr[1] + " " + arr[2]
    return ""


def parse_scalar_lab(source, max_seq: int = C.MAX_SEQ_VIDEO,
                     pad: float = 0.0, offset: float = 0.0) -> np.ndarray:
    """``<sec> <value>`` lines -> float32 (max_seq,). ``offset=1`` reproduces
    the scene-offset ``int(sceneID)+1`` shift (reference: vevo_dataset.py:343)."""
    out = np.full(max_seq, pad, np.float32)
    for line in _lines(source):
        arr = line.strip().split(" ")
        if not arr or arr[0] in ("", "time"):
            continue
        t = int(arr[0])
        if t >= max_seq:
            break
        out[t] = float(arr[1]) + offset
    return out


def parse_emotion_lab(source, max_seq: int = C.MAX_SEQ_VIDEO,
                      n_emotions: int = 6) -> np.ndarray:
    """Emotion .lab (``time`` header + per-second 5/6 probabilities) ->
    float32 (max_seq, n_emotions) (reference: vevo_dataset.py:407-436)."""
    out = np.full((max_seq, n_emotions), C.EMOTION_PAD, np.float32)
    for line in _lines(source):
        arr = line.strip().split(" ")
        if not arr or arr[0] in ("", "time"):
            continue
        t = int(arr[0])
        if t >= max_seq:
            break
        out[t] = np.asarray([float(v) for v in arr[1:1 + n_emotions]],
                            np.float32)
    return out


def parse_instrument_csv(source, max_seq: int = C.MAX_SEQ_VIDEO) -> np.ndarray:
    """Instrument csv (header row + 40 binary columns per second) ->
    float32 (max_seq, 40) (reference: vevo_dataset.py:453-459 via pandas)."""
    out = np.full((max_seq, C.INSTRUMENT_SIZE), C.INSTRUMENT_PAD, np.float32)
    if isinstance(source, (list, tuple)):
        rows = [r for r in csv.reader(source)]
    else:
        with open(source, newline="") as f:
            rows = [r for r in csv.reader(f)]
    data = np.asarray(rows[1:], dtype=np.float32)[:max_seq]
    if data.size:
        out[: data.shape[0], : data.shape[1]] = data
    return out


def load_semantic_npy(path, max_seq: int = C.MAX_SEQ_VIDEO) -> np.ndarray:
    """Semantic .npy (T, D) -> pad/truncate to (max_seq, D)
    (reference: vevo_dataset.py:518-532)."""
    feat = np.load(path).astype(np.float32)
    D = feat.shape[1]
    out = np.full((max_seq, D), C.SEMANTIC_PAD, np.float32)
    T = min(feat.shape[0], max_seq)
    out[:T] = feat[:T]
    return out


def load_motion(path, max_seq: int = C.MAX_SEQ_VIDEO,
                motion_type: int = 0) -> np.ndarray:
    """motion_type 0: scalar .lab -> (max_seq,); 1/2: .npy (T, 512/768)
    padded/truncated (reference: vevo_dataset.py:367-393)."""
    if motion_type == 0:
        return parse_scalar_lab(path, max_seq, pad=C.MOTION_PAD)
    dim = 512 if motion_type == 1 else 768
    feat = np.load(path).astype(np.float32)
    out = np.zeros((max_seq, dim), np.float32)
    T = min(feat.shape[0], max_seq)
    out[:T] = feat[:T, :dim]
    return out
