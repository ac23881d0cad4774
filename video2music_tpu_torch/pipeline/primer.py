"""Primer-chord string parsing and key/primer fallback resolution.

Reproduces the reference's user-facing chord notation translation
("C Am F G", "Bb" flats, "#" sharps, m/m6/m7/M6/M7 shorthand) into vocab ids
(reference: ``video2music.py:757-815``) and the emotion-argmax fallback for
missing key/primer (``:722-735,752-756``).

A copy of ``video2music_tpu/pipeline/primer.py``: the port imports nothing
of the JAX package, not even its modules that are free of JAX.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.vocab import chord_attr_dict, chord_dict, chord_root_dict

FLATSHARP = {"Db": "C#", "Eb": "D#", "Gb": "F#", "Ab": "G#", "Bb": "A#"}

# key -> transposition used by the renderer (reference: video2music.py:54-79)
TRANSPOSE_KEY = {
    "F major": -7, "Gb major": -6, "G major": -5, "Ab major": -4,
    "A major": -3, "Bb major": -2, "B major": -1, "C major": 0,
    "Db major": 1, "D major": 2, "Eb major": 3, "E major": 4,
    "D minor": -7, "Eb minor": -6, "E minor": -5, "F minor": -4,
    "F# minor": -3, "G minor": -2, "G# minor": -1, "A minor": 0,
    "Bb minor": 1, "B minor": 2, "C minor": 3, "C# minor": 4,
}


def _translate(symbol: str) -> str:
    """User chord ("Am", "Bb7", "C#m7", "FM7") -> vocab symbol ("A:min"...)."""
    p = symbol
    if len(p) > 1:
        if p[1] == "b":
            p = FLATSHARP[p[0:2]] + p[2:]
        if p[1] == "#":
            p = p[0:2] + ":" + p[2:]
            type_idx = 2
        else:
            p = p[0:1] + ":" + p[1:]
            type_idx = 1
        if p[type_idx + 1:] == "m":
            p = p[0:type_idx] + ":min"
        if p[type_idx + 1:] == "m6":
            p = p[0:type_idx] + ":min6"
        if p[type_idx + 1:] == "m7":
            p = p[0:type_idx] + ":min7"
        if p[type_idx + 1:] == "M6":
            p = p[0:type_idx] + ":maj6"
        if p[type_idx + 1:] == "M7":
            p = p[0:type_idx] + ":maj7"
        if p[type_idx + 1:] == "":
            p = p[0:type_idx]
    return p


def parse_primer(primer: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """"C Am F G" -> (chord ids, root ids, attr ids) int arrays.

    Note: bare roots get attr id 0 here — the reference's generate-path
    convention (video2music.py:798-803), which differs from the dataset
    path's attr 1."""
    cdic, rdic, adic = chord_dict(), chord_root_dict(), chord_attr_dict()
    ids, roots, attrs = [], [], []
    for sym in primer.split():
        p = _translate(sym)
        ids.append(cdic[p])
        parts = p.split(":")
        if len(parts) == 1:
            roots.append(rdic[parts[0]])
            attrs.append(0)
        else:
            roots.append(rdic[parts[0]])
            attrs.append(adic[parts[1]])
    return (np.asarray(ids, np.int32), np.asarray(roots, np.int32),
            np.asarray(attrs, np.int32))


def resolve_key_and_primer(key: Optional[str], primer: Optional[str],
                           emotion_mean: np.ndarray):
    """Fill in missing key/primer from the dominant mean emotion
    (reference: video2music.py:722-735,752-756). Returns
    (key string, key_feature 0/1, primer string)."""
    emotion_idx = int(np.argmax(emotion_mean))
    if key is not None and key.strip():
        key = key.strip()
        # reference quirk (video2music.py:724-728): the minor test is the
        # literal suffix "min" — so "A minor"[-3:] == "nor" conditions the
        # model as MAJOR; only "A min" hits the minor branch. Reproduced.
        is_minor = key[-3:] == "min"
        key_feature = 1.0 if is_minor else 0.0
    else:
        if emotion_idx in (1, 2, 3):
            key, key_feature = "A minor", 1.0
        else:
            key, key_feature = "C major", 0.0
    if primer is None or not primer.strip():
        primer = "Am" if emotion_idx in (1, 2, 3) else "C"
    return key, key_feature, primer
