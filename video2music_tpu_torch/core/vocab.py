"""Chord / key / instrument vocabularies as device-friendly integer tables.

The reference keeps these as JSON dicts loaded at runtime — including *inside*
the autoregressive decode loop (reference: ``model/video_music_transformer.py:
1052-1057,1107-1123``, one host JSON lookup per generated token). The chord
vocabulary is fully regular (12 roots x 13 qualities + "N" + END + PAD), so we
generate it programmatically and derive flat int32 arrays mapping
``chord_id -> (root_id, attr_id)`` that live on device for in-graph decoding.

Layout parity is asserted in tests against the reference structure
(reference: ``dataset/vevo_meta/chord.json``, ``chord_root.json``,
``chord_attr.json``).
"""

from __future__ import annotations

import functools

import numpy as np

from .constants import (
    CHORD_ATTR_END,
    CHORD_ATTR_PAD,
    CHORD_END,
    CHORD_PAD,
    CHORD_ROOT_END,
    CHORD_ROOT_PAD,
    CHORD_SIZE,
)

# Order matters: these reproduce the reference JSON id assignment exactly.
ROOTS = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")
# Quality order within each root block of chord.json; "maj" is spelled as the
# bare root ("C" not "C:maj") in chord symbols.
QUALITIES = (
    "maj", "dim", "sus4", "min7", "min", "sus2", "aug",
    "dim7", "maj6", "hdim7", "7", "min6", "maj7",
)

INSTRUMENTS = (
    "accordion", "acousticbassguitar", "acousticguitar", "bass", "beat",
    "bell", "bongo", "brass", "cello", "clarinet", "classicalguitar",
    "computer", "doublebass", "drummachine", "drums", "electricguitar",
    "electricpiano", "flute", "guitar", "harmonica", "harp", "horn",
    "keyboard", "oboe", "orchestra", "organ", "pad", "percussion", "piano",
    "pipeorgan", "rhodes", "sampler", "saxophone", "strings", "synthesizer",
    "trombone", "trumpet", "viola", "violin", "voice",
)

# Key signature -> transposition offset (reference: dataset/vevo_dataset.py:21-56).
KEY_DIC = {
    "F major": -7, "F# major": -6, "Gb major": -6, "G major": -5,
    "G# major": -4, "Ab major": -4, "A major": -3, "A# major": -2,
    "Bb major": -2, "B major": -1, "C major": 0, "C# major": 1,
    "Db major": 1, "D major": 2, "D# major": 3, "Eb major": 3, "E major": 4,
    "D minor": -7, "D# minor": -6, "Eb minor": -6, "E minor": -5,
    "F minor": -4, "F# minor": -3, "Gb minor": -3, "G minor": -2,
    "G# minor": -1, "Ab minor": -1, "A minor": 0, "A# minor": 1,
    "Bb minor": 1, "B minor": 2, "C minor": 3, "C# minor": 4, "Db minor": 4,
}


def chord_symbol(chord_id: int) -> str:
    """Chord id -> symbol string ("N", "C", "C:dim", ..., "B:maj7")."""
    if chord_id == 0:
        return "N"
    if chord_id >= CHORD_END:
        raise ValueError(f"chord id {chord_id} is END/PAD, has no symbol")
    root = ROOTS[(chord_id - 1) // len(QUALITIES)]
    quality = QUALITIES[(chord_id - 1) % len(QUALITIES)]
    return root if quality == "maj" else f"{root}:{quality}"


@functools.lru_cache(maxsize=None)
def chord_dict() -> dict:
    """Symbol -> chord id. Byte-identical to reference chord.json."""
    return {chord_symbol(i): i for i in range(CHORD_END)}


@functools.lru_cache(maxsize=None)
def chord_inv_dict() -> dict:
    return {i: s for s, i in chord_dict().items()}


@functools.lru_cache(maxsize=None)
def chord_root_dict() -> dict:
    """Root symbol -> root id ("N"=0, "C"=1, ..., "B"=12)."""
    d = {"N": 0}
    d.update({r: i + 1 for i, r in enumerate(ROOTS)})
    return d


@functools.lru_cache(maxsize=None)
def chord_attr_dict() -> dict:
    """Quality symbol -> attr id ("N"=0, "maj"=1, ..., "maj7"=13)."""
    d = {"N": 0}
    d.update({q: i + 1 for i, q in enumerate(QUALITIES)})
    return d


@functools.lru_cache(maxsize=None)
def chord_to_root_attr_tables() -> tuple:
    """int32 tables (CHORD_SIZE,) mapping chord id -> root id / attr id.

    Replaces the per-token host JSON round-trip in the reference decode loop
    (reference: model/video_music_transformer.py:1107-1123). Follows the
    *generate-path* convention: bare root symbols ("C") get attr id 1 (maj),
    and "N" gets root 0 / attr 1 — matching ``chordAttrID = 1`` for
    single-part symbols there. END/PAD map to their own END/PAD ids.
    """
    root_tab = np.zeros(CHORD_SIZE, dtype=np.int32)
    attr_tab = np.zeros(CHORD_SIZE, dtype=np.int32)
    for cid in range(CHORD_END):
        sym = chord_symbol(cid)
        parts = sym.split(":")
        if len(parts) == 1:
            root_tab[cid] = chord_root_dict()[parts[0]]
            attr_tab[cid] = 1
        else:
            root_tab[cid] = chord_root_dict()[parts[0]]
            attr_tab[cid] = chord_attr_dict()[parts[1]]
    root_tab[CHORD_END] = CHORD_ROOT_END
    attr_tab[CHORD_END] = CHORD_ATTR_END
    root_tab[CHORD_PAD] = CHORD_ROOT_PAD
    attr_tab[CHORD_PAD] = CHORD_ATTR_PAD
    return root_tab, attr_tab


def parse_chord_ids(symbol: str) -> tuple:
    """Chord symbol -> (chord_id, root_id, attr_id).

    Dataset-path convention (reference: dataset/vevo_dataset.py:268-283):
    "N" -> (0, 0, 0); bare roots get attr 1.
    """
    cid = chord_dict()[symbol]
    parts = symbol.split(":")
    if len(parts) == 1:
        if parts[0] == "N":
            return cid, 0, 0
        return cid, chord_root_dict()[parts[0]], 1
    return cid, chord_root_dict()[parts[0]], chord_attr_dict()[parts[1]]


# Emotion -> allowed chord-quality pattern over the 13 qualities, in QUALITIES
# order (reference: dataset/vevo_dataset.py:461-476 comment block).
EMOTION_QUALITY_PATTERNS = np.array(
    [
        # maj dim sus4 min7 min sus2 aug dim7 maj6 hdim7 7 min6 maj7
        [1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0],  # 0 exciting
        [0, 1, 0, 1, 0, 0, 0, 1, 0, 1, 0, 0, 0],  # 1 fearful
        [0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0],  # 2 tense
        [0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],  # 3 sad
        [1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1],  # 4 relaxing
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],  # 5 neutral
    ],
    dtype=np.float32,
)


@functools.lru_cache(maxsize=None)
def emotion_chord_targets() -> np.ndarray:
    """(8, CHORD_SIZE) float32 rows: per-emotion allowed-chord indicator.

    Rows 0-5 are the six emotions tiled over the 12 roots with a leading 0
    for "N" and trailing zeros for END/PAD; row 6 is the END row (one-hot at
    CHORD_END); row 7 the PAD row (one-hot at CHORD_PAD). Mirrors the a0..a5 /
    aend / apad construction (reference: dataset/vevo_dataset.py:478-496).
    """
    rows = np.zeros((8, CHORD_SIZE), dtype=np.float32)
    for e in range(6):
        rows[e, 1 : 1 + 12 * 13] = np.tile(EMOTION_QUALITY_PATTERNS[e], 12)
    rows[6, CHORD_END] = 1.0
    rows[7, CHORD_PAD] = 1.0
    return rows
