"""Chord-symbol parser and voice-leading smoother (ezchord re-implementation).

Re-derivation of the vendored "ezchord" module (reference:
``utilities/chord_to_midi.py``): chord strings ("Cmin7", "F#maj7", "iiø",
slash chords, degree alterations) to MIDI pitch sets, plus ``voice()`` which
minimizes semitone movement between consecutive chords.

Parser quirks reproduced on purpose (behavior parity, reference
``chord_to_midi.py:199-298``):
  * "hdim7" is NOT a recognized mode — it falls through to DOM with a
    flat 7, so half-diminished chords render as dominant 7ths;
  * "dim7" keeps the minor 7th (deg 7 shifted -1), not the diminished 7th;
  * the pitch dict preserves insertion order (bass, root, 3, 5, then extra
    degrees) — ``voice()`` depends on this order.
"""

from __future__ import annotations

import math
from enum import Enum, auto
from typing import Dict, List


class Mode(Enum):
    DIM = auto()
    MIN = auto()
    MAJ = auto()
    DOM = auto()
    AUG = auto()
    SUS2 = auto()
    SUS = auto()
    FIVE = auto()


TEXT_TO_MODE = {
    "maj": Mode.MAJ, "dim": Mode.DIM, "o": Mode.DIM, "min": Mode.MIN,
    "m": Mode.MIN, "-": Mode.MIN, "aug": Mode.AUG, "+": Mode.AUG,
    "sus2": Mode.SUS2, "sus": Mode.SUS, "5": Mode.FIVE, "five": Mode.FIVE,
}

MODE_TO_SHIFT = {
    Mode.MAJ: {3: 0, 5: 0}, Mode.DOM: {3: 0, 5: 0}, Mode.DIM: {3: -1, 5: -1},
    Mode.MIN: {3: -1, 5: 0}, Mode.AUG: {3: 0, 5: 1}, Mode.SUS2: {3: -2, 5: 0},
    Mode.SUS: {3: 1, 5: 0}, Mode.FIVE: {3: 3, 5: 0},
}

NOTE_TO_PITCH = {"a": 9, "b": 11, "c": 12, "d": 14, "e": 16, "f": 17,
                 "g": 19}
PITCH_TO_NOTE = {p: n for n, p in NOTE_TO_PITCH.items()}
RM_TO_PITCH = {"vii": 11, "iii": 4, "vi": 9, "iv": 5, "ii": 2, "i": 0,
               "v": 7}
ACC_TO_SHIFT = {"b": -1, "#": 1}
SCALE_DEGREE_SHIFT = {1: 0, 2: 2, 3: 4, 4: 5, 5: 7, 6: 9, 7: 11}


def _get_number(s: str):
    digits = "".join(ch for ch in s if ch.isdigit())
    return int(digits) if digits else None


def text_to_pitch(text: str, key: str = "c") -> int:
    """Note name or roman numeral -> pitch (C4-relative 12-based)."""
    text = text.lower()
    is_letter = text[0] in NOTE_TO_PITCH
    if is_letter:
        pitch = NOTE_TO_PITCH[text[0]]
    else:
        pitch = 0
        for rm in RM_TO_PITCH:
            if rm in text:
                pitch = RM_TO_PITCH[rm] + text_to_pitch(key)
                break
    for ch in text[1 if is_letter else 0:]:
        if ch in ACC_TO_SHIFT:
            pitch += ACC_TO_SHIFT[ch]
    return pitch


def pitch_to_text(pitch: int) -> str:
    octave = math.floor(pitch / 12)
    p = pitch % 12
    p = p + (12 if p < 9 else 0)
    accidental = ""
    if p not in PITCH_TO_NOTE:
        p = (p + 1) % 12
        p = p + (12 if p < 9 else 0)
        accidental = "b"
    return PITCH_TO_NOTE[p].upper() + accidental + str(octave)


def degree_to_shift(deg: int) -> int:
    return SCALE_DEGREE_SHIFT[(deg - 1) % 7 + 1] + math.floor(deg / 8) * 12


class Chord:
    """Parse a chord symbol into root / mode / bass / degree alterations."""

    def __init__(self, string: str):
        self.string = string
        self.degrees: Dict[int, int] = {}
        self.root = ""
        self.bassnote = ""
        self.mode = None
        self.split: List[str] = []

        s = string + " "
        sect = ""
        notes = list(NOTE_TO_PITCH)
        rms = list(RM_TO_PITCH)
        accs = list(ACC_TO_SHIFT)
        modes = list(TEXT_TO_MODE)
        root_added = mode_added = False
        is_rm = is_slash = is_maj7 = False

        for i in range(len(s) - 1):
            sect += s[i]
            cur, nxt = s[i].lower(), s[i + 1].lower()
            root_found = (not root_added
                          and cur in notes + rms + accs
                          and nxt not in rms + accs)
            mode_found = False
            num_found = cur.isdigit() and not nxt.isdigit()

            if (i == len(s) - 2 or root_found or num_found or nxt == "/"
                    or cur == ")"):
                if root_found:
                    self.root = sect
                    root_added = True
                    is_rm = self.root in rms
                elif sect and sect[0] == "/":
                    if sect[1] == "9":  # 6/9 chords
                        self.degrees[9] = 0
                    else:
                        is_slash = True
                        self.bassnote = sect[1:]
                else:
                    if not mode_added:
                        for mode in modes:
                            if mode in sect[: len(mode)]:
                                self.mode = TEXT_TO_MODE[mode]
                                mode_added = mode_found = True
                                break
                    if not mode_added and not is_rm and \
                            str(_get_number(sect)) == sect:
                        self.mode = Mode.DOM
                        mode_found = mode_added = True
                    deg = _get_number(sect)
                    if deg is not None:
                        shift = sect.count("#") - sect.count("b")
                        if (not mode_found) or deg % 2 == 0:
                            self.degrees[deg] = shift
                        elif deg >= 7:
                            for d in range(7, deg + 1):
                                if d % 2 != 0:
                                    self.degrees[d] = shift
                self.split.append(sect)
                sect = ""

        if not mode_added:
            # minor roman numerals default to MIN, otherwise DOM
            self.mode = (Mode.MIN if self.root in rms
                         and self.root == self.root.lower() else Mode.DOM)
        if not is_slash:
            self.bassnote = self.root
        for sect in self.split:
            is_maj7 = ("maj" in sect) or is_maj7
        if 7 in self.degrees and not is_maj7:
            self.degrees[7] = -1

    def getMIDI(self, key: str = "c", octave: int = 4) -> List[int]:
        notes: Dict[int, int] = {}
        notes[0] = text_to_pitch(self.bassnote, key) - 12
        root = text_to_pitch(self.root, key)
        notes[1] = root
        notes[3] = root + degree_to_shift(3) + MODE_TO_SHIFT[self.mode][3]
        notes[5] = root + degree_to_shift(5) + MODE_TO_SHIFT[self.mode][5]
        for deg, shift in self.degrees.items():
            notes[deg] = root + degree_to_shift(deg) + shift
        return [p + 12 * octave for p in notes.values()]


def voice(chords: List[List[int]]) -> List[List[int]]:
    """Voice-leading smoother: move each non-bass note to the octave closest
    to its nearest neighbor in the previous chord, clamped to stay within 8
    semitones of the register center (reference: chord_to_midi.py:132-198)."""
    center = 0
    voiced: List[List[int]] = []
    count = 0
    prev = None
    for chord in chords:
        if len(chord) == 0:
            voiced.append([])
            continue
        if count == 0:
            voiced.append(chord)
            count += 1
            center = chord[1] + 3
            prev = chord
            continue

        out: List[int] = []
        for i, cur in enumerate(chord):
            if i == 0:  # bass: at most one octave correction
                p = prev[0]
                best = cur
                if abs(cur - p) > 7:
                    if cur < p and abs(cur + 12 - p) < abs(cur - p):
                        best = cur + 12
                    elif cur > p and abs(cur - 12 - p) < abs(cur - p):
                        best = cur - 12
                out.append(best)
                continue
            neighbor = None
            allowance = -1
            while neighbor is None:
                allowance += 1
                for j, p in enumerate(prev):
                    if j == 0:
                        continue
                    d = abs(cur - p) % 12
                    if d == allowance or d == 12 - allowance:
                        neighbor = p
                        break
            if cur <= neighbor:
                best = cur + math.floor((neighbor - cur + 6) / 12) * 12
            else:
                best = cur + math.ceil((neighbor - cur - 6) / 12) * 12
            if abs(best - center) > 8 and allowance <= 2:
                best = cur
            out.append(best)
        out.sort()
        voiced.append(out)
        prev = out
    return voiced
