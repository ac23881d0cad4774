"""Arpeggiated chord rendering (the ``addChord`` logic and its density /
velocity post-processing, reference: ``video2music.py:476-585,860-913``).

The per-density note patterns are expressed as data tables of
(chord-note index, beat offset, velocity factor) instead of the reference's
five copy-pasted if-chains; the emitted notes are identical.

Reproduced reference quirks:
  * the emotion-conditioned transposition inside addChord is computed and
    then overridden to 0 (``trans_val = 0  # FLAG``, video2music.py:488) —
    the live path emits untransposed notes; pass
    ``apply_transposition=True`` to get the written-but-disabled behavior;
  * chords with fewer than 4 voiced notes are skipped entirely.
"""

from __future__ import annotations

from typing import List, Sequence

F1, F2, F3, F4, F5 = 1.1, 0.95, 0.98, 1.0, 0.95
DIMINISH = 0.6  # block-chord velocity scale (arpeggio_chord=False)

# density -> (even-offset pattern, odd-offset pattern, fifth-note time)
# pattern entries: (chord note index, beat offset, velocity factor)
_PATTERNS = {
    0: ([(0, 0.0, F1), (1, 1.0, F2)],
        [(2, 0.0, F3), (3, 1.0, F4)], 2.0),
    1: ([(0, 0.0, F1), (1, 0.5, F2), (2, 1.0, F3)],
        [(3, 0.0, F4), (1, 0.5, F2), (2, 1.0, F3)], 1.5),
    2: ([(0, 0.0, F1), (1, 0.5, F2), (2, 1.0, F3), (3, 1.5, F4)],
        [(2, 0.0, F3), (1, 0.5, F2), (2, 1.0, F3), (3, 1.5, F4)], 2.0),
    3: ([(0, 0.0, F1), (1, 0.25, F2), (2, 0.5, F3), (1, 0.75, F2),
         (3, 1.0, F4), (2, 1.5, F3)],
        [(1, 0.0, F2), (0, 0.25, F1), (1, 0.5, F2), (2, 0.75, F3),
         (3, 1.0, F4), (2, 1.5, F3)], 2.0),
    4: ([(0, 0.0, F1), (1, 0.25, F2), (2, 0.5, F3), (1, 0.75, F2),
         (3, 1.0, F4), (2, 1.25, F3), (1, 1.5, F2), (2, 1.75, F3)],
        [(1, 0.0, F2), (0, 0.25, F1), (1, 0.5, F2), (2, 0.75, F3),
         (3, 1.0, F4), (2, 1.25, F3), (1, 1.5, F2), (2, 1.75, F3)], 2.0),
}


def emotion_transposition(emotion_index: int) -> int:
    """The written-but-disabled per-emotion shift (video2music.py:477-487)."""
    if emotion_index in (1, 2):
        return -2
    if emotion_index == 3:
        return -1
    if emotion_index in (0, 4):
        return 1
    return 0


def add_chord(midifile, chord: Sequence[int], chord_offset: int,
              density_val: int, trans_val: int, time: float, duration: float,
              velocity: float, emotion_index: int, *,
              arpeggio_chord: bool = False,
              apply_transposition: bool = False) -> None:
    """Emit one chord's notes into ``midifile`` (a midi.writer.MIDIFile)."""
    if apply_transposition:
        trans_val = trans_val + emotion_transposition(emotion_index)
    else:
        trans_val = 0  # reference live path (video2music.py:488)
    if len(chord) < 4:
        return
    if arpeggio_chord:
        even, odd, fifth_t = _PATTERNS[int(density_val)]
        pattern = even if chord_offset % 2 == 0 else odd
        for idx, dt, f in pattern:
            midifile.addNote(0, 0, chord[idx] + trans_val, time + dt,
                             duration, int(velocity * f))
        if len(chord) == 5:
            midifile.addNote(0, 0, chord[4] + trans_val, time + fifth_t,
                             duration, int(velocity * F5))
    else:
        for idx, f in zip(range(4), (F1, F2, F3, F4)):
            midifile.addNote(0, 0, chord[idx] + trans_val, time, duration,
                             int(velocity * f * DIMINISH))
        if len(chord) == 5:
            midifile.addNote(0, 0, chord[4] + trans_val, time, duration,
                             int(velocity * F5 * DIMINISH))


def chord_offsets(id_list: List) -> List[int]:
    """Run-position of each element within its run of equal ids
    (reference convert_format_id_to_offset, video2music.py:442-452)."""
    out = []
    current, offset = None, 0
    for i, v in enumerate(id_list):
        if i == 0:
            current = v
        elif v != current:
            current, offset = v, 0
        out.append(offset)
        offset += 1
    return out


def velocity_from_loudness(loudness_lv: int, emotion_index: int,
                           *, exponent: float = 0.3, min_loudness: int = 0,
                           max_loudness: int = 50, min_velocity: int = 49,
                           max_velocity: int = 112) -> int:
    """Loudness level (0-50) -> MIDI velocity with emotion bump
    (reference: video2music.py:875-891)."""
    import numpy as np
    v = np.round(((loudness_lv - min_loudness)
                  / (max_loudness - min_loudness)) ** exponent
                 * (max_velocity - min_velocity) + min_velocity)
    v = int(v)
    if emotion_index in (0, 1):
        v += 2
    elif emotion_index == 2:
        v += 1
    elif emotion_index in (3, 4):
        v += 0
    else:
        v += -1
    return v


def density_bucket(note_density: float, emotion_index: int) -> int:
    """Per-second note density -> arpeggio density class 0-4 with emotion
    shift (reference: video2music.py:893-913)."""
    d = float(note_density)
    if emotion_index in (1, 2, 3):
        d += -3
    elif emotion_index in (0, 4):
        d += 3
    if d <= 6:
        return 0
    if d <= 12:
        return 1
    if d <= 18:
        return 2
    if d <= 24:
        return 3
    return 4
