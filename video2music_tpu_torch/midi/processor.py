"""MusicTransformer MIDI event codec (388-token vocabulary).

Re-implementation of the vendored midi_processor (reference:
``third_party/midi_processor/processor.py``) on the in-tree MIDI
reader/writer instead of pretty_midi. Vocabulary: 128 note-on + 128
note-off + 100 time-shift (10 ms units) + 32 velocity bins = 388 events
(+PAD/END handled by the caller via core.constants.TOKEN_*).

Behavior parity notes (quirks reproduced):
  * the previous-velocity comparison uses the RAW velocity against the
    binned one (processor.py:126-128,231), so a velocity event precedes
    nearly every note-on;
  * sustain-pedal (CC64) handling extends managed note ends to the next
    same-pitch onset or the pedal-up time (processor.py:30-36,179-201);
  * zero-length merged notes are dropped; orphan note-offs are ignored
    (processor.py:110-119).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .reader import MidiData, Note, read_midi
from .writer import MIDIFile

RANGE_NOTE_ON = 128
RANGE_NOTE_OFF = 128
RANGE_VEL = 32
RANGE_TIME_SHIFT = 100

START_IDX = {
    "note_on": 0,
    "note_off": RANGE_NOTE_ON,
    "time_shift": RANGE_NOTE_ON + RANGE_NOTE_OFF,
    "velocity": RANGE_NOTE_ON + RANGE_NOTE_OFF + RANGE_TIME_SHIFT,
}


@dataclasses.dataclass
class _SplitNote:
    type: str
    time: float
    value: int
    velocity: Optional[int]


def _divide_note(notes: List[Note]) -> List[_SplitNote]:
    out = []
    for n in sorted(notes, key=lambda x: x.start):
        out.append(_SplitNote("note_on", n.start, n.pitch, n.velocity))
        out.append(_SplitNote("note_off", n.end, n.pitch, None))
    return out


def _sustain_spans(ccs) -> List[list]:
    """CC64 stream -> [start, end, managed notes] spans
    (reference: processor.py:160-176)."""
    spans = []
    current = None
    for c in ccs:
        if c.value >= 64 and current is None:
            current = [c.time, None, []]
        elif c.value < 64 and current is not None:
            current[1] = c.time
            spans.append(current)
            current = None
        elif c.value < 64 and spans:
            spans[-1][1] = c.time
    return spans


def _apply_sustain(spans, notes: List[Note]) -> List[Note]:
    if not spans:
        return sorted(notes, key=lambda n: n.start)
    stream: List[Note] = []
    notes = list(notes)
    for span in spans:
        start, end, managed = span
        for idx, note in enumerate(notes):
            if note.start < start:
                stream.append(note)
            elif note.start > end:
                notes = notes[idx:]
                # transposition_notes: extend each managed note to the next
                # same-pitch onset (scanning in reverse) or the pedal-up
                note_dict = {}
                for m in reversed(managed):
                    m.end = note_dict.get(m.pitch, max(end, m.end))
                    note_dict[m.pitch] = m.start
                break
            else:
                managed.append(note)
    for span in spans:
        stream += span[2]
    return sorted(stream, key=lambda n: n.start)


def _time_shift_events(prev: float, post: float) -> List[int]:
    interval = int(round((post - prev) * 100))
    out = []
    while interval >= RANGE_TIME_SHIFT:
        out.append(START_IDX["time_shift"] + RANGE_TIME_SHIFT - 1)
        interval -= RANGE_TIME_SHIFT
    if interval:
        out.append(START_IDX["time_shift"] + interval - 1)
    return out


def encode_midi(source) -> List[int]:
    """MIDI file (path/bytes/MidiData) -> event-id list
    (reference: processor.py:206-231)."""
    md = source if isinstance(source, MidiData) else read_midi(source)
    sustains = _sustain_spans(
        [c for c in md.control_changes if c.number == 64])
    notes = _apply_sustain(sustains,
                           [Note(n.start, n.end, n.pitch, n.velocity)
                            for n in md.notes])
    dnotes = sorted(_divide_note(notes), key=lambda s: s.time)
    events: List[int] = []
    cur_time = 0.0
    cur_vel: Optional[int] = 0
    for s in dnotes:
        events += _time_shift_events(cur_time, s.time)
        if s.velocity is not None:
            binned = s.velocity // 4
            if cur_vel != binned:  # raw-vs-binned quirk preserved
                events.append(START_IDX["velocity"] + binned)
        events.append(START_IDX[s.type] + s.value)
        cur_time = s.time
        cur_vel = s.velocity
    return events


def decode_midi(idx_array, file_path: Optional[str] = None) -> MidiData:
    """Event ids -> MidiData (optionally written as a .mid file)
    (reference: processor.py:233-251)."""
    timeline = 0.0
    velocity = 0
    snotes: List[_SplitNote] = []
    for idx in idx_array:
        idx = int(idx)
        if idx < START_IDX["note_off"]:
            snotes.append(_SplitNote("note_on", timeline, idx, velocity))
        elif idx < START_IDX["time_shift"]:
            snotes.append(_SplitNote("note_off", timeline,
                                     idx - START_IDX["note_off"], velocity))
        elif idx < START_IDX["velocity"]:
            timeline += (idx - START_IDX["time_shift"] + 1) / 100.0
        else:
            velocity = (idx - START_IDX["velocity"]) * 4

    on_dict = {}
    notes: List[Note] = []
    for s in snotes:
        if s.type == "note_on":
            on_dict[s.value] = s
        else:
            on = on_dict.get(s.value)
            if on is None or s.time - on.time == 0:
                continue
            notes.append(Note(on.time, s.time, s.value, on.velocity))
    notes.sort(key=lambda n: n.start)
    md = MidiData(notes=notes, control_changes=[], ticks_per_quarter=960)
    if file_path is not None:
        mf = MIDIFile(1)
        mf.addTempo(0, 0, 120)  # 0.5 s/beat: time(sec) -> beats = t*2
        for n in notes:
            mf.addNote(0, 0, n.pitch, n.start * 2.0,
                       max(n.end - n.start, 1e-3) * 2.0, n.velocity)
        with open(file_path, "wb") as f:
            mf.writeFile(f)
    return md
