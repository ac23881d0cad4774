"""Minimal standard-MIDI-file reader (first-party pretty_midi replacement
for the features the pipeline needs: timed notes + control changes).

Used by the note-density feature (reference: ``script/note_density_feature.py``
via pretty_midi) and the MusicTransformer event codec (reference:
``third_party/midi_processor/processor.py:137-231``). Handles format 0/1,
running status, tempo maps (ticks -> seconds via piecewise tempo), note
on/off pairing, and sustain (CC64) events.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Note:
    start: float
    end: float
    pitch: int
    velocity: int
    channel: int = 0


@dataclasses.dataclass
class ControlChange:
    time: float
    number: int
    value: int
    channel: int = 0


@dataclasses.dataclass
class MidiData:
    notes: List[Note]
    control_changes: List[ControlChange]
    ticks_per_quarter: int

    def get_end_time(self) -> float:
        return max((n.end for n in self.notes), default=0.0)


def _read_varlen(data: bytes, i: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[i]
        i += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, i


def read_midi(path_or_bytes) -> MidiData:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data[:4] != b"MThd":
        raise ValueError("not a standard MIDI file")
    _, fmt, n_tracks, division = struct.unpack(">IHHH", data[4:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    i = 14

    # First pass: collect (tick, event) per track plus tempo events
    raw_events = []  # (tick, kind, payload)
    tempos = [(0, 500000)]  # (tick, usec per quarter)
    for _ in range(n_tracks):
        if data[i:i + 4] != b"MTrk":
            raise ValueError("missing MTrk chunk")
        length = struct.unpack(">I", data[i + 4:i + 8])[0]
        j = i + 8
        end = j + length
        tick = 0
        status = 0
        while j < end:
            delta, j = _read_varlen(data, j)
            tick += delta
            b = data[j]
            if b & 0x80:
                status = b
                j += 1
            if status == 0xFF:  # meta
                meta_type = data[j]
                mlen, j2 = _read_varlen(data, j + 1)
                payload = data[j2:j2 + mlen]
                if meta_type == 0x51:
                    tempos.append((tick, int.from_bytes(payload, "big")))
                j = j2 + mlen
            elif status in (0xF0, 0xF7):  # sysex
                slen, j2 = _read_varlen(data, j)
                j = j2 + slen
            else:
                kind = status & 0xF0
                ch = status & 0x0F
                if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                    d1, d2 = data[j], data[j + 1]
                    j += 2
                    raw_events.append((tick, kind, ch, d1, d2))
                elif kind in (0xC0, 0xD0):
                    j += 1
        i = end

    # tick -> seconds via the tempo map
    tempos.sort()
    seg_start_tick = [t for t, _ in tempos]
    seg_usec = [u for _, u in tempos]
    seg_start_sec = [0.0]
    for k in range(1, len(tempos)):
        dt = seg_start_tick[k] - seg_start_tick[k - 1]
        seg_start_sec.append(seg_start_sec[-1]
                             + dt * seg_usec[k - 1] / 1e6 / division)

    def to_sec(tick: int) -> float:
        k = 0
        for idx in range(len(seg_start_tick)):
            if seg_start_tick[idx] <= tick:
                k = idx
            else:
                break
        return seg_start_sec[k] + (tick - seg_start_tick[k]) * \
            seg_usec[k] / 1e6 / division

    notes: List[Note] = []
    ccs: List[ControlChange] = []
    open_notes = {}  # (channel, pitch) -> (tick, velocity)
    for tick, kind, ch, d1, d2 in sorted(raw_events,
                                         key=lambda e: (e[0], e[1])):
        if kind == 0x90 and d2 > 0:
            open_notes.setdefault((ch, d1), []).append((tick, d2))
        elif kind == 0x80 or (kind == 0x90 and d2 == 0):
            stack = open_notes.get((ch, d1))
            if stack:
                t0, vel = stack.pop(0)
                notes.append(Note(to_sec(t0), to_sec(tick), d1, vel, ch))
        elif kind == 0xB0:
            ccs.append(ControlChange(to_sec(tick), d1, d2, ch))
    notes.sort(key=lambda n: (n.start, n.pitch))
    ccs.sort(key=lambda c: c.time)
    return MidiData(notes=notes, control_changes=ccs,
                    ticks_per_quarter=division)
