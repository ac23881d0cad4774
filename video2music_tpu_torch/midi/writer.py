"""Minimal standard-MIDI-file writer (first-party midiutil replacement).

The reference renders chords through ``midiutil.MIDIFile`` (reference:
``video2music.py:935-992``, ``generate.py:449-688``). This is a from-scratch
format-1 SMF writer with the same call surface the pipeline uses:
``addTempo``, ``addNote``, ``addProgramChange``, ``addControllerEvent``,
``writeFile``. Times and durations are in beats (quarter notes), 960 ticks
per quarter as in midiutil's default.
"""

from __future__ import annotations

import operator
import struct
from typing import BinaryIO, List, Tuple

TPQN = 960

# single-byte VLQs (deltas < 128 — the overwhelming majority at 960 TPQN
# chord spacing): table lookup instead of the loop, measured hot in the
# serving render path (one _varlen per event)
_VL1 = [bytes([v]) for v in range(128)]


def _varlen(value: int) -> bytes:
    """MIDI variable-length quantity."""
    value = int(value)
    if 0 <= value < 128:
        return _VL1[value]
    value = max(0, value)
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def _clamp7(v) -> int:
    return max(0, min(127, int(v)))


class MIDIFile:
    """Format-1 SMF with ``num_tracks`` tracks, beat-based event times."""

    def __init__(self, num_tracks: int = 1,
                 ticks_per_quarternote: int = TPQN):
        self.num_tracks = num_tracks
        self.tpqn = ticks_per_quarternote
        # per-track event list: (tick, order, payload bytes)
        self._events: List[List[Tuple[int, int, bytes]]] = [
            [] for _ in range(num_tracks)]

    def _tick(self, beats: float) -> int:
        return int(round(beats * self.tpqn))

    def addTempo(self, track: int, time: float, tempo_bpm: float) -> None:
        usec = int(round(60_000_000 / max(float(tempo_bpm), 1e-6)))
        payload = bytes([0xFF, 0x51, 0x03]) + usec.to_bytes(3, "big")
        self._events[track].append((self._tick(time), 0, payload))

    def addProgramChange(self, track: int, channel: int, time: float,
                         program: int) -> None:
        payload = bytes([0xC0 | (channel & 0x0F), _clamp7(program)])
        self._events[track].append((self._tick(time), 1, payload))

    def addControllerEvent(self, track: int, channel: int, time: float,
                           controller_number: int, parameter: int) -> None:
        payload = bytes([0xB0 | (channel & 0x0F), _clamp7(controller_number),
                         _clamp7(parameter)])
        self._events[track].append((self._tick(time), 1, payload))

    def addNote(self, track: int, channel: int, pitch: int, time: float,
                duration: float, volume: int) -> None:
        # inlined clamps/ticks: this is the render hot path (thousands of
        # notes per clip through the arpeggiator in serving)
        pitch = 0 if pitch < 0 else (127 if pitch > 127 else int(pitch))
        vol = int(volume)
        vel = 0 if vol < 0 else (127 if vol > 127 else vol)
        ch = channel & 0x0F
        tpqn = self.tpqn
        t0 = int(round(time * tpqn))
        t1 = int(round((time + duration) * tpqn))
        if t1 <= t0:
            t1 = t0 + 1
        # order: note-offs (2) before note-ons (3) at the same tick so
        # repeated pitches re-trigger instead of cancelling
        ev = self._events[track]
        ev.append((t0, 3, bytes((0x90 | ch, pitch, vel))))
        ev.append((t1, 2, bytes((0x80 | ch, pitch, 0))))

    def _track_bytes(self, track: int) -> bytes:
        # itemgetter key: C-level and stable, so same-tick/order ties keep
        # insertion order — byte-identical to the lambda it replaces
        events = sorted(self._events[track],
                        key=operator.itemgetter(0, 1))
        data = bytearray()
        last_tick = 0
        for tick, _, payload in events:
            data += _varlen(tick - last_tick)
            data += payload
            last_tick = tick
        data += _varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track
        return bytes(data)

    def writeFile(self, fileobj: BinaryIO) -> None:
        fmt = 0 if self.num_tracks == 1 else 1
        fileobj.write(b"MThd" + struct.pack(">IHHH", 6, fmt,
                                            self.num_tracks, self.tpqn))
        for t in range(self.num_tracks):
            tb = self._track_bytes(t)
            fileobj.write(b"MTrk" + struct.pack(">I", len(tb)) + tb)
