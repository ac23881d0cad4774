"""Audio-side dataset-prep features: per-second loudness and note density.

First-party replacements for the pydub/audioop and pretty_midi paths
(reference: ``script/loudness_feature.py``, ``script/note_density_feature.py``)
using the stdlib ``wave`` module + numpy and the in-tree MIDI reader.
"""

from __future__ import annotations

import wave
from typing import List

import numpy as np

from ..midi.reader import read_midi


def load_wav_mono(path, target_rate: int = 44100) -> np.ndarray:
    """wav file -> int16 mono samples at target_rate (nearest resample)."""
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32)
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) * 256.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 65536.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if rate != target_rate:
        idx = np.round(np.arange(0, len(x), rate / target_rate)).astype(int)
        x = x[np.clip(idx, 0, len(x) - 1)]
    return x.astype(np.int16)


def loudness_per_second(samples: np.ndarray, rate: int = 44100) -> List[str]:
    """int16 mono samples -> per-second normalized loudness strings.

    RMS per 1 s chunk -> dBFS (20*log10(rms/32767)) -> 10^(dB/20), formatted
    to 4 decimals (reference: script/loudness_feature.py:32-47)."""
    out = []
    n_chunks = int(np.ceil(len(samples) / rate))
    for i in range(n_chunks):
        chunk = samples[i * rate:(i + 1) * rate].astype(np.float64)
        rms = np.sqrt(np.mean(chunk ** 2)) if chunk.size else 0.0
        rms = max(rms, 1e-12)
        loudness = 20.0 * np.log10(rms / 32767.0)
        out.append(format(10 ** (loudness / 20.0), ".4f"))
    return out


def note_density_per_second(midi_path) -> List[float]:
    """Notes overlapping each 1-second window, per second
    (reference: script/note_density_feature.py:28-41)."""
    md = read_midi(midi_path)
    total = md.get_end_time()
    out = []
    for i in range(int(total) + 1):
        start, end = i, i + 1
        count = sum(1 for n in md.notes if n.start < end and n.end > start)
        out.append(count / float(end - start))
    return out


def write_lab(path, values) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for i, v in enumerate(values):
            f.write(f"{i} {v}\n")
