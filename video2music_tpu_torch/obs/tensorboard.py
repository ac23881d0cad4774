"""First-party TensorBoard scalar event writer (no tensorboard dep).

Rebuilds the reference's live-scalar stream (``train.py:90-96,349-357``
creates a ``torch.utils.tensorboard.SummaryWriter`` and logs per-epoch
eval losses + learning rate) for an environment without the tensorboard
package: this module hand-encodes the two protobuf messages TensorBoard's
scalar dashboard actually reads (``Event`` wrapping ``Summary.Value
{tag, simple_value}``) and frames them in the TFRecord format
(little-endian length + masked-CRC32C of the length + payload +
masked-CRC32C of the payload). Files are named
``events.out.tfevents.<unix_time>.<hostname>`` so ``tensorboard
--logdir`` discovers them exactly like the reference's run directories.

Wire format references (stable public specs):
  * protobuf wire encoding: varint keys ``(field<<3)|type``; type 0 =
    varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
  * Event proto fields: 1=wall_time(double), 2=step(int64),
    3=file_version(string), 5=summary(message).
  * Summary proto: repeated Value=1; Value: tag=1(string),
    simple_value=2(float).
  * TFRecord masked crc: ``((crc>>15 | crc<<17) + 0xa282ead8) mod 2^32``
    over CRC32C (Castagnoli, reflected poly 0x82F63B78).

The round-trip is verified in ``tests/test_obs.py`` by an independent
decoder.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------
# CRC32C (Castagnoli), table-based, reflected polynomial 0x82F63B78


def _make_crc32c_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------
# Minimal protobuf wire encoding


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: Optional[float] = None) -> bytes:
    """Event{wall_time, step, summary=Summary{value=[{tag, simple_value}]}}"""
    val = _bytes(1, tag.encode()) + _float(2, float(value))
    summary = _bytes(1, val)
    return (_double(1, time.time() if wall_time is None else wall_time)
            + _int64(2, int(step)) + _bytes(5, summary))


def encode_file_version_event(wall_time: Optional[float] = None) -> bytes:
    return (_double(1, time.time() if wall_time is None else wall_time)
            + _bytes(3, b"brain.Event:2"))


def tfrecord_frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


# ---------------------------------------------------------------------


class SummaryWriter:
    """Drop-in for the slice of ``torch.utils.tensorboard.SummaryWriter``
    the reference uses: ``add_scalar(tag, value, global_step)``, ``flush``,
    ``close`` (train.py:96,349-357,376-377)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._f.write(tfrecord_frame(encode_file_version_event()))

    def add_scalar(self, tag: str, value, global_step: int) -> None:
        self._f.write(tfrecord_frame(
            encode_scalar_event(tag, float(value), global_step)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
