"""Minimal TensorBoard event-file writer, pure Python
(copy of agcn_tpu/utils/tb_writer.py; neither TensorBoard, TensorFlow
nor torch.utils.tensorboard is needed, so it runs where none is
installed).

Emits standard `events.out.tfevents.*` files readable by TensorBoard,
covering the reference's train/val SummaryWriters (reference
utils/processor.py:125-132, 212-219): TFRecord framing with masked
CRC32C checksums and hand-encoded Event/Summary protobufs
(tensorboard.compat.proto.event_pb2.Event wire format).
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

# -- CRC32C (Castagnoli), table-driven ----------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire encoding ---------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _encode_value(tag: str, value: float) -> bytes:
    # Summary.Value{ tag=1 (string), simple_value=2 (float) }
    return (_bytes_field(1, tag.encode("utf-8"))
            + _key(2, 5) + struct.pack("<f", float(value)))


def _encode_event(wall_time: float, step: int,
                  tag: Optional[str] = None,
                  value: Optional[float] = None,
                  file_version: Optional[str] = None) -> bytes:
    # Event{ wall_time=1 (double), step=2 (int64),
    #        file_version=3 (string), summary=5 (Summary) }
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _key(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode("utf-8"))
    if tag is not None:
        summary = _bytes_field(1, _encode_value(tag, value))
        out += _bytes_field(5, summary)
    return out


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class SummaryWriter:
    """Append-only scalar event writer, API-compatible subset of
    torch.utils.tensorboard.SummaryWriter."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._path = os.path.join(log_dir, fname)
        self._lock = threading.Lock()
        self._f = open(self._path, "ab")
        self._write(_encode_event(time.time(), 0,
                                  file_version="brain.Event:2"))

    def _write(self, event: bytes):
        with self._lock:
            self._f.write(_tfrecord(event))

    def add_scalar(self, tag: str, value: float, global_step: int = 0):
        self._write(_encode_event(time.time(), int(global_step),
                                  tag=tag, value=float(value)))

    def flush(self):
        with self._lock:
            self._f.flush()

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()
