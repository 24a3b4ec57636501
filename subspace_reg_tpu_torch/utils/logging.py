"""Meters and a metric writer (the port's copy of the JAX package's
``utils/logging.py``).

The reference logs pretraining scalars with ``tensorboard_logger``
(train_supervised.py:148,172-178).  ``MetricWriter`` writes them under the
reference's names (train_acc / train_loss / test_acc / test_acc_top5 /
test_loss) twice: as JSONL (``metrics.jsonl``) and as a TensorBoard event
file (``events.out.tfevents.<time>.<host>.<pid>.<n>``), the records that
``torch.utils.tensorboard.SummaryWriter.add_scalar`` writes.  The event
file is encoded here (TFRecord framing, the protobuf wire format of
``Event`` and ``Summary``), so the writer imports neither TensorBoard nor
protobuf: importing ``torch.utils.tensorboard`` pulls in TensorFlow where
it is installed, which costs tens of seconds per run.

A TFRecord is ``u64 length, u32 masked CRC-32C of the length, data, u32
masked CRC-32C of the data``, all little-endian.  The first record is
``Event{wall_time, file_version: "brain.Event:2"}``, each scalar an
``Event{wall_time, step, summary{value{tag, simple_value}}}``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import socket
import struct
import time

from .crc32c import masked

FILE_VERSION = "brain.Event:2"
_F32_MAX = 3.4028234663852886e38
_writer_ids = itertools.count()


class AverageMeter:
    """Reference eval/util.py:9-24."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


# ------------------------------------------------- protobuf wire format

def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # negative int64: ten bytes of two's complement
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(data)) + data


def scalar_event(wall_time: float, step: int, tag: str,
                 value: float) -> bytes:
    """``Event{wall_time=1, step=2, summary=5{value=1{tag=1,
    simple_value=2}}}``; proto3 leaves a zero step out."""
    if math.isfinite(value) and abs(value) > _F32_MAX:  # beyond f32
        value = math.copysign(math.inf, value)
    val = _bytes_field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)
    step_field = b"\x10" + _varint(step) if step else b""
    return (b"\x09" + struct.pack("<d", wall_time) + step_field
            + _bytes_field(5, _bytes_field(1, val)))


def version_event(wall_time: float) -> bytes:
    """``Event{wall_time=1, file_version=3}``."""
    return (b"\x09" + struct.pack("<d", wall_time)
            + _bytes_field(3, FILE_VERSION.encode()))


def tfrecord(data: bytes) -> bytes:
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked(head)) + data
            + struct.pack("<I", masked(data)))


class MetricWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")
        now = time.time()
        self.event_path = os.path.join(
            logdir, f"events.out.tfevents.{int(now):010d}."
            f"{socket.gethostname()}.{os.getpid()}.{next(_writer_ids)}")
        self._events = open(self.event_path, "wb")
        self._events.write(tfrecord(version_event(now)))
        self._events.flush()

    def log_value(self, name: str, value, step: int) -> None:
        now = time.time()
        rec = {"name": name, "value": float(value), "step": int(step),
               "ts": now}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        self._events.write(tfrecord(scalar_event(now, int(step), name,
                                                 float(value))))
        self._events.flush()

    def close(self) -> None:
        self._f.close()
        self._events.close()
