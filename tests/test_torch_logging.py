"""The port's ``MetricWriter`` (subspace_reg_tpu_torch/utils/logging.py)
against the JAX package's (subspace_reg_tpu/utils/logging.py, whose event
files come from ``torch.utils.tensorboard.SummaryWriter``) on the CPU:

* both writers log the reference's scalars (train_acc / train_loss /
  test_acc / test_acc_top5 / test_loss) over several steps, step 0 and
  zeros included; both event files, read by a TFRecord reader here that
  checks each record's masked CRC-32C and decoded by TensorBoard's
  ``event_pb2``, hold the same file version, tags, steps and f32 values in
  order, and ``metrics.jsonl`` the same records.  The JAX writer runs in
  a subprocess: ``torch.utils.tensorboard`` imports TensorFlow where it
  is installed (tens of seconds), which no other test should inherit;
* the port's records are byte for byte what ``SummaryWriter.add_scalar``
  writes; a bad CRC is caught; the file name and flush behaviour.
"""

import glob
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from subspace_reg_tpu_torch.utils import crc32c
from subspace_reg_tpu_torch.utils.logging import MetricWriter, scalar_event
from tensorboard.compat.proto import event_pb2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("train_acc", "train_loss", "test_acc", "test_acc_top5", "test_loss")


def _scalars():
    r = np.random.RandomState(0)
    out = [(name, float(100 * r.rand()), step)
           for step in range(4) for name in NAMES]
    return out + [("train_loss", 0.0, 4), ("test_acc", -1.5, 5)]


def read_tfrecords(path):
    """Each record's data, its length's and its data's masked CRC-32C
    checked."""
    with open(path, "rb") as f:
        buf = f.read()
    out, i = [], 0
    while i < len(buf):
        head = buf[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (crc_len,) = struct.unpack("<I", buf[i + 8:i + 12])
        data = buf[i + 12:i + 12 + n]
        (crc_data,) = struct.unpack("<I", buf[i + 12 + n:i + 16 + n])
        assert crc_len == crc32c.masked(head), "length CRC"
        assert crc_data == crc32c.masked(data), "data CRC"
        out.append(data)
        i += 16 + n
    return out


def _events(logdir):
    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    events = []
    for data in read_tfrecords(path):
        e = event_pb2.Event()
        e.ParseFromString(data)
        events.append(e)
    return path, events


def _summary(events):
    return [(v.tag, e.step, np.float32(v.simple_value))
            for e in events[1:] for v in e.summary.value]


def _jsonl(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [(r["name"], r["value"], r["step"])
                for r in map(json.loads, f)]


def test_event_files_equal_the_jax_writers(tmp_path):
    scalars = _scalars()
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    code = ("import json, sys\n"
            "from subspace_reg_tpu.utils.logging import MetricWriter\n"
            "w = MetricWriter(sys.argv[1])\n"
            "for name, value, step in json.loads(sys.argv[2]):\n"
            "    w.log_value(name, value, step)\n"
            "w.close()\n")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, jax_dir,
                          json.dumps(scalars)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    w = MetricWriter(port_dir)
    for name, value, step in scalars:
        w.log_value(name, value, step)
    w.close()
    _, jev = _events(jax_dir)
    ppath, pev = _events(port_dir)
    assert jev[0].file_version == pev[0].file_version == "brain.Event:2"
    assert pev[0].wall_time > 0
    assert len(jev) == len(pev) == len(scalars) + 1
    assert _summary(pev) == _summary(jev)
    assert _summary(pev) == [(n, s, np.float32(v)) for n, v, s in scalars]
    assert all(e.wall_time >= pev[0].wall_time for e in pev[1:])
    assert _jsonl(port_dir) == _jsonl(jax_dir) == scalars


def test_records_are_summary_writers_bytes():
    # SummaryWriter.add_scalar("train_acc", 0.5, 1) at wall time 1.0e9,
    # as TensorBoard's event_pb2 serializes it
    e = event_pb2.Event(wall_time=1.0e9, step=1)
    e.summary.value.add(tag="train_acc", simple_value=0.5)
    assert scalar_event(1.0e9, 1, "train_acc", 0.5) == \
        e.SerializeToString()
    e = event_pb2.Event(wall_time=2.5, step=-3)
    e.summary.value.add(tag="x", simple_value=0.0)
    assert scalar_event(2.5, -3, "x", 0.0) == e.SerializeToString()
    e = event_pb2.Event(wall_time=2.5)
    e.summary.value.add(tag="inf", simple_value=float("inf"))
    assert scalar_event(2.5, 0, "inf", 1e300) == e.SerializeToString()


def test_writer_files_flushes_and_bad_crcs(tmp_path):
    w1 = MetricWriter(str(tmp_path))
    w1.log_value("test_acc", 0.25, 7)
    # flushed on each value, before close
    path, events = _events(str(tmp_path))
    assert path == w1.event_path and len(events) == 2
    name = os.path.basename(path).split(".")
    assert name[:3] == ["events", "out", "tfevents"]
    assert len(name[3]) == 10 and name[-2] == str(os.getpid())
    w2 = MetricWriter(str(tmp_path / "b"))
    assert int(w2.event_path.split(".")[-1]) == int(name[-1]) + 1
    w1.close()
    w2.close()
    with open(path, "r+b") as f:
        f.seek(-6, os.SEEK_END)
        byte = f.read(1)
        f.seek(-6, os.SEEK_END)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(AssertionError, match="data CRC"):
        read_tfrecords(path)
