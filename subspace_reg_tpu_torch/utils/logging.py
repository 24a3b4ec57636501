"""Meters and a metric writer (the port's copy of the JAX package's
``utils/logging.py``).

The reference logs pretraining scalars with ``tensorboard_logger``
(train_supervised.py:148,172-178).  This writer emits JSONL
(``metrics.jsonl``) under the reference's scalar names (train_acc /
train_loss / test_acc / test_acc_top5 / test_loss).  The JAX package's
optional TensorBoard event files are not written: importing
``torch.utils.tensorboard`` pulls in TensorFlow where it is installed,
which costs tens of seconds per run.
"""

from __future__ import annotations

import json
import os
import time


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


class MetricWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log_value(self, name: str, value, step: int) -> None:
        rec = {"name": name, "value": float(value), "step": int(step),
               "ts": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
