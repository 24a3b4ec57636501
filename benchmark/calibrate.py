"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

  python3 benchmark/calibrate.py --workload <cell> --seeds 101 102 ... \
      [--control] [--fault <name>] --seconds <s> --out <file.jsonl>

runs the cell once per seed in one process and writes one JSON line per
seed: every number compared (the program against the reference), with
``--control`` also each number of the control (the reference in the next
precision below the configuration's, put in the program's place), and
with ``--fault`` the same run with a fault planted in the program.  The
lower reading of a limit is the largest a dozen sound seeds give; the
upper, the smallest the control or a fault gives.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from benchmark import harness  # noqa: E402


@contextlib.contextmanager
def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def pretrain_unchanged():
    """The step computes everything and leaves the state as it was."""
    import torch
    with _patch(torch.optim.SGD, "step", lambda self, closure=None: None):
        yield


@contextlib.contextmanager
def pretrain_half_batch():
    """The step takes the first half of its batch, the mean over it."""
    from subspace_reg_tpu_torch.engine import pretrain as pt
    orig = pt.make_train_step

    def make(*a, **k):
        step = orig(*a, **k)

        def half(state, x, y):
            h = x.shape[0] // 2
            return step(state, x[:h], y[:h])
        return half
    with _patch(pt, "make_train_step", make):
        yield


@contextlib.contextmanager
def eval_unchanged():
    """K1 runs and hands back the head it was given."""
    from subspace_reg_tpu_torch.engine import incremental as inc
    orig = inc.finetune_loop

    def loop(*a, **k):
        out = orig(*a, **k)
        return (k["w"].clone(),) + tuple(out[1:])
    with _patch(inc, "finetune_loop", loop):
        yield


@contextlib.contextmanager
def eval_answer():
    """One base-batch answer of every session is altered where it is
    produced."""
    from subspace_reg_tpu_torch.engine import incremental as inc
    orig = inc.SessionProgram.evaluate

    def evaluate(self, params, f_query, query_y, f_base, base_y, n_active):
        chunks, base_acc, q_preds, b_preds = orig(
            self, params, f_query, query_y, f_base, base_y, n_active)
        b_preds = b_preds.clone()
        b_preds[0] = (b_preds[0] + 1) % n_active
        return chunks, base_acc, q_preds, b_preds
    with _patch(inc.SessionProgram, "evaluate", evaluate):
        yield


@contextlib.contextmanager
def eval_accuracy():
    """The base accuracy of every session is reported one answer off."""
    from subspace_reg_tpu_torch.engine import incremental as inc
    orig = inc.SessionProgram.evaluate

    def evaluate(self, params, f_query, query_y, f_base, base_y, n_active):
        chunks, base_acc, q_preds, b_preds = orig(
            self, params, f_query, query_y, f_base, base_y, n_active)
        one = 100.0 / base_y.shape[0]
        base_acc = base_acc + (one if float(base_acc) < 50.0 else -one)
        return chunks, base_acc, q_preds, b_preds
    with _patch(inc.SessionProgram, "evaluate", evaluate):
        yield


@contextlib.contextmanager
def pretrain_repeated_rows():
    """The shuffle hands each batch its first half twice."""
    import numpy as np
    from subspace_reg_tpu_torch.engine import pretrain as pt
    orig = pt.epoch_batches

    def batches(*a, **k):
        for idx in orig(*a, **k):
            h = len(idx) // 2
            yield np.concatenate([idx[:h], idx[:len(idx) - h]])
    with _patch(pt, "epoch_batches", batches):
        yield


FAULTS = {"pretrain_unchanged": pretrain_unchanged,
          "pretrain_half_batch": pretrain_half_batch,
          "pretrain_repeated_rows": pretrain_repeated_rows,
          "eval_unchanged": eval_unchanged, "eval_answer": eval_answer,
          "eval_accuracy": eval_accuracy}


def reading(cell: str, seed: int, seconds: float, control: bool = False,
            fault: str = "", device: str = "cuda", overrides=None) -> dict:
    ov = dict(overrides or {})
    ov["control"] = control
    ctx = FAULTS[fault]() if fault else contextlib.nullcontext()
    t0 = time.time()
    with ctx:
        out = harness.run_cell(cell, seed, seconds, False, device=device,
                               overrides=ov, t_started=t0)
    return {"cell": cell, "seed": seed, "fault": fault or None,
            "correct": out["correct"],
            "checks": {k: v["value"] for k, v in out["checks"].items()},
            "control": out.get("control"),
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="", choices=[""] + sorted(FAULTS))
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "a") as f:
        for seed in a.seeds:
            r = reading(a.workload, seed, a.seconds, a.control, a.fault)
            line = json.dumps(r)
            f.write(line + "\n")
            f.flush()
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
