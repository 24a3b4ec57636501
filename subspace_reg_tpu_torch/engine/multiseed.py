"""Multi-seed FSCIL evaluation: S seeds through one engine call, with one
seed-batched K1 launch per session.  Counterpart of the JAX package's
``engine/multiseed.py::few_shot_finetune_multiseed``, which replaces the
reference's Slurm seed arrays (scripts/continual/slurm_*.sh:8,19-27: 10
single-GPU jobs) by a vmap over seeds.

Each seed keeps its own backbone, head, sampler, ``np.random`` stream,
replay memory, query collection and attractors (engine/incremental.py::
SeedRun, the single-seed engine's host side).  Each session then does, in
order:

  a. per seed, in turn: the episode and its replay-index draw, head growth,
     the epoch-1 train-mode forwards, the first step and the eval-mode
     feature caches on that seed's backbone;
  b. ONE seed-batched K1 launch for all S seeds (ops/finetune.py::
     finetune_loop_seeds: the card's blocks split into S groups);
  c. per seed: evaluation and the replay-memory update.

Every seed's epochs and accuracies equal a single-seed run's: step (a)
and (c) are the single-seed engine's own code, and per seed the batched K1
launch is bit-identical to a single-seed launch on the same group of
blocks.  The weighted average weighs the novel accuracy by the classes
added so far, ``n_ways * (idx + 1)``, as the JAX multi-seed engine does
(multiseed.py:477-480); the single-seed engines keep the reference's
classes seen less 60, which differs on tieredImageNet.

``--save_preds_0`` writes one prediction dump per seed, under the seed's
reference name (JAX multiseed.py:266-275, 461-505).  The tracked modes and
``freeze_backbone_at != 1`` are refused, as the JAX multi-seed engine
serves the compiled session only.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.finetune import finetune_loop_seeds
from ..parallel.mesh import lane_devices
from ..utils.device import resolve_device
from ..utils.spans import span
from .draws import TorchDraws, per_seed
from .incremental import IncrementalResult, SeedRun, check_options

# fields of the eval config that may differ between the seeds of one run
SEED_FIELDS = ("set_seed", "model_path")


@dataclass
class MultiSeedResult:
    per_seed: List[IncrementalResult]
    seeds: List[int]

    @property
    def novel_mean(self) -> float:
        return float(np.mean([r.acc_novel_avg for r in self.per_seed]))

    @property
    def base_mean(self) -> float:
        return float(np.mean([r.acc_base_avg for r in self.per_seed]))


def _refuse(opts, heads) -> None:
    opt0 = opts[0]
    names = [k for k in dir(opt0) if not k.startswith("_")
             and k not in SEED_FIELDS and not callable(getattr(opt0, k))]
    for opt in opts[1:]:
        diff = [k for k in names
                if getattr(opt, k, None) != getattr(opt0, k)]
        if diff:
            raise ValueError("the seeds' options differ beyond set_seed: "
                             f"{diff}")
    with_bias = heads[0].bias is not None
    if any((h.bias is not None) != with_bias
           or h.n_active != heads[0].n_active
           or tuple(h.weight.shape) != tuple(heads[0].weight.shape)
           for h in heads):
        raise ValueError("the seeds' heads differ in geometry")
    check_options(opt0, with_bias)
    # the JAX multi-seed engine serves the compiled session program only
    unserved = [f"--{f}" for f in ("track_weights",
                                   "track_label_inspired_weights")
                if getattr(opt0, f, False)]
    if opt0.freeze_backbone_at != 1:
        unserved.append("freeze_backbone_at != 1")
    if unserved:
        raise NotImplementedError(
            ", ".join(unserved) + ": the multi-seed engine runs the "
            "compiled session only, as the JAX package's does; the "
            "single-seed engine serves them")


def few_shot_finetune_multiseed(
        per_seed_backbones: Sequence[torch.nn.Module], per_seed_heads,
        per_seed_meta: Sequence[dict], opts: Sequence,
        per_seed_samplers: Sequence, per_seed_base_test,
        per_seed_base_support: Optional[Sequence] = None,
        verbose: bool = False, shard_over_devices: bool = False,
        device="cuda", draws: Optional[Sequence] = None) -> MultiSeedResult:
    """Run the multi-session protocol for S seeds at once on ``device``.

    ``opts`` differ only in ``set_seed`` (and the checkpoint path); every
    list argument has length S.  ``draws``: one draw provider per seed
    (default ``TorchDraws`` of each seed, on the seed's device).  The
    backbones and heads are copied, never mutated.

    ``shard_over_devices=True`` lays the seeds out over the visible CUDA
    devices as the JAX engine does (``parallel.mesh.lane_devices``:
    contiguous blocks over the largest divisor of S that fits; the CPU is
    one device): each device holds its seeds' backbones, heads and staged
    data, and each session launches one seed-batched K1 a device, the
    devices in turn.  On one device it is the unsharded run."""
    n = len(opts)
    _refuse(opts, per_seed_heads)
    dev = resolve_device(device)
    prt = print if verbose else (lambda *a, **k: None)
    quiet = lambda *a, **k: None    # noqa: E731 (the seeds print nothing)
    devs, slot = lane_devices(n, shard_over_devices, dev)
    if len(devs) > 1:
        prt(f"sharding {n} seeds over {len(devs)} devices")
    seed_dev = [devs[slot[i]] for i in range(n)]
    providers = (per_seed([o.set_seed for o in opts], dev, draws)
                 if draws is not None else
                 [TorchDraws(o.set_seed, d) for o, d in zip(opts, seed_dev)])
    supports = per_seed_base_support or [None] * n
    runs = [SeedRun(per_seed_backbones[i], per_seed_heads[i],
                    per_seed_meta[i], opts[i], per_seed_samplers[i],
                    per_seed_base_test[i], supports[i], None, seed_dev[i],
                    providers[i], quiet)
            for i in range(n)]
    groups = [[i for i in range(n) if slot[i] == d]
              for d in range(len(devs))]
    if any(r.geo != runs[0].geo for r in runs):
        raise ValueError("the seeds' session geometries differ")

    for idx in range(runs[0].geo.max_sessions):
        with span("srt.eval.session"):
            t0 = time.time()
            inputs, prepared = [], []
            for run in runs:
                s = run.begin(idx)
                inputs.append(s)
                prepared.append(run.program.prepare(s))
            with span("srt.eval.k1"):
                loops = [run.program.loop_operands(s, p)
                         for run, s, p in zip(runs, inputs, prepared)]
                cfg = loops[0][1]
                if any(c != cfg for _, c in loops):
                    raise ValueError("the seeds' K1 configurations differ")
                outs = [None] * n
                for group in groups:
                    # one seed-batched K1 launch for the device's seeds
                    stacked = {k: None if t is None else torch.stack(
                        [loops[i][0][k] for i in group])
                        for k, t in loops[0][0].items()}
                    w, stats, trace = finetune_loop_seeds(**stacked, cfg=cfg)
                    for j, i in enumerate(group):
                        outs[i] = (w[j], stats[j], trace[j])
            done = [run.program.complete(s, p, outs[i])
                    for i, (run, s, p) in enumerate(zip(runs, inputs,
                                                        prepared))]
            for run, (params, metrics) in zip(runs, done):
                # the novel weight of the weighted average: the classes
                # added so far (JAX multiseed.py:477-480)
                run.finish(idx, params, metrics, t0,
                           run.geo.n_ways * (idx + 1))
        dt = time.time() - t0
        prt(f"session {idx}: novel {[r.acc_novel_list[-1] for r in runs]} "
            f"base {[r.acc_base_list[-1] for r in runs]} epochs "
            f"{[r.epochs_l[-1] for r in runs]} [{dt:.2f}s]", flush=True)

    return MultiSeedResult(per_seed=[run.result() for run in runs],
                           seeds=[o.set_seed for o in opts])
