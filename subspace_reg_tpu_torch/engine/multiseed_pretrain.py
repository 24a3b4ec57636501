"""Multi-seed backbone pretraining: the seeds of the paper's backbone
fan-out trained in lockstep in one process.

Counterpart of the JAX package's ``engine/multiseed_pretrain.py``, which
replaces the reference's Slurm array over ``train_supervised.py``
(scripts/continual/slurm_run_backbone.sh:8,30-40: ten single-GPU jobs, one
per ``--set_seed``).  The JAX engine vmaps one step program over the
seeds; here each seed is a lane with its own backbone, head and
``torch.optim`` optimizer, stepped through the port's single-seed
``make_train_step_device_data`` from one shared device store.  The lanes
run one after another within each step (``TorchBatchNorm`` updates its
running statistics in place and each lane's dropout has its own
generator, so the lanes are not vmapped).

Faithfulness contract: each lane reproduces the single-seed trainer
(``python -m subspace_reg_tpu_torch.train_supervised --set_seed s``):

  * per-seed continual splits (the np.random call sequence of the
    loaders; lanes select different rows with different label maps),
  * per-seed init streams (``torch.manual_seed(set_seed)`` before the
    backbone, the head from ``Generator().manual_seed(set_seed)``),
  * per-seed epoch shuffles from ``np.random.RandomState(set_seed)``, the
    skipped epochs' shuffles consumed on resume,
  * per-seed augmentation and dropout draws keyed by the step
    (``TorchDraws(set_seed)``),
  * per-lane BatchNorm statistics,

so on one device a lane's state is bit-identical to the single-seed
trainer's.

Data residency: every seed's split is a ``LazyRows`` view of the same
pickle-cached array (data/mini_imagenet.py), so the engine stages that
array on the device once for every seed (and, through the caller's
``staged`` record, every seed group) and keeps per-seed
row selections and labels as small device tables; a step sends each lane
only its index vector.

Scope (refused otherwise, as in the JAX engine): plain-CE pretraining,
the golden backbone fan-out; KD/NCE/CRD, label pull and ``--faithful_nbt``
stay on the single-seed CLI.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.mini_imagenet import LazyRows
from ..data.transforms import transforms_options
from ..parallel.mesh import lane_devices
from . import pretrain as pt
from .draws import TorchDraws

# engine-read fields that must agree across lanes (everything except the
# seed and the I/O paths): a mismatch fails loudly, never diverges
_SHARED_FIELDS = (
    "model", "dataset", "transform", "continual", "use_trainval",
    "batch_size", "epochs", "learning_rate", "lr_decay_rate",
    "lr_decay_epochs_list", "cosine", "adam", "weight_decay", "momentum",
    "linear_bias", "no_dropblock", "save_freq",
)

def stage_shared(full, device, staged: Optional[dict] = None
                 ) -> torch.Tensor:
    """``full`` uploaded to ``device``.  ``staged`` is the caller's record
    of one fan-out's uploads, keyed by host array identity and device
    (holding the host array): the pickle cache hands every seed group the
    same ndarray, so one upload serves every group."""
    device = torch.device(device)
    key = (id(full), str(device))
    if staged is not None and key in staged and staged[key][0] is full:
        return staged[key][1]
    dev = torch.from_numpy(np.ascontiguousarray(full)).to(device)
    if staged is not None:
        staged[key] = (full, dev)
    return dev


class MultiseedPretrainResult:
    def __init__(self, seeds, train_metrics, val_metrics, images_per_sec):
        self.seeds = list(seeds)
        # per-epoch lists of per-seed dicts: [{'loss','acc1','acc5'}, ...]
        self.train_metrics = train_metrics
        self.val_metrics = val_metrics
        self.images_per_sec = images_per_sec


def _shared_fingerprint(opts) -> None:
    ref = opts[0]
    for o in opts[1:]:
        for f in _SHARED_FIELDS:
            a, b = getattr(ref, f, None), getattr(o, f, None)
            if a != b:
                raise ValueError(
                    f"multiseed pretraining requires identical configs "
                    f"across seeds; field {f!r} differs: {a!r} vs {b!r}")
    if getattr(ref, "label_pull", None) is not None:
        raise ValueError(
            "label_pull pretraining is single-seed only (per-seed vocab "
            "orders differ); drop --label_pull or use train_supervised.py "
            "per seed")
    if getattr(ref, "distill", None) not in (None, "", "none"):
        raise ValueError("KD/NCE/CRD fan-out is single-seed only; use "
                         "train_supervised.py")
    if getattr(ref, "faithful_nbt", False):
        raise ValueError("--faithful_nbt eval counting is single-seed only")
    if getattr(ref, "eval_only", False):
        raise ValueError("--eval_only has nothing to train")


def _stage_splits(splits):
    """(shared host array, per-seed (S, n) row selections, per-seed (S, n)
    labels).  Eager splits are accepted when every seed got the same host
    array (tieredImageNet, or non-continual loads)."""
    imgs0 = splits[0].imgs
    if isinstance(imgs0, LazyRows):
        full = imgs0.full
        if not all(isinstance(s.imgs, LazyRows) and s.imgs.full is full
                   for s in splits):
            raise ValueError(
                "lazy splits must share one backing array (same "
                "data_root); load with load_mini_imagenet(..., lazy=True)")
        sel = np.stack([np.asarray(s.imgs.sel, np.int64) for s in splits])
    else:
        if not all(s.imgs is imgs0 for s in splits):
            raise ValueError(
                "eager per-seed splits with distinct arrays would upload S "
                "copies; load with lazy=True")
        full = imgs0
        sel = np.broadcast_to(np.arange(len(imgs0), dtype=np.int64),
                              (len(splits), len(imgs0)))
    labels = np.stack([np.asarray(s.labels, np.int64) for s in splits])
    if sel.shape != labels.shape:
        raise ValueError(f"rows {sel.shape} and labels {labels.shape}")
    return full, sel, labels


class _Rows:
    """``store[sel[i:j]]`` for slices: a lane's split of a staged store,
    as ``run_validation`` reads it."""

    def __init__(self, store: torch.Tensor, sel: torch.Tensor):
        self.store, self.sel = store, sel

    def __getitem__(self, i):
        return self.store[self.sel[i]]


def default_backbone(opt):
    """The single-seed CLI's backbone: ``opt.model`` in bf16."""
    from ..models.factory import create_model
    return create_model(opt.model, opt, dataset=opt.dataset,
                        dtype=torch.bfloat16)


def pretrain_multiseed(
        backbone_fn: Optional[Callable[[Any], torch.nn.Module]],
        opts: Sequence[Any],
        train_splits: Sequence[Any],
        val_splits: Sequence[Any],
        n_cls: int,
        save_fn: Optional[Callable[[int, int, Any, bool], None]] = None,
        start_states=None,
        verbose: bool = True,
        shard_over_devices: Union[bool, Sequence] = False,
        start_epoch: int = 1,
        device="cuda",
        draws=None,
        staged: Optional[dict] = None,
) -> MultiseedPretrainResult:
    """Train S seeds in lockstep, one lane a seed.

    ``backbone_fn(opt)`` builds a lane's backbone; it is called right after
    ``torch.manual_seed(opt.set_seed)`` (default: the CLI's bf16
    ``opt.model``).  ``save_fn(seed_index, epoch, lane_state, final)`` is
    called at the single-seed trainer's checkpoint cadence (``save_freq``
    epochs and the final epoch) with the lane's ``PretrainState``.

    ``shard_over_devices`` spreads the lanes over devices
    (``lane_devices``); each device holds its own copy of the store.

    ``start_states`` (one ``(variables, head, meta)`` a seed, from
    :func:`load_resume_states`) and ``start_epoch`` resume a checkpointed
    fan-out; the skipped epochs' shuffles are consumed so the resumed run
    equals the uninterrupted one.  ``draws`` (one draw provider a seed)
    replaces the lanes' ``TorchDraws``.  ``staged`` (``stage_shared``)
    carries the device stores from one seed group to the next.
    """
    S = len(opts)
    if S < 1 or not len(train_splits) == len(val_splits) == S:
        raise ValueError(f"{S} configurations, {len(train_splits)} train "
                         f"and {len(val_splits)} validation splits")
    _shared_fingerprint(opts)
    opt0 = opts[0]
    prt = print if verbose else (lambda *a, **k: None)
    backbone_fn = backbone_fn or default_backbone
    devs, slot = lane_devices(S, shard_over_devices, device)
    if len(devs) > 1:
        prt(f"==> sharding {S} seeds over {len(devs)} devices")

    train_spec, test_spec = transforms_options[opt0.transform]
    n_train = len(train_splits[0].labels)
    if not all(len(s.labels) == n_train for s in train_splits):
        raise ValueError("per-seed train splits must be the same size")
    n_val = len(val_splits[0].labels)
    if not all(len(s.labels) == n_val for s in val_splits):
        raise ValueError("per-seed validation splits must be the same size")
    steps_per_epoch = n_train // opt0.batch_size
    # the single-seed trainer's schedule and optimizer build
    sched = pt.make_schedule(opt0, steps_per_epoch)
    tx = pt.make_tx(opt0)

    # ---- data staging ----------------------------------------------------
    t0 = time.time()
    full_tr, sel_tr, lab_tr = _stage_splits(train_splits)
    full_va, sel_va, lab_va = _stage_splits(val_splits)
    stores = []
    for dev in devs:
        tr = stage_shared(full_tr, dev, staged)
        va = (tr if full_va is full_tr
              else stage_shared(full_va, dev, staged))
        stores.append((tr, va))
    prt(f"==> staged {np.asarray(full_tr).nbytes / 1e6:.0f} MB shared "
        f"store for {S} seeds [{time.time() - t0:.1f}s]")

    # ---- lanes (exact single-seed init streams) -------------------------
    draws = list(draws) if draws is not None else [None] * S
    lanes = []
    for i, o in enumerate(opts):
        dev = devs[slot[i]]
        torch.manual_seed(o.set_seed)
        bb = backbone_fn(o)
        state = pt.init_pretrain_state(
            bb, n_cls, tx, with_bias=o.linear_bias,
            generator=torch.Generator().manual_seed(o.set_seed), device=dev)
        if start_states is not None:
            pt.restore_pretrain_state(state, *start_states[i])
        # the lane's labels by row of the shared store
        by_row = np.full(len(full_tr), -1, np.int64)
        by_row[sel_tr[i]] = lab_tr[i]
        lanes.append(dict(
            state=state, device=dev, store=stores[slot[i]][0],
            step=pt.make_train_step_device_data(
                bb, sched, train_spec, with_bias=o.linear_bias,
                draws=draws[i] or TorchDraws(o.set_seed, dev)),
            eval=pt.make_eval_step(bb, test_spec,
                                   with_bias=o.linear_bias),
            labels=torch.from_numpy(by_row).to(dev),
            val=_Rows(stores[slot[i]][1],
                      torch.from_numpy(np.ascontiguousarray(
                          sel_va[i])).to(dev)),
            val_labels=lab_va[i]))

    shuffles = [np.random.RandomState(o.set_seed) for o in opts]
    for rs in shuffles:   # deterministic resume (see docstring)
        for _ in range(start_epoch - 1):
            rs.permutation(n_train)
    save_freq = int(getattr(opt0, "save_freq", 0) or 0)
    eval_bs = max(1, opt0.batch_size // 2)
    B = opt0.batch_size

    train_metrics: List[List[dict]] = []
    val_metrics: List[List[dict]] = []
    ips_l: List[float] = []
    for epoch in range(start_epoch, opt0.epochs + 1):
        te = time.time()
        # per-seed DataLoader shuffle (shuffle=True, drop_last=True)
        orders = np.stack([rs.permutation(n_train)[:steps_per_epoch * B]
                           for rs in shuffles])
        rows = np.take_along_axis(sel_tr, orders, axis=1)
        epoch_ms: List[List[torch.Tensor]] = [[] for _ in range(S)]
        for bi in range(steps_per_epoch):
            for i, lane in enumerate(lanes):
                idx = torch.from_numpy(rows[i, bi * B:(bi + 1) * B]).to(
                    lane["device"])
                m = lane["step"](lane["state"], lane["store"],
                                 lane["labels"], idx)
                epoch_ms[i].append(torch.stack(
                    [m["loss"], m["acc1"], m["acc5"]]))
        # one stacked metric pull a device per epoch
        per_lane = {}
        for k, dev in enumerate(devs):
            idx = [i for i in range(S) if slot[i] == k]
            got = torch.stack([torch.stack(epoch_ms[i])
                               for i in idx]).to(torch.float64).cpu()
            for j, i in enumerate(idx):
                per_lane[i] = got[j].mean(0).tolist()
        for dev in devs:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.time() - te
        ips = S * steps_per_epoch * B / dt
        ips_l.append(ips)
        train_metrics.append([dict(zip(("loss", "acc1", "acc5"),
                                       per_lane[i])) for i in range(S)])
        if verbose:
            la = ", ".join(f"s{o.set_seed}:{d['acc1']:.2f}"
                           for o, d in zip(opts, train_metrics[-1]))
            prt(f"epoch {epoch} [{dt:.1f}s, {ips:.1f} img/s aggregate] "
                f"train acc1 {la}")

        # validation, chunked like the CLI's (batch_size // 2)
        val_metrics.append([
            pt.run_validation(lane["eval"], lane["state"], lane["val"],
                              lane["val_labels"], eval_bs)
            for lane in lanes])
        if verbose:
            la = ", ".join(f"s{o.set_seed}:{d['acc1']:.2f}"
                           for o, d in zip(opts, val_metrics[-1]))
            prt(f"  * val acc1 {la}")

        if save_fn is not None and save_freq and epoch % save_freq == 0:
            for i, lane in enumerate(lanes):
                save_fn(i, epoch, lane["state"], False)

    if save_fn is not None and start_epoch <= opt0.epochs:
        # a nothing-to-do resume (start_epoch > epochs) skips the final
        # save rather than re-writing identical checkpoints
        for i, lane in enumerate(lanes):
            save_fn(i, opt0.epochs, lane["state"], True)
    elif start_epoch > opt0.epochs:
        prt(f"==> nothing to do: resumed at epoch {start_epoch} with "
            f"--epochs {opt0.epochs}")

    res = MultiseedPretrainResult([o.set_seed for o in opts],
                                  train_metrics, val_metrics, ips_l)
    res.final_states = [lane["state"] for lane in lanes]
    res.start_epoch = start_epoch
    return res


def load_resume_states(opts, n_cls: int, ckpt_paths: Sequence):
    """Per-seed resume points from fan-out checkpoints (either package's
    ``.ckpt``): parameters, BN statistics, counters, the optimizer state
    and the step, restored exactly (the single-seed CLI's
    ``--reload_path`` contract).

    Each ``ckpt_paths`` entry is a path or a list of candidate paths for
    that seed (``<model>_last.ckpt`` and the ``ckpt_epoch_N.ckpt``s); the
    candidate with the highest checkpointed epoch wins, so a stale
    ``_last`` from an earlier completed run cannot shadow newer progress.
    Seeds checkpointed at different epochs are refused.

    Returns ``(per_seed, start_epoch)``: ``per_seed[i]`` is the
    ``(variables, head, meta)`` of ``utils.checkpoint.load_checkpoint``
    for ``pretrain_multiseed(start_states=..., start_epoch=...)``.
    """
    from ..utils.checkpoint import load_checkpoint

    if len(ckpt_paths) != len(opts):
        raise ValueError(f"{len(ckpt_paths)} checkpoint lists for "
                         f"{len(opts)} seeds")
    per_seed, epochs = [], set()
    for cands in ckpt_paths:
        if isinstance(cands, str):
            cands = [cands]
        best = None
        for path in cands:
            variables, head, meta = load_checkpoint(path)
            ep = int(meta.get("epoch", 0))
            if best is None or ep > best[0]:
                best = (ep, path, variables, head, meta)
        ep, path, variables, head, meta = best
        extra = meta.get("extra") or {}
        if "opt_state" not in extra or "step" not in extra:
            raise ValueError(f"{path} carries no optimizer state; it cannot "
                             "resume deterministically")
        if np.asarray(head.weight).shape[0] < n_cls:
            raise ValueError(f"{path}: a {np.asarray(head.weight).shape[0]}"
                             f"-row head for {n_cls} classes")
        per_seed.append((variables, head, meta))
        epochs.add(ep)
    if len(epochs) != 1:
        raise ValueError(f"seeds checkpointed at different epochs "
                         f"{sorted(epochs)}; resume needs a consistent "
                         "fan-out snapshot")
    return per_seed, epochs.pop() + 1
