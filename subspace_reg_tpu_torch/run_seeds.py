"""Multi-seed fan-out of the port, the counterpart of the repo's
``tools/run_seeds.py`` (the reference ran the paper's 10 seeds as Slurm
arrays of single-GPU jobs, scripts/continual/slurm_*.sh:8,19-27):

  python -m subspace_reg_tpu_torch.run_seeds --seeds 1 2 3 4 5 --vmap \
      -- <eval_incremental flags without --set_seed>

  # backbone pretraining (reference slurm_run_backbone.sh:30-40)
  python -m subspace_reg_tpu_torch.run_seeds --pretrain --vmap \
      --seeds 1 2 3 4 5 -- <train_supervised flags without --set_seed>

Without ``--vmap`` each seed runs the port's eval CLI in this process, one
after another; with ``--vmap`` the seeds of each group of ``--seed_batch``
(default: all) run through one multi-seed engine call
(engine/multiseed.py), with one seed-batched K1 launch per session.  The
aggregates, mean and 95% confidence half-width over the seeds, are printed
as JSON.  ``--save_preds_0`` among the eval flags writes one prediction
dump per seed.  ``--device`` (default ``cuda``) is the engine's.

``--pretrain`` fans out backbone pretraining.  Without ``--vmap`` each
seed runs the port's pretraining CLI in this process, into
``<model_path>/seed_<seed>/`` (or ``--model_path_pattern``); with
``--vmap`` the seeds of each ``--seed_batch`` group train in lockstep
through the multi-seed trainer (engine/multiseed_pretrain.py) from one
staged store (miniImageNet and CIFAR-FS/FC100 continual as lazy rows,
tieredImageNet's seed-independent split), each seed's ``.ckpt`` in its
folder at the CLI's cadence and its metric log under ``<folder>/tb``.
``--resume`` restarts every seed from its latest checkpoint (the resumed
run equals the uninterrupted one); ``--shard_seeds`` spreads each
group's seeds over the visible cards.  The printed JSON is ``{"seeds",
"val_acc1"}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List

from .utils.artifacts import mean_confidence_interval

PALLAS_MODES = ("auto", "on", "off", "interpret")


def _seed_argv(args, rest: List[str], seed: int) -> List[str]:
    argv = rest + ["--set_seed", str(seed)]
    if args.model_path_pattern:
        argv += ["--model_path", args.model_path_pattern.format(seed=seed)]
    return argv


def _run_vmapped(args, rest: List[str], seeds: List[int], draws=None):
    """The seeds through one multi-seed engine call; one result each."""
    from .config import parse_option_eval
    from .data.episodes import EpisodeSampler
    from .data.eval_splits import load_eval_splits
    from .engine.incremental import session_count
    from .engine.multiseed import few_shot_finetune_multiseed
    from .models.factory import create_model
    from .utils.checkpoint import load_any

    opts, backbones, heads, metas = [], [], [], []
    samplers, base_tests, base_supports = [], [], []
    loaded = {}
    for seed in seeds:
        opt = parse_option_eval(_seed_argv(args, rest, seed))
        base_test, base_train, novel, n_cls = load_eval_splits(opt)
        max_classes = n_cls + session_count(opt) * opt.n_ways
        # seeds that share a checkpoint read it once
        key = (opt.model_path, max_classes)
        if key not in loaded:
            loaded[key] = load_any(opt.model_path, max_classes=max_classes)
        state, head, meta = loaded[key]
        if opt.classifier != "linear":
            raise ValueError("--classifier linear is the only head the "
                             "incremental evaluation serves")
        opt.linear_bias = bool(meta.get("has_bias", head.bias is not None))
        opt.split = "val"
        backbone = create_model(opt.model, opt, dataset=opt.dataset)
        backbone.load_state_dict(state)
        opts.append(opt)
        backbones.append(backbone)
        heads.append(head)
        metas.append(meta)
        base_tests.append(base_test)
        samplers.append(EpisodeSampler(novel, opt, split="val",
                                       use_episodes=opt.use_episodes,
                                       disjoint_classes=True))
        base_supports.append(
            EpisodeSampler(base_train, opt, split="train", phase="train")
            if base_train is not None else None)
    if any(b is None for b in base_supports):
        base_supports = None
    ms = few_shot_finetune_multiseed(
        backbones, heads, metas, opts, samplers, base_tests,
        per_seed_base_support=base_supports, verbose=True,
        device=args.device, draws=draws)
    return ms.per_seed


def _run_one(args, rest: List[str], seed: int, draws=None):
    from . import eval_incremental
    return eval_incremental.main(
        _seed_argv(args, rest, seed) + ["--device", args.device],
        draws=draws)


def parse_args(argv):
    if "--" in argv:
        split = argv.index("--")
        own, rest = argv[:split], argv[split + 1:]
    else:
        own, rest = argv, []
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+",
                   default=list(range(1, 11)))
    p.add_argument("--model_path_pattern", type=str, default=None,
                   help="per-seed checkpoint path with {seed}")
    p.add_argument("--vmap", action="store_true",
                   help="all seeds of a group through one multi-seed engine "
                   "call (one seed-batched K1 launch per session)")
    p.add_argument("--seed_batch", type=int, default=None,
                   help="groups of this many seeds (default: all in one)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--pallas", default="auto", choices=PALLAS_MODES,
                   help="accepted for the JAX tool's flags; the card runs "
                   "the hand-written K1 only (auto or on)")
    p.add_argument("--pretrain", action="store_true",
                   help="fan out backbone pretraining over the seeds (the "
                   "flags after -- go to train_supervised)")
    p.add_argument("--shard_seeds", action="store_true",
                   help="with --pretrain --vmap: spread each group's seeds "
                   "over the visible cards (the store copied to each)")
    p.add_argument("--resume", action="store_true",
                   help="with --pretrain --vmap: resume every seed from its "
                   "latest checkpoint (the resumed run equals the "
                   "uninterrupted one)")
    return p.parse_args(own), rest


def _refuse(args) -> None:
    for flag in ("shard_seeds", "resume"):
        if getattr(args, flag) and not (args.pretrain and args.vmap):
            raise ValueError(f"--{flag} needs --pretrain --vmap")
    if args.device.startswith("cuda") and args.pallas not in ("auto", "on"):
        raise ValueError(f"--pallas {args.pallas}: on the card the fine-tune "
                         "loop runs only as its hand-written kernel (auto or "
                         "on)")
    if args.seed_batch is not None and args.seed_batch < 1:
        raise ValueError("--seed_batch must be >= 1")


def _pretrain_splits(opt):
    """A seed's (train, val, n_cls) for the multi-seed trainer: the
    continual splits as lazy rows of the shared pickle, tieredImageNet's
    seed-independent split (one cached host array for every seed)."""
    from .train_supervised import load_splits
    if opt.dataset in ("miniImageNet", "CIFAR-FS", "FC100") \
            and opt.continual:
        return load_splits(opt, lazy=True)
    if opt.dataset == "tieredImageNet":
        if opt.augment_pretrain_wtrainb:
            raise ValueError(
                "--pretrain --vmap: train_b pooling (and its 200-class eval "
                "truncation) is single-seed only; drop --vmap or "
                "--augment_pretrain_wtrainb")
        return load_splits(opt)
    raise ValueError(
        "--pretrain --vmap serves the backbone fan-outs (miniImageNet/"
        "CIFAR continual, tieredImageNet); other datasets and protocols "
        "run per seed through train_supervised (drop --vmap)")


def _run_pretrain_vmapped(args, seeds: List[int], rest: List[str],
                          draws=None, staged=None):
    """One seed group's pretraining through the multi-seed trainer;
    ``staged`` holds the fan-out's device stores across groups."""
    from .config import parse_option_supervised
    from .engine import pretrain as pt
    from .engine.multiseed_pretrain import (load_resume_states,
                                            pretrain_multiseed)
    from .utils.checkpoint import save_checkpoint
    from .utils.device import resolve_device
    from .utils.logging import MetricWriter

    device = resolve_device(args.device)
    opts, trains, vals = [], [], []
    n_cls = None
    for seed in seeds:
        opt = parse_option_supervised(_seed_argv(args, rest, seed)
                                      + ["--device", args.device])
        if not args.model_path_pattern:
            # one fan-out root, a folder a seed (the Slurm array's
            # layout)
            opt.save_folder = os.path.join(opt.save_folder, f"seed_{seed}")
            os.makedirs(opt.save_folder, exist_ok=True)
        train, val, n_cls = _pretrain_splits(opt)
        opts.append(opt)
        trains.append(train)
        vals.append(val)

    def save_fn(i, epoch, state, final):
        # the CLI's checkpoint (train_supervised.py save): the continual
        # split's classes, the optimizer state and the step
        opt, split = opts[i], trains[i]
        meta = {}
        if opt.continual:
            meta = dict(training_classes=split.basec_map,
                        label2human=split.label2human)
        meta["epoch"] = epoch
        name = (f"{opt.model}_last.ckpt" if final
                else f"ckpt_epoch_{epoch}.ckpt")
        variables, head, extra = pt.checkpoint_parts(state)
        save_checkpoint(os.path.join(opt.save_folder, name), variables,
                        head, meta, extra=extra)
        print(f"==> Saved {name} (seed {opt.set_seed})")

    start_states, start_epoch = None, 1
    if args.resume:
        paths = []
        for opt in opts:
            last = os.path.join(opt.save_folder, f"{opt.model}_last.ckpt")
            # every candidate: the one at the highest epoch wins, so a
            # stale _last cannot shadow newer ckpt_epoch_N progress
            cands = ([last] if os.path.exists(last) else []) + sorted(
                os.path.join(opt.save_folder, f)
                for f in os.listdir(opt.save_folder)
                if f.startswith("ckpt_epoch_"))
            if not cands:
                raise FileNotFoundError(
                    f"--resume: no checkpoint in {opt.save_folder}")
            paths.append(cands)
        start_states, start_epoch = load_resume_states(opts, n_cls, paths)
        print(f"==> resuming {len(paths)} seeds at epoch {start_epoch}")

    res = pretrain_multiseed(None, opts, trains, vals, n_cls,
                             save_fn=save_fn, start_states=start_states,
                             start_epoch=start_epoch, device=device,
                             shard_over_devices=args.shard_seeds,
                             draws=draws, staged=staged)
    # per-seed metric logs with the single-seed CLI's scalar names
    for i, opt in enumerate(opts):
        w = MetricWriter(os.path.join(opt.save_folder, "tb"))
        for e, (tm, vm) in enumerate(zip(res.train_metrics,
                                         res.val_metrics)):
            epoch = res.start_epoch + e
            w.log_value("train_acc", tm[i]["acc1"], epoch)
            w.log_value("train_loss", tm[i]["loss"], epoch)
            # the group's aggregate: one trainer steps all seeds
            w.log_value("images_per_sec", res.images_per_sec[e], epoch)
            w.log_value("test_acc", vm[i]["acc1"], epoch)
            w.log_value("test_acc_top5", vm[i]["acc5"], epoch)
            w.log_value("test_loss", vm[i]["loss"], epoch)
        w.close()
    return res


def _pretrain(args, rest: List[str], draws=None):
    """``--pretrain``: the backbone fan-out; returns the printed dict."""
    from . import train_supervised
    seeds = list(args.seeds)
    out = {"seeds": seeds, "val_acc1": {}}
    if args.vmap:
        group = args.seed_batch or len(seeds)
        # the shared store, uploaded once for every group of this fan-out
        staged: dict = {}
        for lo in range(0, len(seeds), group):
            g = seeds[lo:lo + group]
            if len(seeds) > group:
                print(f"===== pretrain seed group {g} =====", flush=True)
            t0 = time.time()
            res = _run_pretrain_vmapped(
                args, g, rest, None if draws is None
                else draws[lo:lo + group], staged)
            ips = (f"{sum(res.images_per_sec) / len(res.images_per_sec):.0f}"
                   " img/s" if res.images_per_sec else "no epochs ran")
            print(f"[group {g} wall {time.time() - t0:.1f}s; aggregate "
                  f"{ips}]", flush=True)
            # a nothing-to-do resume has no validation to report
            if res.val_metrics:
                for s, vm in zip(g, res.val_metrics[-1]):
                    out["val_acc1"][s] = vm["acc1"]
    else:
        for seed in seeds:
            seed_argv = rest + ["--set_seed", str(seed)]
            if args.model_path_pattern:
                seed_argv += ["--model_path",
                              args.model_path_pattern.format(seed=seed)]
            elif "--model_path" in rest:
                # a folder a seed, so the runs' <model>_last.ckpt do not
                # overwrite each other
                mp = rest[rest.index("--model_path") + 1]
                seed_argv += ["--model_path",
                              os.path.join(mp, f"seed_{seed}")]
            else:
                raise SystemExit(
                    "--pretrain needs --model_path_pattern or a "
                    "--model_path after -- (per-seed checkpoints would "
                    "otherwise collide)")
            print(f"===== pretrain seed {seed} =====", flush=True)
            train_supervised.main(seed_argv + ["--device", args.device])
    print(json.dumps(out, indent=2, default=float))
    return out


def main(argv=None, draws=None):
    """Run the fan-out; returns the aggregate dict it prints.  ``draws``
    (one draw provider per seed, in ``--seeds`` order) is a keyword for
    tests, not a command-line flag."""
    args, rest = parse_args(list(sys.argv[1:] if argv is None else argv))
    _refuse(args)
    if args.pretrain:
        return _pretrain(args, rest, draws)
    seeds = list(args.seeds)
    draws = list(draws) if draws is not None else [None] * len(seeds)
    results = []
    if args.vmap:
        group = args.seed_batch or len(seeds)
        for lo in range(0, len(seeds), group):
            g = seeds[lo:lo + group]
            print(f"===== seed group {g} =====", flush=True)
            gdraws = draws[lo:lo + group]
            results += _run_vmapped(
                args, rest, g,
                None if all(d is None for d in gdraws) else gdraws)
    else:
        for seed, d in zip(seeds, draws):
            print(f"===== seed {seed} =====", flush=True)
            results.append(_run_one(args, rest, seed, d))

    novel = [r.acc_novel_avg for r in results]
    base = [r.acc_base_avg for r in results]
    out = {"seeds": seeds}
    for name, vals in (("novel", novel), ("base", base)):
        if len(vals) > 1:
            m, h = mean_confidence_interval(vals)
            out[name] = {"mean": float(m), "ci95": float(h)}
        else:
            out[name] = {"mean": float(vals[0])}
    out["weighted_traces"] = [r.weighted_avg_l for r in results]
    out["epochs"] = [r.epochs_per_session for r in results]
    print(json.dumps(out, indent=2, default=float))
    return out


if __name__ == "__main__":
    main()
