"""Multi-seed FSCIL evaluation fan-out of the port, the evaluation side of
the repo's ``tools/run_seeds.py`` (the reference ran the paper's 10 seeds
as Slurm arrays of single-GPU jobs, scripts/continual/slurm_*.sh:8,19-27):

  python -m subspace_reg_tpu_torch.run_seeds --seeds 1 2 3 4 5 --vmap \
      -- <eval_incremental flags without --set_seed>

Without ``--vmap`` each seed runs the port's eval CLI in this process, one
after another; with ``--vmap`` the seeds of each group of ``--seed_batch``
(default: all) run through one multi-seed engine call
(engine/multiseed.py), with one seed-batched K1 launch per session.  The
aggregates, mean and 95% confidence half-width over the seeds, are printed
as JSON.  ``--save_preds_0`` among the eval flags writes one prediction
dump per seed.  ``--device`` (default ``cuda``) is the engine's.  Backbone
pretraining over seeds (``--pretrain``, ``--shard_seeds``, ``--resume``) is
not ported yet (ROADMAP.md queue A item 7).
"""

from __future__ import annotations

import argparse
import json
import sys
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
    for flag in ("--pretrain", "--shard_seeds", "--resume"):
        p.add_argument(flag, action="store_true")
    return p.parse_args(own), rest


def _refuse(args) -> None:
    for flag in ("pretrain", "shard_seeds", "resume"):
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag}: multi-seed backbone pretraining is not ported "
                "yet (ROADMAP.md queue A item 7); the JAX package's "
                "tools/run_seeds.py serves it")
    if args.device.startswith("cuda") and args.pallas not in ("auto", "on"):
        raise ValueError(f"--pallas {args.pallas}: on the card the fine-tune "
                         "loop runs only as its hand-written kernel (auto or "
                         "on)")
    if args.seed_batch is not None and args.seed_batch < 1:
        raise ValueError("--seed_batch must be >= 1")


def main(argv=None, draws=None):
    """Run the fan-out; returns the aggregate dict it prints.  ``draws``
    (one draw provider per seed, in ``--seeds`` order) is a keyword for
    tests, not a command-line flag."""
    args, rest = parse_args(list(sys.argv[1:] if argv is None else argv))
    _refuse(args)
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
