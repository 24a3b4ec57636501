"""Dataset dispatch + session budget for the incremental-eval CLI.

miniImageNet only in this package; the tieredImageNet and CIFAR continual
loaders are still to be ported (ROADMAP.md queue A, "other datasets").
Semantics mirror the JAX package's ``data/eval_splits.py``: reference
eval_incremental.py:44-107 for the loader dispatch and
eval/language_eval.py:132-136 for the hardcoded 8 sessions.
"""

from __future__ import annotations

from ..config import MAX_SESSIONS
from .mini_imagenet import load_mini_imagenet


def load_eval_splits(opt):
    """Load (base_test, base_train, novel, n_cls) for the FSCIL protocol
    and clamp ``opt.neval_episodes`` to the novel class budget.

    ``base_train`` is None when ``n_base_support_samples == 0``.  Mutates
    ``opt.neval_episodes`` (clamp)."""
    if opt.dataset != "miniImageNet":
        raise NotImplementedError(
            f"{opt.dataset}: only miniImageNet is ported so far; the "
            "tieredImageNet/CIFAR loaders are ROADMAP.md queue A item 5")
    # base test samples: base classes, unused-in-training samples
    # (reference eval_incremental.py:53-57)
    base_test = load_mini_imagenet(opt, split="train", phase="test")
    base_train = (load_mini_imagenet(opt, split="train", phase="train")
                  if opt.n_base_support_samples > 0 else None)
    novel = load_mini_imagenet(opt, split="val")
    n_cls = 80 if opt.use_trainval else (60 if opt.continual else 64)

    # the reference hardcodes 8 sessions (eval_incremental.py:123); an
    # explicit --neval_episodes (!= the dead 2000 parser default) overrides,
    # bounded by the novel class budget the disjoint sampler consumes
    n_novel_classes = len(set(novel.labels))
    budget = n_novel_classes // opt.n_ways
    if opt.neval_episodes == 2000:
        opt.neval_episodes = MAX_SESSIONS
    if opt.neval_episodes > budget:
        print(f"==> clamping sessions to the novel class budget: "
              f"{budget} ({n_novel_classes} classes / {opt.n_ways}-way)")
        opt.neval_episodes = budget
    return base_test, base_train, novel, n_cls
