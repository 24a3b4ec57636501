"""Dataset dispatch + session budget for the incremental-eval CLI and the
multi-seed fan-out (one implementation behind both).

Semantics mirror the JAX package's ``data/eval_splits.py``: reference
eval_incremental.py:44-107 for the loader dispatch (the reference raises
for CIFAR and tieredImageNet; both are wired end to end here) and
eval/language_eval.py:132-136 for the hardcoded 8 sessions.
"""

from __future__ import annotations

from ..config import MAX_SESSIONS
from .mini_imagenet import load_mini_imagenet


def load_eval_splits(opt, lazy: bool = False):
    """Load (base_test, base_train, novel, n_cls) for the FSCIL protocol
    and clamp ``opt.neval_episodes`` to the novel class budget.

    ``base_train`` is None when ``n_base_support_samples == 0`` (for
    tiered this skips the largest archive).  ``lazy=True`` returns
    ``LazyRows`` views over the shared pickle arrays where the loader
    supports it (miniImageNet, CIFAR).  Mutates ``opt``:
    ``neval_episodes`` (clamp) and ``transform`` (CIFAR -> 'D')."""
    need_base = opt.n_base_support_samples > 0
    if opt.dataset == "miniImageNet":
        # base test samples: base classes, unused-in-training samples
        # (reference eval_incremental.py:53-57)
        base_test = load_mini_imagenet(opt, split="train", phase="test",
                                       lazy=lazy)
        base_train = (load_mini_imagenet(opt, split="train", phase="train",
                                         lazy=lazy) if need_base else None)
        novel = load_mini_imagenet(opt, split="val", lazy=lazy)
        n_cls = 80 if opt.use_trainval else (60 if opt.continual else 64)
    elif opt.dataset in ("CIFAR-FS", "FC100"):
        # the CIFAR continual protocol on the shared 60/40 split
        from .cifar import load_cifar_continual
        base_test = load_cifar_continual(opt, split="train", phase="test",
                                         lazy=lazy)
        base_train = (load_cifar_continual(opt, split="train",
                                           phase="train", lazy=lazy)
                      if need_base else None)
        novel = load_cifar_continual(opt, split="val", lazy=lazy)
        opt.transform = "D"
        n_cls = 60
    elif opt.dataset == "tieredImageNet":
        # base: the 351-class train_a partition's phase split
        # (dataset/tiered_imagenet.py:24-35); novel episodes from the
        # class-disjoint val partition
        from .tiered_imagenet import load_tiered_imagenet
        base_test = load_tiered_imagenet(opt, partition="train",
                                         phase="test")
        base_train = (load_tiered_imagenet(opt, partition="train",
                                           phase="train")
                      if need_base else None)
        novel = load_tiered_imagenet(opt, partition="val", pretrain=False)
        n_cls = 448 if opt.use_trainval else 351
    else:
        raise NotImplementedError(opt.dataset)

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
