"""Incremental FSCIL evaluation CLI of the port — flag-compatible with the
repo's ``eval_incremental.py`` (reference eval_incremental.py:24-140), plus
``--device`` (default ``cuda``; ``cpu`` runs the plain twins):

  python -m subspace_reg_tpu_torch.eval_incremental \
      --model_path backbone.pth --model resnet18 --no_dropblock \
      --data_root data --n_shots 5 --classifier linear \
      --eval_mode few-shot-incremental-fine-tune --min_novel_epochs 20 \
      --learning_rate 0.002 --freeze_backbone_at 1 \
      --test_base_batch_size 2000 --continual --n_queries 25 \
      --lmbd_reg_transform_w 0.2 --target_train_loss 0.0 \
      --label_pull 1.0 --lmbd_reg_novel 0.1 --set_seed 1 \
      --attraction_override distance2subspace \
      --n_base_support_samples 1 --memory_replay 1

``--model_path`` is a reference ``.pth`` or a ``.ckpt`` of either
package's pretraining CLI; ``--dataset`` is miniImageNet, tieredImageNet,
CIFAR-FS or FC100 (continual).  Every flag of the JAX CLI runs:
``--freeze_backbone_at N`` (the backbone trains for epochs 1..N-1 of each
session), ``--track_weights`` and ``--track_label_inspired_weights`` (the
reference-named tracking CSVs) and ``--save_preds_0``
(``csv_files_mem/seed_..._predictions.csv``), each written in the
working directory as the JAX CLI writes them.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .config import parse_option_eval
from .data.episodes import EpisodeSampler
from .data.eval_splits import load_eval_splits
from .engine.incremental import few_shot_finetune_incremental_test, session_count
from .models.factory import create_model
from .utils.checkpoint import load_any


def main(argv=None, draws=None):
    """Parse ``argv`` and run the evaluation.  ``draws`` (a draw provider,
    engine/draws.py) is handed to the engine; it is a keyword for tests,
    not a command-line flag."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    known, rest = pre.parse_known_args(argv)
    opt = parse_option_eval(rest)

    np.random.seed(opt.set_seed)

    print("************* Training arguments *************")
    for k, v in vars(opt).items():
        print(k, v)
    print("device", known.device)
    print("End of arguments.\n")

    base_test, base_train, novel, n_cls = load_eval_splits(opt)
    base_support_sampler = None
    if base_train is not None:
        base_support_sampler = EpisodeSampler(
            base_train, opt, split="train", phase="train")
    # disjoint classes unconditionally, as the reference CLI hardcodes for
    # miniImageNet (eval_incremental.py:75)
    meta_sampler = EpisodeSampler(novel, opt, split="val",
                                  use_episodes=opt.use_episodes,
                                  disjoint_classes=True)

    max_classes = n_cls + session_count(opt) * opt.n_ways
    # a reference .pth or a JAX-package .ckpt (eval_incremental.py:65)
    state, head, meta = load_any(opt.model_path, max_classes=max_classes)
    # linear bias inferred from the checkpoint (eval_incremental.py:99-105)
    if opt.classifier != "linear":
        raise ValueError("--classifier linear is the only head the "
                         "incremental evaluation serves")
    opt.linear_bias = bool(meta.get("has_bias", head.bias is not None))

    backbone = create_model(opt.model, opt, dataset=opt.dataset)
    backbone.load_state_dict(state)
    opt.split = "val"

    start = time.time()
    result = few_shot_finetune_incremental_test(
        backbone, head, meta, opt, meta_sampler=meta_sampler,
        base_test_split=base_test, base_support_sampler=base_support_sampler,
        device=known.device, draws=draws)
    val_time = time.time() - start

    print("val_acc_novel: {:.4f}, std: {:.4f}, time: {:.1f}".format(
        result.acc_novel_avg, 0, val_time))
    print("val_acc_base: {:.4f}, std: {:.4f}, time: {:.1f}".format(
        result.acc_base_avg, 0, val_time))
    print("val_acc_average: {:.4f}".format(result.acc_average))
    return result


if __name__ == "__main__":
    main()
