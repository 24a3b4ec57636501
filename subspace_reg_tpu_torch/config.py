"""CLI configuration with flag parity (the port's own copy).

The same public flag surfaces as ``eval_incremental.py`` (reference
configs.py:10-114, ``EvalConfig``) and ``train_supervised.py`` (reference
configs.py:116-241, ``SupervisedConfig``).  Kept here as a copy so the port
imports nothing from the JAX package:

  * ``--pulling`` only registered when ``--label_pull`` given
                           -> reference configs.py:85-87
  * ``use_trainval`` inferred from 'trainval' in model_path
                           -> reference configs.py:102-105
  * data_root '<root>/<dataset>' layout -> reference configs.py:107-112
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
from dataclasses import dataclass, field
from typing import List, Optional

# Static FSCIL geometry for the multi-session ("continual") protocol:
# 8 sessions of 5 novel classes over 60 base classes (miniImageNet),
# reference eval/language_eval.py:132-136.
MAX_SESSIONS = 8


def _git_head_hash() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, check=False,
        ).stdout
        return out.decode().strip()
    except OSError:
        return ""


@dataclass
class EvalConfig:
    """Flags of ``eval_incremental`` (reference configs.py:10-114)."""

    model: str = "resnet12"
    model_path: Optional[str] = None
    dataset: str = "miniImageNet"
    transform: str = "A"
    data_root: str = ""
    n_test_runs: int = 2000
    n_ways: int = 5
    n_shots: int = 1
    n_queries: int = 5
    n_aug_support_samples: int = 5
    n_base_aug_support_samples: int = 0
    n_base_support_samples: int = 0
    num_workers: int = 4
    test_batch_size: int = 1
    test_base_batch_size: int = 50
    set_seed: int = 5
    eval_mode: Optional[str] = None
    classifier: Optional[str] = None
    verbose: bool = False
    track_weights: bool = False
    track_label_inspired_weights: bool = False
    save_preds_0: bool = False
    use_synonyms: bool = False
    neval_episodes: int = 2000
    word_embed_size: int = 500
    word_embed_path: str = "word_embeds"
    glove: bool = False
    use_descriptions: bool = False
    description_embed_path: str = "description_embeds"
    desc_embed_model: str = "bert-base-cased"
    transformer_layer: int = 6
    prefix_label: bool = True
    continual: bool = False
    label_pull: Optional[float] = None
    push_away: Optional[float] = None
    no_dropblock: bool = False
    attraction_override: Optional[str] = None
    lmbd_reg_novel: Optional[float] = None
    stable_epochs: int = 10
    convergence_epsilon: float = 1e-4
    temperature: float = 1.0
    memory_replay: int = 0
    pulling: str = "regularize"          # conditional flag (configs.py:85-87)
    min_novel_epochs: int = 15
    max_novel_epochs: int = 1000
    learning_rate: float = 0.01
    weight_decay: float = 5e-4
    momentum: float = 0.9
    adam: bool = False
    freeze_backbone_at: int = 1
    lmbd_reg_transform_w: Optional[float] = None
    target_train_loss: float = 1.0
    saliency: bool = False
    use_episodes: bool = False

    # -- derived / runtime-mutated fields (reference mutates opt in place) --
    use_trainval: bool = False
    data_aug: bool = False
    linear_bias: bool = True             # inferred from ckpt (eval_incremental.py:99-105)
    split: str = "val"
    stable: bool = False
    git_head_hash: str = ""
    attention: Optional[str] = None

    def finalize(self) -> "EvalConfig":
        self.use_trainval = bool(self.model_path
                                 and "trainval" in self.model_path)
        if not self.data_root:
            self.data_root = "./data/{}".format(self.dataset)
        else:
            self.data_root = "{}/{}".format(self.data_root, self.dataset)
            self.data_aug = True
        self.git_head_hash = _git_head_hash()
        return self


def _add_flags_from_dataclass(parser: argparse.ArgumentParser, cfg_cls,
                              skip) -> None:
    for f in dataclasses.fields(cfg_cls):
        if f.name in skip:
            continue
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool):
            parser.add_argument("--" + f.name, action="store_true",
                                default=default)
        elif f.type == "Optional[float]":
            parser.add_argument("--" + f.name, type=float, default=default)
        elif f.type in ("int", int):
            parser.add_argument("--" + f.name, type=int, default=default)
        elif f.type in ("float", float):
            parser.add_argument("--" + f.name, type=float, default=default)
        else:
            parser.add_argument("--" + f.name, type=str, default=default)


_EVAL_DERIVED = {
    "use_trainval", "data_aug", "linear_bias", "split", "stable",
    "git_head_hash", "attention", "pulling",
}


def parse_option_eval(argv=None) -> EvalConfig:
    """CLI-parity parser for the incremental-eval entry point."""
    parser = argparse.ArgumentParser("argument for training")
    _add_flags_from_dataclass(parser, EvalConfig, _EVAL_DERIVED)
    # prefix_label defaults True; store_true flags can't be unset, so the
    # inverse is exposed
    parser.add_argument("--no_prefix_label", action="store_true",
                        default=False)
    # conditional registration quirk (reference configs.py:85-87)
    known, _ = parser.parse_known_args(argv)
    if known.label_pull is not None:
        parser.add_argument("--pulling", type=str, default="regularize")
    ns = parser.parse_args(argv)
    d = {k: v for k, v in vars(ns).items() if k != "no_prefix_label"}
    if ns.no_prefix_label:
        d["prefix_label"] = False
    return EvalConfig(**d).finalize()


@dataclass
class SupervisedConfig:
    """Flags of ``train_supervised`` (reference configs.py:116-241; the
    JAX package's ``SupervisedConfig``), plus ``--device``."""

    eval_freq: int = 10
    print_freq: int = 100
    tb_freq: int = 500
    save_freq: int = 10
    batch_size: int = 64
    num_workers: int = 8
    epochs: int = 100
    learning_rate: float = 0.05
    lr_decay_epochs: str = "60,80"
    lr_decay_rate: float = 0.1
    weight_decay: float = 5e-4
    momentum: float = 0.9
    adam: bool = False
    eval_only: bool = False
    model: str = "resnet12"
    dataset: str = "miniImageNet"
    transform: str = "A"
    use_trainval: bool = False
    cosine: bool = False
    reload_path: str = ""
    model_path: str = ""
    tb_path: str = ""
    data_root: str = ""
    n_test_runs: int = 600
    n_ways: int = 5
    n_shots: int = 1
    n_queries: int = 15
    n_aug_support_samples: int = 5
    test_batch_size: int = 1
    use_episodes: bool = False
    classifier: Optional[str] = None
    trial: str = "1"
    continual: bool = False
    no_dropblock: bool = False
    # the reference's per-forward num_batches_tracked increment on eval
    # forwards too (models/resnet_language.py:269)
    faithful_nbt: bool = False
    set_seed: int = 5
    no_linear_bias: bool = False
    augment_pretrain_wtrainb: bool = False
    eval_mode: Optional[str] = None
    label_pull: Optional[float] = None
    # distillation
    distill: str = "none"
    teacher_path: str = ""
    teacher_model: str = ""
    kd_T: float = 4.0
    kd_alpha: float = 1.0
    kd_beta: float = 1.0
    feat_dim: int = 128
    nce_k: int = 16384
    nce_t: float = 0.07
    nce_m: float = 0.5
    # conditional flags (configs.py:181-188), valid when label_pull given
    word_embed_size: int = 500
    word_embed_path: str = "word_embeds"
    use_synonyms: bool = False
    glove: bool = False
    device: str = "cuda"

    # -- derived --
    lr_decay_epochs_list: List[int] = field(default_factory=lambda: [60, 80])
    linear_bias: bool = True
    model_name: str = ""
    tb_folder: str = ""
    save_folder: str = ""
    n_devices: int = 1
    data_aug: bool = True
    git_head_hash: str = ""
    attention: Optional[str] = None

    def finalize(self, make_dirs: bool = True) -> "SupervisedConfig":
        if self.distill not in ("none", "kd", "nce", "crd"):
            raise ValueError("--distill must be one of none|kd|nce|crd, "
                             f"got {self.distill!r}")
        if self.dataset in ("CIFAR-FS", "FC100"):
            self.transform = "D"
        if self.use_trainval:
            self.trial = self.trial + "_trainval"
        if not self.model_path:
            self.model_path = "./models_pretrained"
        if not self.tb_path:
            self.tb_path = "./tensorboard"
        if not self.data_root:
            self.data_root = "./data/{}".format(self.dataset)
        else:
            self.data_root = "{}/{}".format(self.data_root, self.dataset)
        self.data_aug = True
        self.lr_decay_epochs_list = [
            int(it) for it in str(self.lr_decay_epochs).split(",")]
        self.linear_bias = not self.no_linear_bias
        self.model_name = "{}_{}_classifier_{}".format(
            self.dataset, self.model, self.classifier)
        self.tb_folder = os.path.join(self.tb_path, self.model_name)
        self.save_folder = self.model_path
        if make_dirs:
            os.makedirs(self.tb_folder, exist_ok=True)
            os.makedirs(self.save_folder, exist_ok=True)
        self.git_head_hash = _git_head_hash()
        return self


_SUP_DERIVED = {
    "lr_decay_epochs_list", "linear_bias", "model_name", "tb_folder",
    "save_folder", "n_devices", "data_aug", "git_head_hash", "attention",
    "word_embed_size", "word_embed_path", "use_synonyms", "glove",
}


def parse_option_supervised(argv=None,
                            make_dirs: bool = True) -> SupervisedConfig:
    """CLI-parity parser for the pretraining entry point."""
    parser = argparse.ArgumentParser("argument for training")
    _add_flags_from_dataclass(parser, SupervisedConfig, _SUP_DERIVED)
    parser.add_argument("-t", dest="trial_short", type=str, default=None)
    known, _ = parser.parse_known_args(argv)
    if known.label_pull is not None:
        parser.add_argument("--word_embed_size", type=int, default=500)
        parser.add_argument("--word_embed_path", type=str,
                            default="word_embeds")
        parser.add_argument("--use_synonyms", action="store_true")
        parser.add_argument("--glove", action="store_true")
    ns = parser.parse_args(argv)
    d = {k: v for k, v in vars(ns).items() if k != "trial_short"}
    if ns.trial_short is not None:
        d["trial"] = ns.trial_short
    return SupervisedConfig(**d).finalize(make_dirs=make_dirs)
