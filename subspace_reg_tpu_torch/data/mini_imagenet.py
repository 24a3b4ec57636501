"""miniImageNet loading + the continual (multi-session) class split.

The split protocol is the reproducibility contract of the whole FSCIL
pipeline; the np.random call sequence below matches the reference
bit-for-bit (dataset/mini_imagenet.py:30,70-126):

  seed(set_seed)
  shuffle(arange(100))                -> 60 sorted base classes, 40 novel
  [train split] gather base sample indices, shuffle them, partition into
  500/class train | 50/class val | rest test (pooled indices, not
  per-class!), then relabel base classes to 0..59 via ``basec_map``.

No torch, no PIL: images stay uint8 numpy until they hit the device
augmentation ops.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .pickles import load_pickle_latin1

N_TOTAL_CLASSES = 100
N_BASE_CLASSES = 60
TRAIN_PER_CLASS = 500   # reference hardcodes 500/50 (mini_imagenet.py:85)
VAL_PER_CLASS = 50


class LazyRows:
    """A row-gather view ``full[sel]`` that defers the copy.

    The continual split's eager gather materializes ~1.1GB of fresh pages
    per seed (train 500/class + the whole novel split), which dominates
    multi-seed fan-out setup — and none of it is needed: episode
    composition touches a few hundred rows per session, and the engine
    stages images in device HBM and gathers there.  ``LazyRows`` keeps
    the shared pickle-cached array (``full``) plus the split's index
    vector (``sel``); row access composes through ``sel`` (a view for
    scalar indices), and the engine recognizes the type to stage ``full``
    ONCE for every seed and group, turning per-seed splits into index
    arithmetic.  ``np.asarray`` materializes, so eager consumers still
    work.
    """

    __slots__ = ("full", "sel")

    def __init__(self, full: np.ndarray, sel: np.ndarray):
        self.full = full
        self.sel = np.asarray(sel)

    @property
    def shape(self):
        return (len(self.sel),) + self.full.shape[1:]

    @property
    def dtype(self):
        return self.full.dtype

    @property
    def ndim(self):
        return self.full.ndim

    def __len__(self):
        return len(self.sel)

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self.full[int(self.sel[i])]      # view, no copy
        if isinstance(i, tuple):                    # e.g. imgs[ids, :]
            return self.full[self.sel[i[0]]][(slice(None),) + i[1:]]
        return self.full[self.sel[i]]               # slice / index array

    def __array__(self, dtype=None, copy=None):
        out = self.full[self.sel]
        return out if dtype is None else out.astype(dtype)


@dataclass
class SplitData:
    """One loaded split: uint8 images + integer labels + vocab metadata."""

    imgs: np.ndarray                      # (N, H, W, 3) uint8
    labels: List[int]
    cat2label: Dict[str, int]
    label2human: List[str]
    basec_map: Optional[Dict[int, int]] = None   # base class -> 0..59
    global_labels: List[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.global_labels:
            self.global_labels = list(self.labels)

    def __len__(self):
        return len(self.labels)

    def test_item(self, i: int):
        """(uint8 image, 0-based target) — reference __getitem__ subtracts
        min(labels) (mini_imagenet.py:168)."""
        target = self.labels[i] - min(self.labels)
        return self.imgs[i], target


def _read_label2human(data_root: str, cat2label: Dict[str, int],
                      n_classes: int = N_TOTAL_CLASSES) -> List[str]:
    """class_labels.txt: '<wnid> <human_name_with_underscores>'
    (reference mini_imagenet.py:127-136)."""
    label2human = [""] * n_classes
    path = os.path.join(data_root, "class_labels.txt")
    with open(path, "r") as f:
        for line in f.readlines():
            catname, humanname = line.strip().lower().split(" ")
            humanname = " ".join(humanname.split("_"))
            if catname in cat2label:
                label2human[cat2label[catname]] = humanname
    return label2human


def load_mini_imagenet(opt, split: str = "train",
                       phase: Optional[str] = None,
                       train_per_class: int = TRAIN_PER_CLASS,
                       val_per_class: int = VAL_PER_CLASS,
                       lazy: bool = False) -> SplitData:
    """Load miniImageNet with the reference's RNG-exact continual split.

    ``lazy=True`` returns the continual split's images as a ``LazyRows``
    view over the shared pickle-cached array instead of a gathered copy
    (identical content; the np.random call sequence is unchanged).  Used
    by the multi-seed fan-out, where per-seed gathered copies dominate
    setup time and defeat cross-seed device staging.
    """
    np.random.seed(opt.set_seed)

    if opt.continual:
        file_pattern = "all.pickle"
    else:
        if split == "train":
            file_pattern = f"miniImageNet_category_split_train_phase_{phase}.pickle"
        else:
            file_pattern = f"miniImageNet_category_split_{split}.pickle"

    data = load_pickle_latin1(os.path.join(opt.data_root, file_pattern))
    imgs = data["data"]
    labels = list(data["labels"])
    cat2label = dict(data["catname2label"])
    basec_map = None

    if opt.continual:
        imgs, labels, cat2label, basec_map = continual_split(
            imgs, data["labels"], cat2label, split, phase,
            train_per_class, val_per_class, lazy=lazy)

    label2human = _read_label2human(opt.data_root, cat2label)
    return SplitData(imgs=imgs, labels=labels, cat2label=cat2label,
                     label2human=label2human, basec_map=basec_map)


def continual_split(imgs, labels, cat2label, split: str, phase: Optional[str],
                    train_per_class: int, val_per_class: int,
                    n_total: int = N_TOTAL_CLASSES,
                    n_base: int = N_BASE_CLASSES,
                    lazy: bool = False):
    """The multi-session class/sample split with the reference's exact
    np.random call sequence (dataset/mini_imagenet.py:70-126): assumes
    np.random was just seeded with set_seed.  Shared by the miniImageNet
    and (beyond the reference) CIFAR continual protocols."""
    raw_labels = list(labels)
    all_classes = np.arange(n_total)
    np.random.shuffle(all_classes)
    basec = np.sort(all_classes[:n_base])
    basec_map = dict(zip(basec.tolist(), range(len(basec))))
    valc = all_classes[n_base:]

    if split == "train":
        base_samples = [i for i, e in enumerate(raw_labels) if e in basec]
        np.random.shuffle(base_samples)
        nbc = len(basec)
        n_tr, n_val = train_per_class * nbc, val_per_class * nbc
        parts = {
            "train": np.array(base_samples[:n_tr]),
            "val": np.array(base_samples[n_tr:n_tr + n_val]),
            "test": np.array(base_samples[n_tr + n_val:]),
        }
        if phase not in parts:
            raise ValueError(f"Phase {phase} is unrecognized for split train.")
        sel = parts[phase]
        new_labels = [basec_map[raw_labels[i]] for i in sel]
        imgs = LazyRows(imgs, sel) if lazy else imgs[sel, :]
        cat2label = {k: basec_map[v] for k, v in cat2label.items()
                     if v in basec_map}
        return imgs, new_labels, cat2label, basec_map
    if split == "val":
        valc_set = set(valc.tolist())
        sel = np.array([i for i, e in enumerate(raw_labels)
                        if e in valc_set])
        new_labels = [raw_labels[i] for i in sel]
        imgs = LazyRows(imgs, sel) if lazy else imgs[sel, :]
        cat2label = {k: v for k, v in cat2label.items() if v in valc_set}
        return imgs, new_labels, cat2label, basec_map
    raise ValueError(f"No such split as {split}.")
