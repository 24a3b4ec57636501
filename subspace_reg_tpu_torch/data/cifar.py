"""CIFAR-FS / FC100 loading (reference dataset/cifar.py:13-107), the port's
copy of the JAX package's ``data/cifar.py``.

Per-partition pickles with the sparse->dense label remap (:52-66), and the
multi-session continual protocol over an ``all.pickle`` (the miniImageNet
split's np.random sequence, 400/50 images a base class).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .mini_imagenet import SplitData, continual_split
from .pickles import load_pickle_latin1


def load_cifar(opt, partition: str = "train") -> SplitData:
    data = load_pickle_latin1(
        os.path.join(opt.data_root, f"{partition}.pickle"))
    imgs = data["data"]
    labels = data["labels"]

    # sparse labels to 0..n in order of first appearance (cifar.py:56-66)
    label2label = {}
    for label in labels:
        if label not in label2label:
            label2label[label] = len(label2label)
    new_labels = [label2label[label] for label in labels]

    n_classes = max(new_labels) + 1
    label2human = [f"class {i}" for i in range(n_classes)]
    if "catname2label" in data:
        inv = {}
        for k, v in data["catname2label"].items():
            if v in label2label:
                inv[label2label[v]] = str(k).lower().replace("_", " ")
        label2human = [inv.get(i, f"class {i}") for i in range(n_classes)]

    return SplitData(imgs=imgs, labels=new_labels, cat2label={},
                     label2human=label2human)


def load_cifar_continual(opt, split: str = "train",
                         phase: Optional[str] = None,
                         train_per_class: int = 400,
                         val_per_class: int = 50,
                         lazy: bool = False) -> SplitData:
    """The 60/40 continual protocol on CIFAR-100's ``all.pickle``
    ({'data', 'labels', 'catname2label'}); CIFAR-100 has 500 training
    images a class, hence 400/50/50.  ``lazy=True`` returns the images as
    a ``LazyRows`` view over the shared pickle-cached array."""
    np.random.seed(opt.set_seed)
    data = load_pickle_latin1(os.path.join(opt.data_root, "all.pickle"))
    cat2label = dict(data.get("catname2label", {}))
    imgs, labels, cat2label, basec_map = continual_split(
        data["data"], data["labels"], cat2label, split, phase,
        train_per_class, val_per_class, lazy=lazy)

    n_classes = 100
    label2human = [""] * n_classes
    labels_path = os.path.join(opt.data_root, "class_labels.txt")
    if os.path.exists(labels_path):
        with open(labels_path, "r") as f:
            for line in f.readlines():
                catname, humanname = line.strip().lower().split(" ")
                humanname = " ".join(humanname.split("_"))
                if catname in cat2label:
                    label2human[cat2label[catname]] = humanname
    else:
        for k, v in cat2label.items():
            label2human[v] = str(k).lower().replace("_", " ")
    return SplitData(imgs=imgs, labels=labels, cat2label=cat2label,
                     label2human=label2human, basec_map=basec_map)
