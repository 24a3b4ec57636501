"""tieredImageNet loading (reference dataset/tiered_imagenet.py:9-122), the
port's copy of the JAX package's ``data/tiered_imagenet.py``.

npz image archives plus pickled ``label_specific`` labels.  The pretraining
layout is ``train_a_train_a_phase_{train,val,test}``; the ``train``,
``val`` and ``test`` partitions are class-disjoint archives of their own.
``--augment_pretrain_wtrainb`` pools ``train_b`` into 351-class training
(:58-67).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .mini_imagenet import SplitData
from .pickles import load_labels_pkl

# npz images by (abspath, mtime): the seeds of a fan-out read the same
# seed-independent archives, which then share one host array
_npz_cache: dict = {}


def _load_npz_images(path: str) -> np.ndarray:
    key = (os.path.abspath(path), os.path.getmtime(path))
    if key not in _npz_cache:
        while len(_npz_cache) >= 3:   # train/val phases + train_b
            _npz_cache.pop(next(iter(_npz_cache)))
        _npz_cache[key] = np.load(path)["images"]
    return _npz_cache[key]


def load_tiered_imagenet(opt, partition: str = "train",
                         phase: Optional[str] = None,
                         pretrain: bool = True) -> SplitData:
    if pretrain:
        word = phase or partition
        stem = f"train_a_train_a_phase_{word}"
    else:
        stem = partition
    imgs = _load_npz_images(os.path.join(opt.data_root,
                                         f"{stem}_images.npz"))
    label_data = load_labels_pkl(os.path.join(opt.data_root,
                                              f"{stem}_labels.pkl"))
    labels = np.asarray(label_data["label_specific"])

    # pool train_b for 351-class pretraining (tiered_imagenet.py:58-67)
    if pretrain and partition == "train" and (phase in (None, "train")) \
            and getattr(opt, "augment_pretrain_wtrainb", False):
        second_imgs = np.load(
            os.path.join(opt.data_root, "train_b_images.npz"))["images"]
        second_labels = load_labels_pkl(
            os.path.join(opt.data_root, "train_b_labels.pkl"))["label_specific"]
        num_classes = int(np.max(labels)) + 1
        labels = np.concatenate(
            (labels, num_classes + np.asarray(second_labels)), axis=0)
        imgs = np.concatenate((imgs, second_imgs), axis=0)

    # human-readable labels if the pickle carries them, else synthesized
    n_classes = int(np.max(labels)) + 1
    if "label_specific_str" in label_data:
        names = list(label_data["label_specific_str"])
        label2human = [str(n).lower().replace("_", " ") for n in names]
        label2human += [""] * (n_classes - len(label2human))
    else:
        label2human = [f"class {i}" for i in range(n_classes)]

    return SplitData(imgs=imgs, labels=labels.tolist(), cat2label={},
                     label2human=label2human)
