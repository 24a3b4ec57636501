"""Synthetic miniImageNet in the reference's on-disk format.

Generates a miniature ``all.pickle`` + ``class_labels.txt`` so the FSCIL
pipeline runs end-to-end without the real miniImageNet dump, and the
category-split pickles that non-continual pretraining reads, and the
word-embedding pickle the semantic attractors read.  Formats match
dataset/mini_imagenet.py:52-65,127-136.  Byte-identical to the JAX
package's ``data/synthetic.py::make_mini_imagenet``,
``make_mini_imagenet_category_split`` and ``make_word_embeds`` for the same
arguments.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def make_mini_imagenet(root: str, n_classes: int = 100, per_class: int = 20,
                       img_size: int = 84, seed: int = 0) -> None:
    os.makedirs(root, exist_ok=True)
    r = np.random.RandomState(seed)
    n = n_classes * per_class
    labels = np.repeat(np.arange(n_classes), per_class)
    # images carry a class-dependent mean so models can actually learn
    base_colors = r.randint(30, 226, size=(n_classes, 3))
    imgs = (base_colors[labels][:, None, None, :]
            + r.randint(-25, 26, size=(n, img_size, img_size, 3)))
    imgs = np.clip(imgs, 0, 255).astype(np.uint8)
    catname2label = {f"n{900000 + i:08d}": i for i in range(n_classes)}
    with open(os.path.join(root, "all.pickle"), "wb") as f:
        pickle.dump({"data": imgs, "labels": labels.tolist(),
                     "catname2label": catname2label}, f)
    with open(os.path.join(root, "class_labels.txt"), "w") as f:
        for cat, lbl in catname2label.items():
            f.write(f"{cat} synthetic_{lbl}\n")


def make_mini_imagenet_category_split(root: str, per_class: int = 20,
                                      img_size: int = 84, seed: int = 0,
                                      n_train: int = 64, n_val: int = 16,
                                      n_test: int = 20) -> None:
    """Non-continual category-split pickles (the RFS layout the reference
    loads when --continual is off, dataset/mini_imagenet.py:56-58): train
    phases carry classes 0..n_train-1; val/test carry globally numbered
    disjoint classes, as the published pickles do."""
    os.makedirs(root, exist_ok=True)
    r = np.random.RandomState(seed)
    total = n_train + n_val + n_test
    base_colors = r.randint(30, 226, size=(total, 3))

    def blob(classes, per):
        labels = np.repeat(classes, per)
        imgs = (base_colors[labels][:, None, None, :]
                + r.randint(-25, 26, size=(len(labels), img_size,
                                           img_size, 3)))
        return np.clip(imgs, 0, 255).astype(np.uint8), labels.tolist()

    def dump(name, classes, per):
        imgs, labels = blob(classes, per)
        cat2label = {f"n{900000 + i:08d}": int(i) for i in classes}
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump({"data": imgs, "labels": labels,
                         "catname2label": cat2label}, f)

    train_cls = np.arange(n_train)
    for phase in ("train", "val", "test"):
        dump(f"miniImageNet_category_split_train_phase_{phase}.pickle",
             train_cls, per_class)
    dump("miniImageNet_category_split_val.pickle",
         np.arange(n_train, n_train + n_val), per_class)
    dump("miniImageNet_category_split_test.pickle",
         np.arange(n_train + n_val, total), per_class)
    with open(os.path.join(root, "class_labels.txt"), "w") as f:
        for i in range(total):
            f.write(f"n{900000 + i:08d} synthetic_{i}\n")


def make_word_embeds(path: str, dataset: str = "miniImageNet",
                     dim: int = 500, n_classes: int = 100,
                     seed: int = 1) -> str:
    """Word-embedding pickle: {word: np.ndarray(dim)} covering the synthetic
    vocabulary ('synthetic', '<i>')."""
    os.makedirs(path, exist_ok=True)
    r = np.random.RandomState(seed)
    words = {"synthetic": r.randn(dim)}
    for i in range(n_classes):
        words[str(i)] = r.randn(dim)
    out = os.path.join(path, f"{dataset}_dim{dim}.pickle")
    with open(out, "wb") as f:
        pickle.dump(words, f)
    return out
