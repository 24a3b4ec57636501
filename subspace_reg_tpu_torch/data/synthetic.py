"""Synthetic miniImageNet in the reference's on-disk format.

Generates a miniature ``all.pickle`` + ``class_labels.txt`` so the FSCIL
pipeline runs end-to-end without the real miniImageNet dump.  Formats match
dataset/mini_imagenet.py:52-65,127-136.  Byte-identical to the JAX package's
``data/synthetic.py::make_mini_imagenet`` for the same arguments.
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
