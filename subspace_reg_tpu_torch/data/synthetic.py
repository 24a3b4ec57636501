"""Synthetic datasets in the reference's on-disk formats.

Miniature miniImageNet (``all.pickle`` + ``class_labels.txt``, and the
category-split pickles that non-continual pretraining reads), CIFAR-FS /
FC100 (per-partition pickles and an ``all.pickle``), tieredImageNet (npz
archives and label pickles), and the word- and description-embedding
pickles the semantic attractors read, so every pipeline runs end to end
without the real dumps.  Formats match dataset/mini_imagenet.py:52-65,
127-136, dataset/cifar.py:52-66 and dataset/tiered_imagenet.py:42-56.
Each generator writes the bytes of its namesake in the JAX package's
``data/synthetic.py`` for the same arguments.
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


def make_cifar(root: str, n_classes: int = 100, per_class: int = 20,
               seed: int = 0, partitions=("train", "val", "test"),
               sparse_labels: bool = False) -> None:
    """Per-partition pickles + an all.pickle for the continual protocol
    (schemas of dataset/cifar.py:52-66), 32 px."""
    os.makedirs(root, exist_ok=True)
    r = np.random.RandomState(seed)
    base_colors = r.randint(30, 226, size=(n_classes, 3))

    def blob(classes, per, sparse=False):
        labels = np.repeat(classes, per)
        if sparse:
            labels = labels * 3 + 1   # sparse labels needing remap
        n = len(labels)
        imgs = (base_colors[np.repeat(classes, per)][:, None, None, :]
                + r.randint(-25, 26, size=(n, 32, 32, 3)))
        return (np.clip(imgs, 0, 255).astype(np.uint8), labels.tolist())

    per_part = max(n_classes // len(partitions), 1)
    for i, part in enumerate(partitions):
        classes = np.arange(i * per_part, min((i + 1) * per_part, n_classes))
        imgs, labels = blob(classes, per_class, sparse=sparse_labels)
        with open(os.path.join(root, f"{part}.pickle"), "wb") as f:
            pickle.dump({"data": imgs, "labels": labels}, f)

    # all.pickle (continual protocol) always carries dense 0..n-1 labels
    imgs, labels = blob(np.arange(n_classes), per_class)
    cat2label = {f"cifar{i:03d}": i for i in range(n_classes)}
    with open(os.path.join(root, "all.pickle"), "wb") as f:
        pickle.dump({"data": imgs, "labels": labels,
                     "catname2label": cat2label}, f)


def make_tiered(root: str, n_classes: int = 20, per_class: int = 12,
                img_size: int = 16, seed: int = 0,
                with_train_b: bool = True) -> None:
    """npz image archives + label pickles (schemas of
    dataset/tiered_imagenet.py:42-56): ``n_classes`` train_a classes in
    three phases, and ``n_classes // 2`` classes each in ``train_b``,
    ``val`` and ``test``.  A class's phases share its colour; the
    partitions, class-disjoint in the real set, get rows of their own."""
    os.makedirs(root, exist_ok=True)
    r = np.random.RandomState(seed)
    palette = r.randint(30, 226, size=(n_classes * 3, 3))

    def write(prefix, classes, palette_off=0):
        labels = np.repeat(classes, per_class)
        base = palette[np.asarray(classes) + palette_off]
        imgs = (base[np.repeat(np.arange(len(classes)), per_class)]
                [:, None, None, :]
                + r.randint(-25, 26,
                            size=(len(labels), img_size, img_size, 3)))
        np.savez(os.path.join(root, f"{prefix}_images.npz"),
                 images=np.clip(imgs, 0, 255).astype(np.uint8))
        with open(os.path.join(root, f"{prefix}_labels.pkl"), "wb") as f:
            pickle.dump({"label_specific": labels % len(classes)}, f)

    for phase in ("train", "val", "test"):
        write(f"train_a_train_a_phase_{phase}", np.arange(n_classes))
    half = n_classes // 2
    if with_train_b:
        write("train_b", np.arange(half), palette_off=n_classes)
    write("val", np.arange(half), palette_off=n_classes + half)
    write("test", np.arange(half), palette_off=n_classes + 2 * half)


def make_description_embeds(path: str, dataset: str = "miniImageNet",
                            model: str = "bert-base-cased", layer: int = 6,
                            prefix: bool = True, dim: int = 768,
                            n_classes: int = 100, seed: int = 2) -> str:
    """Description-embed pickle in the reference asset schema:
    {full class name: np.ndarray(dim)} under the util.py:95-99 filename;
    class names follow class_labels.txt ('synthetic <i>')."""
    os.makedirs(path, exist_ok=True)
    r = np.random.RandomState(seed)
    d = {f"synthetic {i}": r.randn(dim) for i in range(n_classes)}
    out = os.path.join(
        path, f"{dataset}_{model}_layer{layer}_prefix_{prefix}.pickle")
    with open(out, "wb") as f:
        pickle.dump(d, f)
    return out


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
