"""Low-level readers for the reference's on-disk formats."""

from __future__ import annotations

import pickle


_latin1_cache: dict = {}


def load_pickle_latin1(path: str):
    """The reference loads its dataset pickles with latin1 decoding
    (dataset/mini_imagenet.py:62, dataset/cifar.py:53).

    Cached by (absolute path, mtime): the seed fan-out loads the same
    ~250MB all.pickle 3x per seed, and unpickling dominates its host-side
    setup.  Callers must not mutate the returned arrays (none do — the
    split/transform pipeline is functional; continual_split's fancy
    indexing copies).
    """
    import os
    key = (os.path.abspath(path), os.path.getmtime(path))
    if key not in _latin1_cache:
        while len(_latin1_cache) >= 3:   # continual uses 1 file; the
            _latin1_cache.pop(next(iter(_latin1_cache)))  # category split 3
        with open(path, "rb") as f:
            _latin1_cache[key] = pickle.load(f, encoding="latin1")
    return _latin1_cache[key]


def load_labels_pkl(path: str):
    """tieredImageNet label pickles, with the latin1 fallback the reference
    uses (dataset/tiered_imagenet.py:110-121)."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:
        with open(path, "rb") as f:
            u = pickle._Unpickler(f)
            u.encoding = "latin1"
            return u.load()
