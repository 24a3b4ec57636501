"""Label-embedding reader (the port's copy of the JAX package's
``models/embeds.py``).

``get_embeds`` reproduces reference models/util.py:50-67 exactly, including
its quirk: a KeyError on any word of a multi-word label RESETS the
accumulated sum to a zero vector (rather than skipping the word).  The
assets are plain pickles ``{word: np.ndarray(dim)}``.
"""

from __future__ import annotations

import pickle
from typing import List, Sequence

import numpy as np


def load_embed_pickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def get_embeds(embed_pth: str, vocab: Sequence[str],
               dim: int = 500) -> np.ndarray:
    """Per-label embedding: mean of per-word vectors, zero on OOV.  Returns
    float64 (n_labels, dim); callers cast to float32."""
    embeds_ = load_embed_pickle(embed_pth)
    embeds: List = [0] * len(vocab)
    for i, token in enumerate(vocab):
        words = token.split(" ")
        for w in words:
            try:
                embeds[i] += embeds_[w]
            except KeyError:
                embeds[i] = np.zeros(dim)
        embeds[i] /= len(words)
    return np.stack([np.asarray(e) for e in embeds], 0)
