"""Alias-method O(1) multinomial sampling (reference
distill/alias_multinomial.py:4-63).

Counterpart of ``subspace_reg_tpu/distill/alias.py``: the tables are
built on the host in float64 exactly as the JAX sampler builds them, then
held as a float32 acceptance table and an integer alias table; a draw is
one vectorized randint + uniform + select on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def alias_tables(probs) -> tuple:
    """(acceptance probabilities, aliases) of ``probs`` in float64 /
    int64, by the JAX sampler's construction order."""
    probs = np.asarray(probs, np.float64)
    probs = probs / probs.sum()
    k = len(probs)
    prob = np.zeros(k)
    alias = np.zeros(k, np.int64)
    smaller, larger = [], []
    scaled = probs * k
    for i, p in enumerate(scaled):
        prob[i] = p
        (smaller if p < 1.0 else larger).append(i)
    while smaller and larger:
        small = smaller.pop()
        large = larger.pop()
        alias[small] = large
        prob[large] = (prob[large] - 1.0) + prob[small]
        (smaller if prob[large] < 1.0 else larger).append(large)
    for i in smaller + larger:
        prob[i] = 1.0
    return prob, alias


class AliasSampler:
    """Samples ~ multinomial(``probs``) on ``device``."""

    def __init__(self, probs, device="cuda"):
        prob, alias = alias_tables(probs)
        self.k = len(prob)
        self.prob = torch.as_tensor(prob.astype(np.float32), device=device)
        self.alias = torch.as_tensor(alias, device=device)

    def draw(self, generator: torch.Generator,
             shape: Sequence[int]) -> torch.Tensor:
        """Samples of ``shape`` from ``generator`` (on the tables'
        device)."""
        dev = self.prob.device
        j = torch.randint(0, self.k, tuple(shape), generator=generator,
                          device=dev)
        u = torch.rand(tuple(shape), generator=generator, device=dev)
        return self.draw_from(j, u)

    def draw_from(self, j: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """The samples for given column draws ``j`` (integers in [0, k))
        and acceptance uniforms ``u`` in [0, 1): ``j`` where
        ``u < prob[j]``, else ``alias[j]``."""
        j = j.long()
        return torch.where(u < self.prob[j], j, self.alias[j])
