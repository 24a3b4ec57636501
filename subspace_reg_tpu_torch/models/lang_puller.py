"""Subspace attractor and pull loss (reference models/resnet_language.py:89-97).

Only the pieces the golden subspace-reg path uses are ported here; the
semantic (word-embedding) and mapping attractors are ROADMAP.md queue A
items.
"""

from __future__ import annotations

from typing import Optional

import torch


def pull_loss(gamma: float, inspired: torch.Tensor, weights: torch.Tensor,
              row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gamma * ||inspired - weights||^2 — SQUARED norm (reference loss1)."""
    d = inspired - weights
    if row_mask is not None:
        d = d * row_mask[:, None]
    return gamma * torch.sum(d * d)


def projected_weight(base_weight: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Project ``weights`` onto span(base rows): thin QR of W_base^T, then
    (W @ Q / colnorm(Q)) @ Q^T (reference get_projected_weight, :92-97).
    The column-norm division is a numerical no-op kept for faithfulness."""
    q, _ = torch.linalg.qr(base_weight.T)           # (640, n_base)
    mut = weights @ q                               # (k, n_base)
    colnorm = torch.linalg.norm(q.T, dim=1)         # == 1.0 per column
    return (mut / colnorm[None, :]) @ q.T
