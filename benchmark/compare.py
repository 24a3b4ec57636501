"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out from the same inputs.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import torch


def rel_max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b| (b is the reference); 0 for two empty or
    zero tensors, inf for a shape mismatch or a non-finite value."""
    if a.shape != b.shape:
        return float("inf")
    a, b = a.detach().double(), b.detach().double().to(a.device)
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return float("inf")
    scale = float(b.abs().max()) if b.numel() else 0.0
    diff = float((a - b).abs().max()) if a.numel() else 0.0
    if scale == 0.0:
        return 0.0 if diff == 0.0 else float("inf")
    return diff / scale


def worst_leaf_norm_gap(prog: Dict[str, torch.Tensor],
                        ref: Dict[str, torch.Tensor],
                        counted: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, |‖p‖ - ‖r‖|, over the larger of the reference's norm of
    that leaf and of the median leaf.  ``counted`` limits the leaves."""
    keys = list(ref) if counted is None else list(counted)
    if not keys:
        return float("inf")
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = statistics.median(rn.values())
    worst = 0.0
    for k in keys:
        if k not in prog:
            return float("inf")
        pn = float(prog[k].double().norm())
        if pn != pn:
            return float("inf")
        worst = max(worst, abs(pn - rn[k]) / max(rn[k], med, 1e-30))
    return worst


def moving_leaves(ref_grad: Dict[str, torch.Tensor],
                  share: float = 1e-3):
    """The leaves whose reference gradient norm is at least ``share`` of
    the median leaf's: the others move by round-off alone and are left
    out of the comparison of the change."""
    norms = {k: float(v.double().norm()) for k, v in ref_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= share * med]
