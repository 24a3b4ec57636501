"""The benchmark's random draws, made from the seed and handed alike to the
program (through the port's draw-provider protocol) and to the reference.

Every draw point has a ``torch.Generator`` of its own on the device,
seeded from (seed, point, index), so a draw can be made again anywhere:
the reference asks for the same draw and gets the same numbers.  The raw
draws are plain tensors; ``ProgramDraws`` wraps them in the port's types.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

# draw points
BASE_AUGMENT, SUPPORT_AUGMENT, HEAD_GROWTH, DROPOUT = 1, 2, 3, 4
PRETRAIN_AUGMENT, PRETRAIN_DROPOUT = 5, 6

_MASK = (1 << 63) - 1


def point_seed(seed: int, point: int, index: int) -> int:
    """A 63-bit generator seed for draw ``point`` number ``index``."""
    x = (seed * 0x9E3779B97F4A7C15 + point * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB) & _MASK
    x ^= x >> 31
    return (x * 0xD6E8FEB86659FD93) & _MASK


def generator(seed: int, point: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(point_seed(seed, point, index))
    return g


def augment_draws(seed: int, point: int, index: int, n: int, padding: int,
                  jitter: float, device) -> Dict[str, torch.Tensor]:
    """torchvision's RandomCrop(padding) + RandomHorizontalFlip +
    ColorJitter draws for ``n`` images: offsets (n, 2) int64 in [0, 2p],
    flip (n,) bool, jitter factors (n, 3) in [1 - j, 1 + j] and a
    per-image order of the three jitter operations (n, 3)."""
    g = generator(seed, point, index, device)
    kw = dict(generator=g, device=device)
    offsets = torch.randint(0, 2 * padding + 1, (n, 2), **kw)
    flip = torch.rand((n,), **kw) < 0.5
    lo, hi = 1.0 - jitter, 1.0 + jitter
    factors = lo + (hi - lo) * torch.rand((n, 3), **kw)
    order = torch.argsort(torch.rand((n, 3), **kw), dim=1)
    return {"offsets": offsets, "flip": flip, "factors": factors,
            "order": order}


def linear_init(seed: int, index: int, n_rows: int, in_dim: int,
                with_bias: bool, device
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """torch.nn.Linear's default init, U(-1/sqrt(in), 1/sqrt(in)), of a
    fresh (n_rows, in_dim) block and its bias."""
    g = generator(seed, HEAD_GROWTH, index, device)
    k = 1.0 / math.sqrt(in_dim)
    w = torch.empty((n_rows, in_dim), device=device).uniform_(
        -k, k, generator=g)
    b = None
    if with_bias:
        b = torch.empty((n_rows,), device=device).uniform_(-k, k, generator=g)
    return w, b


class ProgramDraws:
    """The port's draw-provider protocol (``engine/draws.py``) over the
    benchmark's draws: the evaluation's four draw points and the
    pretraining step's two."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)

    def _augment(self, point: int, index: int, n: int, spec):
        from subspace_reg_tpu_torch.ops.augment import AugmentDraws
        d = augment_draws(self.seed, point, index, n, spec.padding,
                          spec.color_jitter, self.device)
        return AugmentDraws(offsets=d["offsets"], flip=d["flip"],
                            jitter_factors=d["factors"],
                            jitter_order=d["order"])

    def base_augment(self, n: int, spec):
        return self._augment(BASE_AUGMENT, 0, n, spec)

    def support_augment(self, idx: int, n: int, spec):
        return self._augment(SUPPORT_AUGMENT, idx, n, spec)

    def head_growth(self, idx: int, n_rows: int, in_dim: int,
                    with_bias: bool):
        return linear_init(self.seed, idx, n_rows, in_dim, with_bias,
                           self.device)

    def dropout(self, idx: int) -> torch.Generator:
        return generator(self.seed, DROPOUT, idx, self.device)

    def pretrain_augment(self, step: int, n: int, spec):
        return self._augment(PRETRAIN_AUGMENT, step, n, spec)

    def pretrain_dropout(self, step: int) -> torch.Generator:
        return generator(self.seed, PRETRAIN_DROPOUT, step, self.device)
