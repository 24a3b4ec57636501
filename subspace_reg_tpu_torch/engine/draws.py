"""Random draws of the incremental engine and of pretraining.

The JAX engine draws at four points, each from a key made by a fixed
formula of ``set_seed`` and the session index (engine/incremental.py):

  * base-exemplar augmentation  ``set_seed*7919 + 17``       (:1348)
  * support augmentation         ``set_seed*100003 + idx``    (:1547)
  * head growth                  ``set_seed*61 + 1000 + idx`` (:1576)
  * dropout / DropBlock          ``set_seed*31 + idx``        (:1633)

The general-freeze path's epoch 1 (``freeze_backbone_at != 1``) hands the
support and the memory forward the same key (incremental.py:1025-1030),
where the compiled session splits it in two (:886): ``dropout_full``.

Pretraining draws once per step, from ``fold_in(PRNGKey(set_seed), step)``
split into an augmentation key and a dropout key (engine/pretrain.py:128);
the contrastive-distillation step splits it three ways (:279), the third
key drawing the (B, nce_k) uniforms that pick the negatives.

The port's engines take these from a draw provider.  ``TorchDraws`` seeds a
``torch.Generator`` from the same formulas; threefry's bits cannot be
reproduced, so it matches the JAX draws in distribution only
(docs/PARITY.md:70-77).  A test can pass any object with the same
methods, e.g. one that returns the numbers ``jax.random`` draws on the same
keys, and then holds the two engines to exact epoch counts (or, for
pretraining, to the same augmented batch).  ``dropout`` may return a
``torch.Generator`` or a callable ``(shape, device) -> uniforms``
(models/layers.py::uniform).

Each seed has its own provider: the multi-seed engine takes one per seed
(``per_seed``), as the JAX engine derives every key from that seed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..data.transforms import AugmentSpec
from ..models.head import torch_linear_init
from ..ops.augment import AugmentDraws


def base_augment_seed(set_seed: int) -> int:
    return set_seed * 7919 + 17


def support_augment_seed(set_seed: int, idx: int) -> int:
    return set_seed * 100003 + idx


def head_growth_seed(set_seed: int, idx: int) -> int:
    return set_seed * 61 + 1000 + idx


def dropout_seed(set_seed: int, idx: int) -> int:
    return set_seed * 31 + idx


def pretrain_augment_seed(set_seed: int, step: int) -> int:
    return (set_seed * 1000003 + step) * 2


def pretrain_dropout_seed(set_seed: int, step: int) -> int:
    return (set_seed * 1000003 + step) * 2 + 1


def pretrain_contrastive_seed(set_seed: int, step: int, part: int) -> int:
    """The contrastive step's three draws: ``part`` 0 augmentation, 1
    dropout, 2 the negatives' uniforms."""
    return (set_seed * 1000003 + step) * 3 + part


class TorchDraws:
    """Production draw provider: one ``torch.Generator`` per draw point,
    seeded from the JAX engine's key formulas, drawing on ``device``."""

    def __init__(self, set_seed: int, device):
        self.set_seed = set_seed
        self.device = torch.device(device)

    def _gen(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def _augment(self, seed: int, n: int, spec: AugmentSpec) -> AugmentDraws:
        g = self._gen(seed)
        kw = dict(generator=g, device=self.device)
        offsets = torch.randint(0, 2 * spec.padding + 1, (n, 2), **kw)
        flip = torch.rand((n,), **kw) < 0.5
        lo, hi = 1.0 - spec.color_jitter, 1.0 + spec.color_jitter
        factors = lo + (hi - lo) * torch.rand((n, 3), **kw)
        order = torch.argsort(torch.rand((n, 3), **kw), dim=1)
        return AugmentDraws(offsets=offsets, flip=flip,
                            jitter_factors=factors, jitter_order=order)

    def base_augment(self, n: int, spec: AugmentSpec) -> AugmentDraws:
        return self._augment(base_augment_seed(self.set_seed), n, spec)

    def support_augment(self, idx: int, n: int,
                        spec: AugmentSpec) -> AugmentDraws:
        return self._augment(support_augment_seed(self.set_seed, idx), n,
                             spec)

    def head_growth(self, idx: int, n_rows: int, in_dim: int,
                    with_bias: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """A fresh (n_rows, in_dim) torch.nn.Linear default init,
        U(-1/sqrt(in_dim), 1/sqrt(in_dim)), and the bias alike."""
        g = self._gen(head_growth_seed(self.set_seed, idx))
        return torch_linear_init(n_rows, in_dim, with_bias, g, self.device)

    def dropout(self, idx: int) -> torch.Generator:
        """The generator of session ``idx``'s train-mode forwards."""
        return self._gen(dropout_seed(self.set_seed, idx))

    def dropout_full(self, idx: int) -> Tuple[torch.Generator,
                                              torch.Generator]:
        """The general-freeze path's epoch 1: (support, memory) generators
        seeded alike, so both forwards draw from one key."""
        return (self._gen(dropout_seed(self.set_seed, idx)),
                self._gen(dropout_seed(self.set_seed, idx)))

    def pretrain_augment(self, step: int, n: int,
                         spec: AugmentSpec) -> AugmentDraws:
        """Pretraining step ``step``'s augmentation of ``n`` images."""
        return self._augment(pretrain_augment_seed(self.set_seed, step), n,
                             spec)

    def pretrain_dropout(self, step: int) -> torch.Generator:
        """The generator of pretraining step ``step``'s dropout and
        DropBlock."""
        return self._gen(pretrain_dropout_seed(self.set_seed, step))

    def pretrain_contrastive(self, step: int, n: int, spec: AugmentSpec,
                             nce_k: int) -> Tuple[AugmentDraws,
                                                  torch.Generator,
                                                  torch.Tensor]:
        """The contrastive step ``step``'s draws: the augmentation of
        ``n`` images, the dropout generator and (n, nce_k) uniforms in
        [0, 1) that pick the negatives."""
        seed = lambda part: pretrain_contrastive_seed(  # noqa: E731
            self.set_seed, step, part)
        u = torch.rand((n, nce_k), generator=self._gen(seed(2)),
                       device=self.device)
        return self._augment(seed(0), n, spec), self._gen(seed(1)), u


def per_seed(seeds: Sequence[int], device, draws=None) -> List:
    """One draw provider per seed: ``draws`` when given (one per seed),
    else a ``TorchDraws`` for each."""
    if draws is None:
        return [TorchDraws(seed, device) for seed in seeds]
    draws = list(draws)
    if len(draws) != len(seeds):
        raise ValueError(f"{len(draws)} draw providers for {len(seeds)} "
                         "seeds")
    return draws
