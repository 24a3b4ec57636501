"""Optimizers: the fine-tune optimizer (reference eval/util.py:92-102) and
the pretraining optimizers with their learning-rate schedules.

``torch.optim.SGD`` couples weight decay into the gradient before the
momentum accumulation and seeds the momentum buffer with the first (decayed)
gradient; ``torch.optim.Adam`` couples decay the same way.  The reference's
Adam branch hard-codes a weight decay of 5e-4 whatever ``--weight_decay``
says (the JAX engine mirrors this at incremental.py:245-246).

The engine takes the first step itself and hands the optimizer state to the
fused loop (K1), which takes every later step with the same update rule, so
the optimizer is a set of hyperparameters plus that update (``step``; the
tracked path takes it one epoch at a time) rather than a
``torch.optim.Optimizer``.  The general-freeze path's backbone epochs use
``sgd_torch`` / ``adam_torch`` over the backbone and the head.

Pretraining uses ``torch.optim.SGD`` / ``Adam`` themselves (``sgd_torch``,
``adam_torch``): the JAX package's optax chains (utils/optim.py:21-43) were
built to reproduce exactly these.  The schedules are per-step functions of
the epoch, as in the JAX package (utils/optim.py:54-84); the caller sets
the learning rate of step ``s`` (0-based) to ``schedule(s)`` before it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

ADAM_WEIGHT_DECAY = 0.0005
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class OptimSpec:
    adam: bool
    lr: float
    weight_decay: float
    momentum: float
    b1: float = ADAM_BETAS[0]
    b2: float = ADAM_BETAS[1]
    eps: float = ADAM_EPS

    def first_step(self, params: Tree, grads: Tree
                   ) -> Tuple[Tree, Tree, Optional[Tree]]:
        """Step 1 from zero state, torch semantics: returns (params,
        momentum or Adam m, Adam v or None).  The momentum buffer is the
        first decayed gradient."""
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        return self.step(params, grads, zeros, zeros if self.adam else None,
                         1)

    def step(self, params: Tree, grads: Tree, mom: Tree,
             nu: Optional[Tree], t: int
             ) -> Tuple[Tree, Tree, Optional[Tree]]:
        """Step ``t`` (1-based) from the state of step ``t - 1``, the
        update K1 takes every epoch: coupled decay, then SGD-momentum or
        Adam with bias correction; returns (params, mom, nu)."""
        g = {k: grads[k] + self.weight_decay * params[k] for k in params}
        if not self.adam:
            mom = {k: self.momentum * mom[k] + g[k] for k in g}
            return {k: params[k] - self.lr * mom[k] for k in params}, mom, None
        mom = {k: self.b1 * mom[k] + (1.0 - self.b1) * g[k] for k in g}
        nu = {k: self.b2 * nu[k] + (1.0 - self.b2) * g[k] * g[k] for k in g}
        c1, c2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        new = {k: params[k] - self.lr * (mom[k] / c1)
               / (torch.sqrt(nu[k] / c2) + self.eps) for k in params}
        return new, mom, nu


def get_optim(opt) -> OptimSpec:
    """Reference eval/util.py:92-102: SGD with ``--weight_decay`` and
    ``--momentum``, or Adam with its hard-coded weight decay."""
    if opt.adam:
        return OptimSpec(adam=True, lr=opt.learning_rate,
                         weight_decay=ADAM_WEIGHT_DECAY, momentum=0.0)
    return OptimSpec(adam=False, lr=opt.learning_rate,
                     weight_decay=opt.weight_decay, momentum=opt.momentum)


Schedule = Callable[[int], float]


def sgd_torch(params: Iterable[torch.Tensor], learning_rate: float,
              momentum: float = 0.0, weight_decay: float = 0.0
              ) -> torch.optim.SGD:
    """Coupled weight decay, then momentum seeded with the first decayed
    gradient (JAX ``sgd_torch``)."""
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                           weight_decay=weight_decay)


def adam_torch(params: Iterable[torch.Tensor], learning_rate: float,
               weight_decay: float = 0.0, b1: float = ADAM_BETAS[0],
               b2: float = ADAM_BETAS[1], eps: float = ADAM_EPS
               ) -> torch.optim.Adam:
    """Coupled weight decay before the moments (JAX ``adam_torch``)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2),
                            eps=eps, weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def step_decay_schedule(base_lr: float, lr_decay_epochs: Sequence[int],
                        lr_decay_rate: float,
                        steps_per_epoch: int) -> Schedule:
    """Reference adjust_learning_rate (util.py:45-51): lr times
    decay_rate^(number of decay epochs passed), per epoch."""
    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch + 1
        k = sum(1 for e in lr_decay_epochs if epoch > e)
        return base_lr * (lr_decay_rate ** k)
    return schedule


def cosine_schedule(base_lr: float, lr_decay_rate: float, epochs: int,
                    steps_per_epoch: int) -> Schedule:
    """CosineAnnealingLR with eta_min = lr * rate^3, stepped per epoch with
    the reference's scheduler.step()-before-train quirk
    (train_supervised.py:159-162): epoch e trains at the value for e."""
    eta_min = base_lr * (lr_decay_rate ** 3)

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch + 1
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * epoch / epochs))
    return schedule
