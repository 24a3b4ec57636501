"""The fine-tune optimizer (reference eval/util.py:92-102).

``torch.optim.SGD`` couples weight decay into the gradient before the
momentum accumulation and seeds the momentum buffer with the first (decayed)
gradient; ``torch.optim.Adam`` couples decay the same way.  The reference's
Adam branch hard-codes a weight decay of 5e-4 whatever ``--weight_decay``
says (the JAX engine mirrors this at incremental.py:245-246).

The engine takes the first step itself and hands the optimizer state to the
fused loop (K1), which takes every later step with the same update rule, so
the optimizer is a set of hyperparameters plus that first step rather than a
``torch.optim.Optimizer``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
        momentum or Adam m, Adam v or None)."""
        g = {k: grads[k] + self.weight_decay * params[k] for k in params}
        if not self.adam:
            # momentum buffer = first decayed gradient
            return ({k: params[k] - self.lr * g[k] for k in params}, g, None)
        m = {k: (1.0 - self.b1) * g[k] for k in g}
        v = {k: (1.0 - self.b2) * g[k] * g[k] for k in g}
        new = {k: params[k] - self.lr * (m[k] / (1.0 - self.b1))
               / (torch.sqrt(v[k] / (1.0 - self.b2)) + self.eps)
               for k in params}
        return new, m, v


def get_optim(opt) -> OptimSpec:
    """Reference eval/util.py:92-102: SGD with ``--weight_decay`` and
    ``--momentum``, or Adam with its hard-coded weight decay."""
    if opt.adam:
        return OptimSpec(adam=True, lr=opt.learning_rate,
                         weight_decay=ADAM_WEIGHT_DECAY, momentum=0.0)
    return OptimSpec(adam=False, lr=opt.learning_rate,
                     weight_decay=opt.weight_decay, momentum=opt.momentum)
