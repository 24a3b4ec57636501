"""Plain reference of a supervised pretraining step (reference
``train_supervised.py``'s hot loop): the train transform of the batch,
the backbone's train-mode forward, the linear head without bias, the
mean softmax cross-entropy, the gradient by autograd, and SGD with
momentum and weight decay as ``torch.optim.SGD`` defines them (the
decay added to the gradient, the momentum buffer seeded with the first
decayed gradient), at the learning rate the step schedule gives.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .. import draws as D
from . import augment, backbone

Tensors = Dict[str, torch.Tensor]


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale per tensor (the
    largest magnitude at e4m3's largest finite value), the gradient
    passed straight through."""
    scale = t.detach().abs().amax().to(torch.float32).clamp_min(1e-30) / 448
    q = (t.detach().to(torch.float32) / scale).to(torch.float8_e4m3fn)
    q = (q.to(torch.float32) * scale).to(t.dtype)
    return t + (q - t).detach()


def step_lr(config: dict, step: int, steps_per_epoch: int) -> float:
    p = config["pretrain"]
    epoch = step // steps_per_epoch + 1
    k = sum(1 for e in p["lr_decay_epochs"] if epoch > e)
    return p["learning_rate"] * p["lr_decay_rate"] ** k


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -F.log_softmax(logits, dim=-1).gather(1, y[:, None])[:, 0].mean()


def run_steps(config: dict, params: Tensors, buffers: Tensors,
              batches: Sequence[tuple], seed: int,
              steps_per_epoch: int,
              operand_round: Optional[Callable] = None) -> dict:
    """Steps 0..len(batches)-1 from ``params`` (backbone parameters by
    state-dict name and the head as "head.w") and ``buffers``; each batch
    is (uint8 images (B, H, W, 3), labels) on the device.  Returns the
    loss of each step, the gradient of each leaf at the first step, and
    the parameters and buffers after the last."""
    p = config["pretrain"]
    dtype = torch.bfloat16 if p["precision"] == "bf16" else None
    spec = p["augment"]
    forward = backbone.of(config).forward
    params = {k: v.detach().clone() for k, v in params.items()}
    buffers = {k: v.detach().clone() for k, v in buffers.items()}
    mom: Tensors = {}
    losses: List[float] = []
    first_grad: Tensors = {}
    for t, (x_u8, y) in enumerate(batches):
        dev = x_u8.device
        d = D.augment_draws(seed, D.PRETRAIN_AUGMENT, t, x_u8.shape[0],
                            spec["padding"], spec["color_jitter"], dev)
        x = augment.train_transform(x_u8, d, spec["padding"],
                                    spec["color_jitter"])
        gen = D.generator(seed, D.PRETRAIN_DROPOUT, t, dev)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        feats = forward(leaves, buffers, x, config, train=True, gen=gen,
                        dtype=dtype, operand_round=operand_round)
        loss = cross_entropy(feats @ leaves["head.w"].T, y.long())
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        lr = step_lr(config, t, steps_per_epoch)
        new = {}
        with torch.no_grad():
            for k, g in zip(names, grads):
                if t == 0:
                    first_grad[k] = g.detach().clone()
                dp = g.add(leaves[k], alpha=p["weight_decay"])
                mom[k] = (dp.clone() if t == 0
                          else mom[k].mul(p["momentum"]).add(dp))
                new[k] = leaves[k].detach().add(mom[k], alpha=-lr)
        params = new
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first_grad, "params": params,
            "buffers": buffers}
