"""Statically-padded growing classifier head.

Counterpart of ``subspace_reg_tpu/models/head.py``: a fixed
``(max_classes, 640)`` weight buffer plus an ``n_active`` count.  Growth
writes freshly initialized rows into the buffer; logits of inactive rows are
masked to ``NEG_INF``, which leaves softmax/CE, argmax and top-k identical to
the reference's exactly-sized ``nn.Linear`` (models/resnet_language.py:202-226).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = -1e9


@dataclass
class Head:
    weight: torch.Tensor            # (max_classes, in_dim)
    bias: Optional[torch.Tensor]    # (max_classes,) or None
    n_active: int

    @property
    def max_classes(self) -> int:
        return self.weight.shape[0]

    @property
    def in_dim(self) -> int:
        return self.weight.shape[1]


def torch_linear_init(n_rows: int, in_dim: int, with_bias: bool,
                      generator: Optional[torch.Generator],
                      device="cpu"):
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    the weight and the bias (reference models/resnet_language.py:140,
    216-219)."""
    k = 1.0 / math.sqrt(in_dim)
    w = torch.empty((n_rows, in_dim), device=device).uniform_(
        -k, k, generator=generator)
    b = None
    if with_bias:
        b = torch.empty((n_rows,), device=device).uniform_(
            -k, k, generator=generator)
    return w, b


def init_head(n_cls: int, in_dim: int = 640, with_bias: bool = True,
              max_classes: Optional[int] = None,
              generator: Optional[torch.Generator] = None,
              device="cpu") -> Head:
    """A head with ``n_cls`` freshly initialized active rows inside a
    zero-padded ``max_classes`` buffer."""
    max_classes = max_classes or n_cls
    if n_cls > max_classes:
        raise ValueError(f"n_cls {n_cls} exceeds max_classes {max_classes}")
    w0, b0 = torch_linear_init(n_cls, in_dim, with_bias, generator, device)
    weight = torch.zeros((max_classes, in_dim), device=device)
    weight[:n_cls] = w0
    bias = None
    if with_bias:
        bias = torch.zeros((max_classes,), device=device)
        bias[:n_cls] = b0
    return Head(weight=weight, bias=bias, n_active=n_cls)


def masked_logits(feat: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], n_active: int) -> torch.Tensor:
    """feat (B, in_dim) -> (B, max_classes) with inactive rows at NEG_INF."""
    out = feat @ weight.T
    if bias is not None:
        out = out + bias
    rows = torch.arange(out.shape[-1], device=out.device)
    return torch.where(rows[None, :] < n_active, out,
                       torch.full_like(out, NEG_INF))


def augment(head: Head, new_w: torch.Tensor, new_b: Optional[torch.Tensor],
            n_new: int) -> Head:
    """Grow the head by ``n_new`` rows (reference
    ``augment_base_classifier_``, models/resnet_language.py:202-226).

    ``new_w``/``new_b`` are a fresh ``(max_classes, in_dim)`` init block;
    it is rolled so that row j lands at ``n_active + j`` and only rows
    ``[n_active, n_active + n_new)`` are taken — the JAX package's
    roll-then-select, which keeps the drawn distribution independent of the
    session index."""
    n_act = head.n_active
    rows = torch.arange(head.max_classes, device=head.weight.device)
    sel = (rows >= n_act) & (rows < n_act + n_new)
    weight = torch.where(sel[:, None], torch.roll(new_w, n_act, 0),
                         head.weight)
    bias = head.bias
    if bias is not None:
        bias = torch.where(sel, torch.roll(new_b, n_act, 0), bias)
    return Head(weight=weight, bias=bias, n_active=n_act + n_new)
