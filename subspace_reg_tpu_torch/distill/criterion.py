"""Distillation criteria on torch tensors (reference distill/criterion.py:
15-93, distill/NCECriterion.py:7-37).

Counterpart of ``subspace_reg_tpu/distill/criterion.py``: the same ``EPS``,
reductions and T^2 scaling.  Feature maps are NCHW here (the JAX functions
take NHWC), so ``attention_loss`` averages over dimension 1.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

EPS = 1e-7


def DistillKL(logits_s: torch.Tensor, logits_t: torch.Tensor,
              temperature: float) -> torch.Tensor:
    """KL(softmax(t/T) || softmax(s/T)) * T^2 / B
    (reference distill/criterion.py DistillKL)."""
    t = temperature
    logp_s = F.log_softmax(logits_s / t, dim=1)
    p_t = F.softmax(logits_t / t, dim=1)
    kl = torch.sum(p_t * (torch.log(torch.clamp_min(p_t, EPS)) - logp_s))
    return kl * (t ** 2) / logits_s.shape[0]


def nce_loss(out: torch.Tensor, n_data: int) -> torch.Tensor:
    """NCE loss over (B, K+1) similarity scores, slot 0 the positive
    (reference distill/NCECriterion.py:7-37)."""
    bsz = out.shape[0]
    m = out.shape[1] - 1
    pn = 1.0 / n_data
    p_pos = out[:, 0]
    log_d1 = torch.log(p_pos / torch.clamp_min(p_pos + m * pn, EPS))
    p_neg = out[:, 1:]
    log_d0 = torch.log((m * pn) / torch.clamp_min(p_neg + m * pn, EPS))
    return -(torch.sum(log_d1) + torch.sum(log_d0)) / bsz


def nce_softmax_loss(out: torch.Tensor) -> torch.Tensor:
    """InfoNCE: cross-entropy with target 0 (reference NCESoftmaxLoss)."""
    return -torch.mean(F.log_softmax(out, dim=1)[:, 0])


def attention_loss(feats_s: Sequence[torch.Tensor],
                   feats_t: Sequence[torch.Tensor],
                   p: int = 2) -> torch.Tensor:
    """Attention-transfer loss over lists of NCHW feature maps (reference
    Attention)."""
    def at(f):
        a = torch.mean(torch.abs(f) ** p, dim=1)
        a = a.reshape(a.shape[0], -1)
        return a / torch.clamp_min(
            torch.linalg.vector_norm(a, dim=1, keepdim=True), EPS)
    return sum(torch.mean(torch.square(at(s) - at(t)))
               for s, t in zip(feats_s, feats_t))


def hint_loss(f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """FitNets hint (reference HintLoss): plain MSE."""
    return torch.mean(torch.square(f_s - f_t))


def label_smoothing_loss(logits: torch.Tensor, labels: torch.Tensor,
                         smoothing: float = 0.0) -> torch.Tensor:
    """NLL with label smoothing (reference util.py:10-30)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
    smooth = -torch.mean(logp, dim=-1)
    return torch.mean((1.0 - smoothing) * nll + smoothing * smooth)


def bce_with_logits_loss(logits: torch.Tensor, labels: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
    """One-hot BCE (reference util.py:32-43, whose version crashes on a
    missing import; this is the JAX package's working formula)."""
    onehot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    return torch.mean(torch.clamp_min(logits, 0) - logits * onehot
                      + torch.log1p(torch.exp(-torch.abs(logits))))
