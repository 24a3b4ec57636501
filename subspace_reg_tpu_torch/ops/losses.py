"""Losses, metrics and the FSCIL regularizers on torch tensors.

Counterpart of ``subspace_reg_tpu/ops/losses.py``; norm conventions follow
reference models/resnet_language.py:89-97,229-240:

  * ``regloss``        base-weight drift, UN-squared Frobenius norm
                       (+ squared norm for the bias term)
  * ``reglossnovel``   previous-novel drift, UN-squared Frobenius norm; the
                       reference's bias branch crashes (:239) and is refused
  * the subspace/semantic pull is SQUARED (``lang_puller.pull_loss``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def safe_norm(x: torch.Tensor) -> torch.Tensor:
    """Frobenius norm with a zero (sub)gradient at the origin, where
    W[:60] == W0 exactly at session 0's first step."""
    sq = torch.sum(x * x)
    is_zero = sq == 0.0
    sq_safe = torch.where(is_zero, torch.ones_like(sq), sq)
    return torch.where(is_zero, torch.zeros_like(sq), torch.sqrt(sq_safe))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy; with ``sample_mask`` the mean runs over
    the valid rows of a padded batch only."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
    if sample_mask is None:
        return nll.mean()
    total = sample_mask.sum()
    return (nll * sample_mask).sum() / torch.clamp_min(total, 1.0)


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor,
                  topk: Sequence[int] = (1, 5)) -> Tuple[torch.Tensor, ...]:
    """Top-k accuracy in percent (reference eval/util.py:26-40) with
    torch.topk's tie rule made explicit: a tied class with a LOWER index
    outranks the true class.  rank = #classes that beat the label."""
    labels = labels.long()
    logit_y = torch.gather(logits, 1, labels[:, None])
    cols = torch.arange(logits.shape[1], device=logits.device)[None, :]
    beats = (logits > logit_y) | ((logits == logit_y) & (cols < labels[:, None]))
    rank = beats.sum(1)
    scale = 100.0 / labels.shape[0]
    return tuple((rank < k).sum().to(torch.float32) * scale for k in topk)


def regloss(lmbd: float, weight: torch.Tensor, base_weight: torch.Tensor,
            n_base: int, bias: Optional[torch.Tensor] = None,
            base_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """lmbd * ||W[:n_base] - W0|| (UN-squared) + lmbd * ||b[:n_base] - b0||^2
    (squared), reference models/resnet_language.py:229-233, on padded
    buffers (rows >= n_base are masked out)."""
    rows = torch.arange(weight.shape[0], device=weight.device)
    m = (rows < n_base).to(weight.dtype)
    reg = lmbd * safe_norm((weight - base_weight) * m[:, None])
    if bias is not None and base_bias is not None:
        reg = reg + lmbd * torch.sum(torch.square((bias - base_bias) * m))
    return reg


def reglossnovel(lmbd: float, weight: torch.Tensor, reserved: torch.Tensor,
                 num_classes: int, n_reserved: int,
                 bias=None) -> torch.Tensor:
    """lmbd * ||W[nc : nc+k] - reserved[:k]|| (UN-squared).  ``num_classes``
    is the ORIGINAL base count (resnet_language.py:236); ``reserved`` is a
    padded (max_novel, d) buffer with ``n_reserved`` valid rows."""
    if bias is not None:
        raise NotImplementedError(
            "reference reglossnovel bias branch crashes "
            "(models/resnet_language.py:239); golden configs use no bias")
    max_novel = reserved.shape[0]
    rows = torch.arange(max_novel, device=weight.device)
    m = (rows < n_reserved).to(weight.dtype)
    cur = weight[num_classes:num_classes + max_novel]
    return lmbd * safe_norm((cur - reserved) * m[:, None])
