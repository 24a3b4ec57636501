"""Inputs and weights made from the seed, on the device, in a few large
calls: class-coloured uint8 image stores (each class a colour, each pixel
that colour plus uniform noise in [-25, 25], clipped, as the port's
``data/synthetic.py`` makes its images) and the backbone's and head's
weights.  Nothing is written to disk.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import draws as D

STORE, WEIGHTS = 11, 12
CHUNK = 16384      # images made per call


def class_colours(seed: int, n_classes: int, device) -> torch.Tensor:
    g = D.generator(seed, STORE, 0, device)
    return torch.randint(30, 226, (n_classes, 3), generator=g,
                         device=device, dtype=torch.int16)


def store(seed: int, index: int, labels: np.ndarray, colours: torch.Tensor,
          img: int, device, out: Optional[np.ndarray] = None):
    """(N, img, img, 3) uint8 images of ``labels``: on the device, or,
    with ``out`` (a host array), made chunk by chunk into it."""
    n = len(labels)
    g = D.generator(seed, STORE, 1 + index, device)
    lab = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    dev_out = None if out is not None else torch.empty(
        (n, img, img, 3), dtype=torch.uint8, device=device)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        noise = torch.randint(-25, 26, (hi - lo, img, img, 3), generator=g,
                              device=device, dtype=torch.int16)
        x = (noise + colours[lab[lo:hi]][:, None, None, :]).clamp_(0, 255)
        x = x.to(torch.uint8)
        if out is None:
            dev_out[lo:hi] = x
        else:
            out[lo:hi] = x.cpu().numpy()
    return dev_out if out is None else out


def balanced_labels(n_classes: int, n: int, seed: int,
                    shuffle: bool = True) -> np.ndarray:
    """``n`` labels over ``n_classes`` classes, as equal as they go, in an
    order drawn from the seed (a shuffled pooled split) or class by
    class."""
    labels = np.arange(n) % n_classes
    if shuffle:
        np.random.RandomState(seed % (2 ** 32)).shuffle(labels)
    else:
        labels = np.sort(labels)
    return labels


def init_backbone(backbone: torch.nn.Module, seed: int) -> None:
    """Fresh weights for ``backbone`` (on its device) from the seed: every
    parameter of two or more dimensions (convolutions, linear layers,
    embeddings) N(0, 2 / fan_out) (kaiming_normal, fan_out as torch
    counts it: dimension 0 times the receptive field; so the RFS ResNet
    initializes its convolutions) from one draw on the device; a
    normalization's weight 1, biases 0, running mean 0, running variance
    1; counters 0."""
    mats = [p for n, p in backbone.named_parameters() if p.dim() >= 2]
    dev = mats[0].device
    g = D.generator(seed, WEIGHTS, 0, dev)
    flat = torch.randn(sum(p.numel() for p in mats), generator=g,
                       device=dev)
    with torch.no_grad():
        lo = 0
        for p in mats:
            fan_out = p.shape[0] * math.prod(p.shape[2:])
            p.copy_(flat[lo:lo + p.numel()].view_as(p)
                    * (2.0 / fan_out) ** 0.5)
            lo += p.numel()
        for name, t in list(backbone.named_parameters()) + list(
                backbone.named_buffers()):
            if t.dim() >= 2:
                continue
            if name.endswith("running_var") or (
                    name.endswith("weight") and t.dim() == 1):
                t.fill_(1.0)
            else:
                t.zero_()


def head_weight(seed: int, n_cls: int, in_dim: int, max_classes: int,
                device) -> torch.Tensor:
    """A (max_classes, in_dim) head with ``n_cls`` rows of nn.Linear's
    default init from the seed and zero rows after them."""
    w, _ = D.linear_init(seed, 1 << 20, n_cls, in_dim, False, device)
    out = torch.zeros((max_classes, in_dim), device=device)
    out[:n_cls] = w
    return out


def state_of(backbone: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Copies of every parameter and buffer, by their state-dict names."""
    return {k: v.detach().clone() for k, v in backbone.state_dict().items()}
