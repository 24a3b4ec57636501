"""Batched image augmentation on torch tensors.

Counterpart of ``subspace_reg_tpu/ops/augment.py`` with torchvision
semantics (pad -> random crop -> hflip -> color jitter -> normalize).  The
JAX package realizes the crop as one-hot matmuls because the TPU's matrix
unit is its general shift engine; here the crop and flip are plain index
gathers.  The random numbers come in as an ``AugmentDraws`` from the
engine's draw provider (engine/draws.py), so the same draws give the same
pixels in both packages.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from ..data.transforms import AugmentSpec

_GRAY_W = (0.299, 0.587, 0.114)


@dataclass
class AugmentDraws:
    """Per-image random numbers of one ``augment_batch`` call."""
    offsets: torch.Tensor        # (B, 2) int64 crop offsets in [0, 2*pad]
    flip: torch.Tensor           # (B,) bool
    jitter_factors: torch.Tensor  # (B, 3) f32 brightness/contrast/saturation
    jitter_order: torch.Tensor   # (B, 3) int64 permutation of (0, 1, 2)

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(t.to(device) for t in (
            self.offsets, self.flip, self.jitter_factors, self.jitter_order)))


@functools.lru_cache(maxsize=None)
def _constant(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an f32 vector on ``device``, copied from the host once:
    a copy from pageable host memory synchronizes the stream, and a step
    captured as a CUDA graph (engine/pretrain.py) may copy nothing."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _gray(v: torch.Tensor) -> torch.Tensor:
    return v @ _constant(_GRAY_W, v.device)


def _jitter_batch(x: torch.Tensor, factors: torch.Tensor,
                  order: torch.Tensor) -> torch.Tensor:
    """ColorJitter over a float NHWC batch in [0, 255]: each step clamps to
    [0, 255]; the per-image order of (brightness, contrast, saturation) is
    ``order``."""
    fb = factors[:, 0][:, None, None, None]
    fc = factors[:, 1][:, None, None, None]
    fs = factors[:, 2][:, None, None, None]
    for step in range(3):
        sel = order[:, step][:, None, None, None]
        xb = torch.clamp(x * fb, 0.0, 255.0)
        gray_mean = _gray(x).mean((1, 2))[:, None, None, None]
        xc = torch.clamp((x - gray_mean) * fc + gray_mean, 0.0, 255.0)
        gray = _gray(x)[..., None]
        xs = torch.clamp((x - gray) * fs + gray, 0.0, 255.0)
        x = torch.where(sel == 0, xb, torch.where(sel == 1, xc, xs))
    return x


def _crop_flip(x: torch.Tensor, pad: int, offsets: torch.Tensor,
               flip) -> torch.Tensor:
    """RandomCrop(size, padding) (+ RandomHorizontalFlip when ``flip`` is
    given): output pixel (i, k) = padded[i + off0, (W-1-k if flip else k)
    + off1]."""
    b, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    rows = torch.arange(h, device=x.device)[None, :] + offsets[:, 0:1]
    k = torch.arange(w, device=x.device)[None, :].expand(b, w)
    if flip is not None:
        k = torch.where(flip[:, None], w - 1 - k, k)
    cols = k + offsets[:, 1:2]
    bidx = torch.arange(b, device=x.device)[:, None, None]
    return xp[bidx, rows[:, :, None], cols[:, None, :]]


def augment_batch(imgs_u8: torch.Tensor, spec: AugmentSpec,
                  draws: AugmentDraws) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, H, W, 3) normalized float32."""
    x = imgs_u8.to(torch.float32)
    if spec.random_crop and spec.padding > 0:
        x = _crop_flip(x, spec.padding, draws.offsets,
                       draws.flip if spec.hflip else None)
    elif spec.hflip:
        x = torch.where(draws.flip[:, None, None, None],
                        torch.flip(x, (2,)), x)
    if spec.color_jitter > 0:
        x = _jitter_batch(x, draws.jitter_factors, draws.jitter_order)
    return _normalize(x, spec)


def normalize_batch(imgs_u8: torch.Tensor, spec: AugmentSpec) -> torch.Tensor:
    """Deterministic test transform: ToTensor + Normalize only (bit-exact
    with the JAX package's ``normalize_batch``)."""
    return _normalize(imgs_u8.to(torch.float32), spec)


def _normalize(x: torch.Tensor, spec: AugmentSpec) -> torch.Tensor:
    x = x * (1.0 / 255.0)
    mean = _constant(tuple(spec.mean), x.device)
    std = _constant(tuple(spec.std), x.device)
    return (x - mean) / std
