"""Plain reference of the image transforms (reference
``dataset/transform_cfg.py``, transform 'A'): RandomCrop(84, padding=8)
-> RandomHorizontalFlip -> ColorJitter(0.4, 0.4, 0.4) in a random order
of its three parts, each clamped to [0, 255] -> ToTensor -> Normalize by
miniImageNet's mean and deviation.  The test transform normalizes only.
The random numbers come in as the benchmark's draws (``draws.py``).
"""

from __future__ import annotations

import torch

MEAN = (120.39586422 / 255.0, 115.59361427 / 255.0, 104.54012653 / 255.0)
STD = (70.68188272 / 255.0, 68.27635443 / 255.0, 72.54505529 / 255.0)
GRAY = (0.299, 0.587, 0.114)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) float in [0, 255] -> normalized, same layout."""
    x = x * (1.0 / 255.0)
    mean = torch.tensor(MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def crop_flip(x: torch.Tensor, pad: int, offsets, flip) -> torch.Tensor:
    """Output pixel (i, k) = padded[i + off0, (W-1-k if flip else k) +
    off1], the padded image zero-filled."""
    b, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    out = torch.empty_like(x)
    for i in range(b):
        o0, o1 = int(offsets[i, 0]), int(offsets[i, 1])
        img = xp[i, o0:o0 + h, o1:o1 + w]
        out[i] = torch.flip(img, (1,)) if bool(flip[i]) else img
    return out


def _gray(x):
    w = torch.tensor(GRAY, dtype=torch.float32, device=x.device)
    return x @ w


def jitter(x: torch.Tensor, factors, order) -> torch.Tensor:
    """Per image, brightness, contrast and saturation in the image's own
    order: at each of the three positions every operation is formed for
    the whole batch and each image takes the one its order names."""
    fb, fc, fs = (factors[:, k][:, None, None, None] for k in range(3))
    for pos in range(3):
        sel = order[:, pos][:, None, None, None]
        bright = torch.clamp(x * fb, 0.0, 255.0)
        m = _gray(x).mean((1, 2))[:, None, None, None]
        contrast = torch.clamp((x - m) * fc + m, 0.0, 255.0)
        g = _gray(x)[..., None]
        satur = torch.clamp((x - g) * fs + g, 0.0, 255.0)
        x = torch.where(sel == 0, bright, torch.where(sel == 1, contrast,
                                                      satur))
    return x


def train_transform(imgs_u8: torch.Tensor, d: dict, padding: int,
                    color_jitter: float) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) normalized f32, kept in the
    channels-last memory order the images come in."""
    x = imgs_u8.to(torch.float32)
    x = crop_flip(x, padding, d["offsets"], d["flip"])
    if color_jitter > 0:
        x = jitter(x, d["factors"], d["order"])
    return normalize(x).permute(0, 3, 1, 2)


def test_transform(imgs_u8: torch.Tensor) -> torch.Tensor:
    return normalize(imgs_u8.to(torch.float32)).permute(0, 3, 1, 2) \
        .contiguous()
