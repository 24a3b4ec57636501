"""Building-block layers with the JAX package's numerics, in NCHW.

Counterpart of ``subspace_reg_tpu/models/layers.py``:

* ``TorchBatchNorm`` keeps the JAX contract rather than calling
  ``F.batch_norm``: train mode normalizes with the single-pass biased
  variance E[x^2]-E[x]^2, a ``sample_mask`` restricts the statistics to the
  valid rows of a padded batch (the replay-memory buffer), and the running
  variance is updated with the unbiased estimate at momentum 0.1.
* ``dropblock`` reproduces models/resnet_language.py:303-357 (block-mask
  geometry and the countM/count_ones normalization) with the seeds drawn
  from a caller-supplied ``torch.Generator``.
* ``SELayer`` is the working squeeze-excitation the JAX package ships.

bf16 compute (pretraining): activations arrive in bf16 while parameters
stay f32.  BN statistics are taken in f32 and the affine is folded into a
bf16 scale and shift (JAX layers.py:118-125); LeakyReLU multiplies by
bf16(0.1) and dropout divides by bf16(keep), as jnp does with its weakly
typed constants.  Every bf16 operation rounds once, as in the JAX package.
The f32 path is unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def kaiming_normal_fan_out_(w: torch.Tensor) -> torch.Tensor:
    """kaiming_normal_(mode='fan_out', nonlinearity='leaky_relu', a=0):
    N(0, 2/fan_out), the JAX package's ``variance_scaling(2, fan_out,
    normal)`` (reference models/resnet_language.py:131-133)."""
    return nn.init.kaiming_normal_(w, mode="fan_out",
                                   nonlinearity="leaky_relu")


class TorchBatchNorm(nn.Module):
    """BatchNorm2d with the JAX package's train-mode statistics.

    State-dict keys are ``nn.BatchNorm2d``'s (weight, bias, running_mean,
    running_var), so reference checkpoints load unchanged.  BatchNorm2d's
    own ``num_batches_tracked`` is read by nothing at a fixed momentum; a
    checkpoint's copy is dropped on load, as the JAX importer drops it."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        in_dtype = x.dtype
        # statistics always in f32
        xs = x if in_dtype == torch.float32 else x.to(torch.float32)
        if self.training:
            axes = (0, 2, 3)
            if sample_mask is None:
                mean = xs.mean(axes)
                # single-pass biased variance (JAX layers.py:96)
                var = (xs * xs).mean(axes) - mean * mean
                n = float(x.numel() // x.shape[1])
            else:
                # padded rows must not pollute the statistics: divide by
                # sum(mask)*H*W, not by the padded batch size
                m = sample_mask.reshape(-1, 1, 1, 1).to(xs.dtype)
                n = sample_mask.sum() * (x.shape[2] * x.shape[3])
                mean = (xs * m).sum(axes) / n
                var = ((xs * xs) * m).sum(axes) / n - mean * mean
            var = torch.clamp_min(var, 0.0)
            with torch.no_grad():
                if isinstance(n, float):
                    unbiased = var * (n / max(n - 1.0, 1.0))
                else:
                    unbiased = var * (n / torch.clamp_min(n - 1.0, 1.0))
                mom = self.momentum
                self.running_mean.copy_((1.0 - mom) * self.running_mean
                                        + mom * mean)
                self.running_var.copy_((1.0 - mom) * self.running_var
                                       + mom * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        c = (1, -1, 1, 1)
        if in_dtype == torch.float32:
            return ((x - mean.reshape(c)) * (inv * self.weight).reshape(c)
                    + self.bias.reshape(c))
        # bf16: one folded scale/shift in the compute dtype (JAX
        # layers.py:123-125), two roundings
        a = (inv * self.weight).to(in_dtype)
        b = (self.bias - mean * inv * self.weight).to(in_dtype)
        return x * a.reshape(c) + b.reshape(c)


def apply_dropblock(x: torch.Tensor, seeds: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """Dilate the (B, C, H-bs+1, W-bs+1) 0/1 ``seeds`` into bs x bs blocks
    on the H x W canvas, zero them in ``x`` and rescale by
    numel/count_ones (reference resnet_language.py:318-357)."""
    bs = block_size
    canvas = F.pad(seeds, (0, bs - 1, 0, bs - 1))
    # block[i, j] = max of canvas over the trailing bs x bs window; seeds
    # are >= 0, so zero padding equals the reference's -inf padding
    block = F.max_pool2d(F.pad(canvas, (bs - 1, 0, bs - 1, 0)), bs, stride=1)
    block_mask = 1.0 - block
    return block_mask * x * (block_mask.numel() / block_mask.sum())


def uniform(shape, generator, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) from ``generator``: a ``torch.Generator`` (or
    None), or a callable ``(shape, device) -> tensor`` that a draw provider
    hands in to inject given numbers (engine/draws.py)."""
    if callable(generator):
        return generator(tuple(shape), device)
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def dropblock(x: torch.Tensor, gamma: torch.Tensor, block_size: int,
              generator) -> torch.Tensor:
    """The seeds and the mask are f32 whatever x's dtype, so a bf16 input
    comes out f32, as in the JAX package."""
    b, c, h, w = x.shape
    bs = block_size
    u = uniform((b, c, h - bs + 1, w - bs + 1), generator, x.device)
    return apply_dropblock(x, (u < gamma).to(torch.float32), bs)


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax ``nn.Dropout`` semantics: keep with prob 1-rate, scale kept
    values by 1/(1-rate); a bf16 input divides by bf16(1-rate)."""
    keep_prob = 1.0 - rate
    u = uniform(x.shape, generator, x.device)
    scale = (keep_prob if x.dtype == torch.float32
             else torch.tensor(keep_prob, dtype=x.dtype, device=x.device))
    return torch.where(u < keep_prob, x / scale, torch.zeros_like(x))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1).  bf16: ``where(x >= 0, x, x * bf16(0.1))`` as
    ``jax.nn.leaky_relu`` computes it (``F.leaky_relu`` multiplies by the
    f32 slope and rounds differently on ~10% of inputs)."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, 0.1)
    return torch.where(x >= 0, x, x * torch.tensor(0.1, dtype=x.dtype,
                                                   device=x.device))


class SELayer(nn.Module):
    """Squeeze-excitation (reference models/resnet_language.py:359-374);
    keys ``fc.0`` / ``fc.2`` as in the reference."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction), nn.ReLU(),
            nn.Linear(channels // reduction, channels), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc(x.mean((2, 3)))
        return x * y[:, :, None, None]


def max_pool_torch(x: torch.Tensor, stride: int) -> torch.Tensor:
    """nn.MaxPool2d(stride): kernel=stride=stride, floor mode, no padding
    (reference models/resnet_language.py:256,290).  Identity at stride 1."""
    if stride == 1:
        return x
    return F.max_pool2d(x, stride, stride)
