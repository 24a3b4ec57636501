"""Building-block layers with the JAX package's numerics, in NCHW.

Counterpart of ``subspace_reg_tpu/models/layers.py``:

* ``TorchBatchNorm`` keeps the JAX contract rather than calling
  ``F.batch_norm``: train mode normalizes with the single-pass biased
  variance E[x^2]-E[x]^2, a ``sample_mask`` restricts the statistics to the
  valid rows of a padded batch (the replay-memory buffer), and the running
  variance is updated with the unbiased estimate at momentum 0.1.  With
  ``sync_group`` set (``cross_replica``), the train-mode statistics are
  those of the global batch: the per-channel sums, sums of squares and
  counts are all-reduced over the data-parallel ranks (parallel/mesh.py),
  the gradient through them too.
* ``dropblock`` reproduces models/resnet_language.py:303-357 (block-mask
  geometry and the countM/count_ones normalization) with the seeds drawn
  from a caller-supplied ``torch.Generator``; given a process group, the
  normalization counts the global batch's mask.
* ``SELayer`` is the working squeeze-excitation the JAX package ships.

bf16 compute (pretraining): activations arrive in bf16 while parameters
stay f32.  BN statistics are taken in f32 and the affine is folded into a
bf16 scale and shift (JAX layers.py:118-125); LeakyReLU multiplies by
bf16(0.1) and dropout divides by bf16(keep), as jnp does with its weakly
typed constants.  Every bf16 operation rounds once, as in the JAX package.
The f32 path is unchanged.

K5: a train-mode bf16 BatchNorm on the card without a mask or a group,
with the LeakyReLU that follows it when the caller passes ``leaky=True``,
runs as the hand-written kernels of ``ops/bn_train.py``: the same function
bit for bit (its sums are torch's own reductions), in 4 + 4 device kernels
for ~70.  Every other call keeps the ops below
(``TorchBatchNorm._normalize``, then ``leaky_relu``), which are K5's plain
twin.  ``TorchBatchNorm.train_forwards`` counts the train-mode forwards of
every instance, ``.kernel_forwards`` those K5 ran; a forward in the
pretraining step's CUDA graph (engine/pretrain.py::StepRunner) counts at
each of its replays.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bn_train as k5


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

    # train-mode forwards of every instance, and those K5 ran (a CUDA
    # graph's forwards count at each replay)
    train_forwards = 0
    kernel_forwards = 0

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        # a process group: reduce the train-mode statistics over it
        self.sync_group = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None,
                leaky: bool = False) -> torch.Tensor:
        """The normalized ``x``, through ``leaky_relu`` if ``leaky``."""
        if self.training:
            TorchBatchNorm.train_forwards += 1
            if k5.wanted(x, sample_mask, self.sync_group):
                TorchBatchNorm.kernel_forwards += 1
                return k5.bn_train(x, self.weight, self.bias,
                                   self.running_mean, self.running_var,
                                   self.momentum, self.eps, leaky)
        out = self._normalize(x, sample_mask)
        return leaky_relu(out) if leaky else out

    def _normalize(self, x: torch.Tensor,
                   sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
        in_dtype = x.dtype
        # statistics always in f32
        xs = x if in_dtype == torch.float32 else x.to(torch.float32)
        if self.training:
            axes = (0, 2, 3)
            if self.sync_group is not None:
                mean, var, n = self._global_stats(xs, sample_mask)
            elif sample_mask is None:
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

    @staticmethod
    def local_sums(xs: torch.Tensor,
                   sample_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """Σx and Σx² per channel and the count (masked rows left out) of
        this batch, concatenated: (2C + 1,) f32."""
        axes = (0, 2, 3)
        if sample_mask is None:
            n = torch.full((1,), float(xs.numel() // xs.shape[1]),
                           dtype=xs.dtype, device=xs.device)
            s1, s2 = xs.sum(axes), (xs * xs).sum(axes)
        else:
            m = sample_mask.reshape(-1, 1, 1, 1).to(xs.dtype)
            n = (sample_mask.sum() * (xs.shape[2] * xs.shape[3])).reshape(
                1).to(xs.dtype)
            s1, s2 = (xs * m).sum(axes), ((xs * xs) * m).sum(axes)
        return torch.cat([s1, s2, n])

    @staticmethod
    def stats_of_sums(tot: torch.Tensor, c: int):
        """(mean, single-pass biased variance, count) from ``local_sums``
        added over shards."""
        n = tot[2 * c]
        mean = tot[:c] / n
        return mean, tot[c:2 * c] / n - mean * mean, n.detach()

    def _global_stats(self, xs: torch.Tensor,
                      sample_mask: Optional[torch.Tensor]):
        """(mean, biased variance, count) of the global batch: the sums
        summed over ``sync_group`` with an autograd-aware all-reduce, then
        the single-pass variance."""
        from ..parallel.mesh import all_reduce_sum
        tot = all_reduce_sum(self.local_sums(xs, sample_mask),
                             self.sync_group)
        return self.stats_of_sums(tot, xs.shape[1])


@contextlib.contextmanager
def cross_replica(module: nn.Module, group):
    """Inside the block, every batch-level statistic of ``module``'s
    train-mode forward is taken over ``group``'s ranks: the BatchNorm
    statistics and DropBlock's normalization (each submodule with a
    ``sync_group``; no-op for None)."""
    mods = [m for m in module.modules() if hasattr(m, "sync_group")]
    for m in mods:
        m.sync_group = group
    try:
        yield
    finally:
        for m in mods:
            m.sync_group = None


def apply_dropblock(x: torch.Tensor, seeds: torch.Tensor, block_size: int,
                    group=None) -> torch.Tensor:
    """Dilate the (B, C, H-bs+1, W-bs+1) 0/1 ``seeds`` into bs x bs blocks
    on the H x W canvas, zero them in ``x`` and rescale by
    numel/count_ones (reference resnet_language.py:318-357), both counted
    over ``group``'s ranks when one is given (the global batch's mask;
    exact in f32 below 2^24 elements)."""
    bs = block_size
    canvas = F.pad(seeds, (0, bs - 1, 0, bs - 1))
    # block[i, j] = max of canvas over the trailing bs x bs window; seeds
    # are >= 0, so zero padding equals the reference's -inf padding
    block = F.max_pool2d(F.pad(canvas, (bs - 1, 0, bs - 1, 0)), bs, stride=1)
    block_mask = 1.0 - block
    if group is None:
        return block_mask * x * (block_mask.numel() / block_mask.sum())
    import torch.distributed as dist
    counts = torch.stack([block_mask.new_tensor(float(block_mask.numel())),
                          block_mask.sum()])
    dist.all_reduce(counts, group=group)
    return block_mask * x * (counts[0] / counts[1])


def uniform(shape, generator, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) from ``generator``: a ``torch.Generator`` (or
    None), or a callable ``(shape, device) -> tensor`` that a draw provider
    hands in to inject given numbers (engine/draws.py)."""
    if callable(generator):
        return generator(tuple(shape), device)
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def dropblock(x: torch.Tensor, gamma: torch.Tensor, block_size: int,
              generator, group=None) -> torch.Tensor:
    """The seeds and the mask are f32 whatever x's dtype, so a bf16 input
    comes out f32, as in the JAX package."""
    b, c, h, w = x.shape
    bs = block_size
    u = uniform((b, c, h - bs + 1, w - bs + 1), generator, x.device)
    return apply_dropblock(x, (u < gamma).to(torch.float32), bs, group)


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """flax ``nn.Dropout`` semantics: keep with prob 1-rate, scale kept
    values by 1/(1-rate); a bf16 input divides by bf16(1-rate)."""
    keep_prob = 1.0 - rate
    u = uniform(x.shape, generator, x.device)
    scale = (keep_prob if x.dtype == torch.float32
             else torch.full((), keep_prob, dtype=x.dtype, device=x.device))
    return torch.where(u < keep_prob, x / scale, torch.zeros_like(x))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.1).  bf16: ``where(x >= 0, x, x * bf16(0.1))`` as
    ``jax.nn.leaky_relu`` computes it (``F.leaky_relu`` multiplies by the
    f32 slope and rounds differently on ~10% of inputs).  The bf16
    constants here and in ``dropout`` are filled on the device: a tensor
    copied from the host synchronizes the stream, and cannot be captured in
    the pretraining step's CUDA graph (engine/pretrain.py)."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, 0.1)
    return torch.where(x >= 0, x, x * torch.full((), 0.1, dtype=x.dtype,
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
