"""RFS-style ResNet backbone in PyTorch (NCHW).

Counterpart of ``subspace_reg_tpu/models/resnet.py`` with the reference's
state-dict key names (``layer1.0.conv1.weight``, ``layer1.0.bn1.running_mean``,
``layer1.0.downsample.0/1``, ...): four stages at widths 64/160/320/640, each
a chain of ``BasicBlock`` (3x conv3x3+BN+LeakyReLU(0.1), residual, stride via
MaxPool, optional SE, dropout/DropBlock), average pool, 640-d feature.

Reference quirks kept, as in the JAX package:

* the ``_make_layer`` positional bug (models/resnet_language.py:155): on a
  multi-block stage the FIRST block gets ``use_se`` in the ``drop_block``
  slot, so in resnet18's layers 3/4 only the last block has DropBlock;
* ``no_dropblock`` only sets the block size to 1; DropBlock still runs with
  the ramped gamma in layers 3/4.

Each block carries a ``num_batches_tracked`` counter (resnet_language.py:260)
that advances on train-mode forwards only and drives the DropBlock gamma
ramp.  It is a buffer under ``layerL.B.num_batches_tracked``; a reference
checkpoint, which lacks it, loads with the counter at 0.

``dtype=torch.bfloat16`` is the pretraining compute path (JAX
models/resnet.py ``dtype``): convolution operands are cast to bf16 while
the parameters stay f32, BN folds into a bf16 affine, and the features are
pooled in f32.  ``dtype=None`` keeps everything f32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv_f32
from .layers import (SELayer, TorchBatchNorm, dropblock, dropout,
                     kaiming_normal_fan_out_, leaky_relu, max_pool_torch)

WIDTHS = (64, 160, 320, 640)


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, k, stride=1, padding=k // 2, bias=False)
    kaiming_normal_fan_out_(conv.weight)
    return conv


def dropblock_gamma(drop_rate: float, nbt: torch.Tensor, feat_size: int,
                    block_size: int) -> torch.Tensor:
    """Ramped DropBlock gamma (reference resnet_language.py:295-296), in
    f32 on ``nbt``'s device so the forward never syncs with the host."""
    bs = block_size
    keep_rate = torch.clamp_min(
        1.0 - drop_rate / (20 * 2000) * nbt.to(torch.float32),
        1.0 - drop_rate)
    return ((1.0 - keep_rate) / bs ** 2
            * feat_size ** 2 / (feat_size - bs + 1) ** 2)


class BasicBlock(nn.Module):
    """Reference BasicBlock (models/resnet_language.py:243-301)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, drop_rate: float = 0.0,
                 drop_block: bool = False, block_size: int = 1,
                 use_se: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.drop_rate = drop_rate
        self.drop_block = drop_block
        self.block_size = block_size
        self.conv1 = _conv(inplanes, planes, 3)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = TorchBatchNorm(planes)
        self.conv3 = _conv(planes, planes, 3)
        self.bn3 = TorchBatchNorm(planes)
        self.se = SELayer(planes, reduction=4) if use_se else None
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(_conv(inplanes, planes, 1),
                                            TorchBatchNorm(planes))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        # a process group: DropBlock normalizes over it (layers.py)
        self.sync_group = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # reference checkpoints keep the counter as a plain attribute, not
        # in the state dict: absent means 0
        state_dict.setdefault(prefix + "num_batches_tracked",
                              torch.zeros((), dtype=torch.long))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """``conv(x)`` with both operands in the compute dtype: K4
        (``ops/conv_f32.py``, channels_last out) where f32 needs no
        gradient, ``F.conv2d`` otherwise."""
        if self.dtype is None:
            if conv_f32.wanted(x, conv.weight):
                return conv_f32.conv_f32(x, conv.weight, conv.stride,
                                         conv.padding)
            return conv(x)
        return F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), None,
                        1, conv.padding)

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training:
            self.num_batches_tracked += 1
        out = self.bn1(self.conv(self.conv1, x), sample_mask, leaky=True)
        out = self.bn2(self.conv(self.conv2, out), sample_mask, leaky=True)
        out = self.bn3(self.conv(self.conv3, out), sample_mask)
        if self.se is not None:
            out = self.se(out)
        residual = x
        if self.downsample is not None:
            residual = self.downsample[1](self.conv(self.downsample[0], x),
                                          sample_mask)
        out = max_pool_torch(leaky_relu(out + residual), self.stride)

        if self.drop_rate > 0 and self.training:
            if self.drop_block:
                gamma = dropblock_gamma(self.drop_rate,
                                        self.num_batches_tracked,
                                        out.shape[2], self.block_size)
                out = dropblock(out, gamma, self.block_size, generator,
                                self.sync_group)
            else:
                out = dropout(out, self.drop_rate, generator)
        return out


def _stage_block_specs(n_block: int, planes: int, stride: int,
                       drop_rate: float, drop_block: bool, block_size: int,
                       use_se: bool) -> List[Dict[str, Any]]:
    """Per-block settings replicating _make_layer
    (models/resnet_language.py:142-167), including the positional-arg quirk
    on multi-block stage entries (:155)."""
    if n_block == 1:
        return [dict(planes=planes, stride=stride, has_downsample=True,
                     drop_rate=drop_rate, drop_block=drop_block,
                     block_size=block_size, use_se=use_se)]
    specs = [dict(planes=planes, stride=stride, has_downsample=True,
                  drop_rate=drop_rate, drop_block=bool(use_se),
                  block_size=1, use_se=False)]
    for i in range(1, n_block):
        last = i == n_block - 1
        specs.append(dict(planes=planes, stride=1, has_downsample=False,
                          drop_rate=drop_rate,
                          drop_block=drop_block if last else False,
                          block_size=block_size if last else 1,
                          use_se=use_se))
    return specs


class ResNetRFS(nn.Module):
    """The backbone: (B, 3, H, W) normalized images -> (B, 640) features."""

    def __init__(self, n_blocks: Sequence[int] = (1, 1, 1, 1),
                 drop_rate: float = 0.0, dropblock_size: int = 5,
                 no_dropblock: bool = False, use_se: bool = False,
                 avg_pool: bool = True, widths: Sequence[int] = WIDTHS,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.n_blocks = tuple(n_blocks)
        self.use_se = use_se
        self.drop_rate = drop_rate
        self.avg_pool = avg_pool
        self.widths = tuple(widths)
        block_size = 1 if no_dropblock else dropblock_size
        inplanes = 3
        for li, (nb, planes) in enumerate(zip(n_blocks, widths)):
            # layers 3/4 pass drop_block=True in the reference ctor
            # (models/resnet_language.py:119-122)
            specs = _stage_block_specs(nb, planes, stride=2,
                                       drop_rate=drop_rate,
                                       drop_block=li >= 2,
                                       block_size=block_size, use_se=use_se)
            blocks = []
            for spec in specs:
                blocks.append(BasicBlock(inplanes, **spec, dtype=dtype))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.ModuleList(blocks))
        self.n_stages = len(n_blocks)

    @property
    def feature_dim(self) -> int:
        return self.widths[-1]

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        for li in range(self.n_stages):
            for block in getattr(self, f"layer{li + 1}"):
                x = block(x, sample_mask, generator)
        return self.pool(x)

    def blocks(self):
        """Every BasicBlock, stage by stage."""
        for li in range(self.n_stages):
            yield from getattr(self, f"layer{li + 1}")

    def pool(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's map -> features."""
        if self.avg_pool:
            # pool in f32: 640-d feature fidelity matters downstream
            return x.to(torch.float32).mean((2, 3))
        return x.reshape(x.shape[0], -1).to(torch.float32)


def resnet_builder(n_blocks, use_se: bool = False):
    """A builder of ``ResNetRFS`` with ``n_blocks`` blocks a stage (the
    registry's entries, models/factory.py)."""
    def build(avg_pool: bool = False, drop_rate: float = 0.0,
              dropblock_size: int = 5, no_dropblock: bool = False,
              widths: Sequence[int] = WIDTHS, dtype=None, **_) -> ResNetRFS:
        return ResNetRFS(n_blocks=n_blocks, drop_rate=drop_rate,
                         dropblock_size=dropblock_size,
                         no_dropblock=no_dropblock, use_se=use_se,
                         avg_pool=avg_pool, widths=widths, dtype=dtype)
    return build
