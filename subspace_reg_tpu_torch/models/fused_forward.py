"""Fused-frontend forward for pretraining: stages 1-2 through the fused
BasicBlock (ops/fused_block.py: K2 + K3), stages 3-4 through the modules.

Counterpart of ``subspace_reg_tpu/models/fused_forward.py``.  Semantics
match the module path (``ResNetRFS.forward`` in train mode):

  * train-mode BN batch statistics; the fused BNs' running statistics get
    the torch EMA (momentum 0.1, unbiased variance) here, since the fused
    path bypasses ``TorchBatchNorm``.  As PyTorch modules do, the running
    buffers and each block's ``num_batches_tracked`` are updated IN PLACE on
    the module (the JAX function returns them as new trees instead);
  * per-block dropout after the pooled tail of stages 1/2 (plain dropout:
    the reference's drop_block flag is False there);
  * stages 3/4 (with DropBlock) and the average pool run through the
    modules unchanged.

Only valid for the geometry ``can_fuse`` admits: single-block stages 1/2,
no SE, bf16 compute, a size divisible by 4, train mode.  The fused blocks
compute in the backbone's dtype (f32 for ``dtype=None``: the plain
versions' gradient checks on the CPU).

Under a data mesh (``group``) the fused blocks' statistics are the global
batch's (ops/fused_block.py) and so is the count behind the running
variance's unbiased correction; stages 3/4 take theirs from the modules
under ``models.layers.cross_replica``, which the caller sets.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import fused_block as fb
from ..parallel.mesh import group_size
from .layers import dropout
from .resnet import ResNetRFS


def can_fuse(backbone: ResNetRFS, img_size: int, train: bool) -> bool:
    nb = backbone.n_blocks
    return (train and backbone.dtype == torch.bfloat16
            and not backbone.use_se and len(nb) == 4
            and nb[0] == 1 and nb[1] == 1 and img_size % 4 == 0)


@torch.no_grad()
def _running_update(block, stats: fb.BlockStats, n: int) -> None:
    """Torch running-stat EMA for one fused block's four BNs: the biased
    batch variance normalizes, the UNBIASED estimate feeds the running
    variance."""
    corr = n / max(n - 1.0, 1.0)
    bns = (block.bn1, block.bn2, block.bn3, block.downsample[1])
    for bn, (m, v) in zip(bns, stats):
        mom = bn.momentum
        bn.running_mean.copy_((1.0 - mom) * bn.running_mean + mom * m)
        bn.running_var.copy_((1.0 - mom) * bn.running_var
                             + mom * (v * corr))


def fused_forward(backbone: ResNetRFS, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  backend: str = "xla", group=None) -> torch.Tensor:
    """Train-mode forward with fused stages 1-2: x (B, 3, H, W) normalized
    images -> (B, feature_dim) f32 features.  ``backend``: ``"pallas"``
    (the hand-written kernels) or ``"xla"`` (the same program as torch ops);
    dropout draws from ``generator``; ``group``: the data-parallel group
    whose global batch the statistics are taken over (None: this batch)."""
    b, _, h, w = x.shape
    b *= group_size(group)
    drop = backbone.drop_rate
    out = x.to(backbone.dtype or torch.float32)
    # the image entry (stage 1) needs no input gradient
    for stage, n, need_dx in ((backbone.layer1[0], b * h * w, False),
                              (backbone.layer2[0], b * h * w // 4, True)):
        out, st = fb.fused_block_apply(out, stage, need_dx=need_dx,
                                       backend=backend, group=group)
        _running_update(stage, st, n)
        stage.num_batches_tracked += 1
        if drop > 0:
            out = dropout(out, drop, generator)
    for li in range(2, backbone.n_stages):
        for block in getattr(backbone, f"layer{li + 1}"):
            out = block(out, None, generator)
    return backbone.pool(out)
