"""The plain reference of the configurations' backbone: the RFS ResNet of
"Rethinking Few-Shot Image Classification" as the subspace-regularizer
paper uses it (reference ``models/resnet_language.py``), in plain PyTorch
operations on a dict of tensors named as that code's state dict.

A block at H x W: three 3x3 convolutions, each followed by BatchNorm
(LeakyReLU 0.1 after the first two), a 1x1 convolution + BatchNorm
shortcut where the width changes, the sum, LeakyReLU, a max-pool of the
block's stride, then dropout (rate 0.1) or, on the last block of stages
3 and 4, DropBlock with the ramped rate (block size 1 under
``--no_dropblock``).  Each block counts its train-mode forwards, which
drives the DropBlock ramp.  Features are the average over the last map.

BatchNorm in train mode normalizes with the batch's single-pass biased
variance, over the valid rows only when a row mask is given, and moves
the running statistics by 0.1 towards the batch's mean and unbiased
variance.

``dtype=torch.bfloat16`` is the pretraining precision the configuration
states: the image and every convolution's operands in bf16, statistics
in f32 folded into a bf16 scale and shift, LeakyReLU and dropout in bf16,
DropBlock's mask in f32, features pooled in f32.  ``dtype=None`` is f32
throughout.  ``operand_round`` (the control) rounds every convolution's
operands to a lower precision before the convolution.

As every backbone reference (``backbone.py``), it also counts one image's
forward (``forward_flops``), gives the feature width (``feature_dim``)
and the CPU tests' tiny sizes (``TINY``).  The reference imports nothing
of the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark import flops

Tensors = Dict[str, torch.Tensor]

# widths 8-16-24-80 at 16 px: every stage keeps a map to pool
TINY = {"widths": [8, 16, 24, 80], "img_size": 16}


def block_names(n_blocks) -> List[str]:
    return [f"layer{li + 1}.{bi}" for li, n in enumerate(n_blocks)
            for bi in range(n)]


def block_kinds(n_blocks, drop_rate: float, dropblock_size: int,
                no_dropblock: bool) -> List[dict]:
    """Per block: its stride, shortcut, and regularizer.  Stages of one
    block use dropout on stages 1-2 and DropBlock on 3-4; a stage of more
    blocks uses dropout on all but its last block (the reference's
    ``_make_layer`` hands ``use_se`` to its first block's drop_block)."""
    bs = 1 if no_dropblock else dropblock_size
    out = []
    for li, n in enumerate(n_blocks):
        for bi in range(n):
            last = bi == n - 1
            out.append(dict(stride=2 if bi == 0 else 1, shortcut=bi == 0,
                            drop_block=(li >= 2) and last,
                            block_size=bs if (li >= 2 and last) else 1,
                            drop_rate=drop_rate))
    return out


def _uniform(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32)


def batch_norm(x, p: Tensors, buf: Tensors, prefix: str, train: bool,
               mask: Optional[torch.Tensor], momentum: float = 0.1,
               eps: float = 1e-5):
    dt = x.dtype
    xs = x.to(torch.float32)
    if train:
        axes = (0, 2, 3)
        if mask is None:
            mean = xs.mean(axes)
            var = (xs * xs).mean(axes) - mean * mean
            n = float(x.numel() // x.shape[1])
            ratio = n / max(n - 1.0, 1.0)
        else:
            m = mask.reshape(-1, 1, 1, 1).to(torch.float32)
            n = mask.sum() * (x.shape[2] * x.shape[3])
            mean = (xs * m).sum(axes) / n
            var = ((xs * xs) * m).sum(axes) / n - mean * mean
            ratio = n / torch.clamp_min(n - 1.0, 1.0)
        var = torch.clamp_min(var, 0.0)
        with torch.no_grad():
            unbiased = var * ratio
            buf[prefix + "running_mean"] = (
                (1 - momentum) * buf[prefix + "running_mean"]
                + momentum * mean.detach())
            buf[prefix + "running_var"] = (
                (1 - momentum) * buf[prefix + "running_var"]
                + momentum * unbiased.detach())
    else:
        mean = buf[prefix + "running_mean"]
        var = buf[prefix + "running_var"]
    w, b = p[prefix + "weight"], p[prefix + "bias"]
    inv = torch.rsqrt(var + eps)
    c = (1, -1, 1, 1)
    if dt == torch.float32:
        return (x - mean.reshape(c)) * (inv * w).reshape(c) + b.reshape(c)
    scale = (inv * w).to(dt)
    shift = (b - mean * inv * w).to(dt)
    return x * scale.reshape(c) + shift.reshape(c)


def leaky(x):
    if x.dtype == torch.float32:
        return F.leaky_relu(x, 0.1)
    return torch.where(x >= 0, x, x * torch.tensor(0.1, dtype=x.dtype,
                                                   device=x.device))


def conv(x, w, dtype, operand_round: Optional[Callable] = None):
    pad = w.shape[-1] // 2
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    if operand_round is not None:
        x, w = operand_round(x), operand_round(w)
    return F.conv2d(x, w, None, 1, pad)


def dropblock_gamma(drop_rate: float, nbt: torch.Tensor, feat: int,
                    bs: int) -> torch.Tensor:
    keep = torch.clamp_min(1.0 - drop_rate / (20 * 2000)
                           * nbt.to(torch.float32), 1.0 - drop_rate)
    return (1.0 - keep) / bs ** 2 * feat ** 2 / (feat - bs + 1) ** 2


def forward(p: Tensors, buf: Tensors, x: torch.Tensor, config: dict,
            train: bool, gen: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None, dtype=None,
            operand_round: Optional[Callable] = None) -> torch.Tensor:
    """(B, 3, H, W) normalized images -> (B, D) f32 features.  In train
    mode ``buf``'s running statistics and counters move in place (its
    entries are replaced by new tensors) and ``gen`` draws the dropout
    and DropBlock masks, block by block, as the published model does."""
    names = block_names(config["n_blocks"])
    kinds = block_kinds(config["n_blocks"], config["drop_rate"],
                        config["dropblock_size"], config["no_dropblock"])
    if dtype is not None:
        x = x.to(dtype)
    for name, k in zip(names, kinds):
        pre = name + "."
        if train:
            buf[pre + "num_batches_tracked"] = (
                buf[pre + "num_batches_tracked"] + 1)
        out = leaky(batch_norm(conv(x, p[pre + "conv1.weight"], dtype,
                                    operand_round),
                               p, buf, pre + "bn1.", train, mask))
        out = leaky(batch_norm(conv(out, p[pre + "conv2.weight"], dtype,
                                    operand_round),
                               p, buf, pre + "bn2.", train, mask))
        out = batch_norm(conv(out, p[pre + "conv3.weight"], dtype,
                              operand_round),
                         p, buf, pre + "bn3.", train, mask)
        res = x
        if k["shortcut"]:
            res = batch_norm(conv(x, p[pre + "downsample.0.weight"], dtype,
                                  operand_round),
                             p, buf, pre + "downsample.1.", train, mask)
        out = leaky(out + res)
        if k["stride"] > 1:
            out = F.max_pool2d(out, k["stride"], k["stride"])
        if train and k["drop_rate"] > 0:
            if k["drop_block"]:
                bs = k["block_size"]
                b_, c_, h_, w_ = out.shape
                gamma = dropblock_gamma(k["drop_rate"],
                                        buf[pre + "num_batches_tracked"],
                                        h_, bs)
                u = _uniform((b_, c_, h_ - bs + 1, w_ - bs + 1), gen,
                             out.device)
                seeds = (u < gamma).to(torch.float32)
                canvas = F.pad(seeds, (0, bs - 1, 0, bs - 1))
                block = F.max_pool2d(F.pad(canvas, (bs - 1, 0, bs - 1, 0)),
                                     bs, stride=1)
                keep = 1.0 - block
                out = keep * out * (keep.numel() / keep.sum())
            else:
                kp = 1.0 - k["drop_rate"]
                u = _uniform(out.shape, gen, out.device)
                scale = (kp if out.dtype == torch.float32 else
                         torch.tensor(kp, dtype=out.dtype,
                                      device=out.device))
                out = torch.where(u < kp, out / scale,
                                  torch.zeros_like(out))
        x = out
    return x.to(torch.float32).mean((2, 3))


def blocks(config: dict) -> List[Dict[str, int]]:
    """(cin, cout, h, w, shortcut, stride) of every block in order, for
    the configuration's ``widths``, ``n_blocks``, ``img_size``: the first
    block of a stage pools by 2 at its end, the others run at the pooled
    size (the RFS ``_make_layer``)."""
    h = w = int(config["img_size"])
    cin = int(config.get("in_channels", 3))
    out = []
    for planes, n in zip(config["widths"], config["n_blocks"]):
        for i in range(n):
            out.append(dict(cin=cin, cout=planes, h=h, w=w,
                            shortcut=(i == 0), stride=2 if i == 0 else 1))
            if i == 0:
                h, w = h // 2, w // 2
            cin = planes
    return out


def forward_flops(config: dict) -> int:
    """Operations of one image's forward: its blocks' convolutions."""
    return sum(flops.block_flops(b["cin"], b["cout"], b["h"], b["w"],
                                 b["shortcut"]) for b in blocks(config))


def feature_dim(config: dict) -> int:
    return int(config["widths"][-1])
