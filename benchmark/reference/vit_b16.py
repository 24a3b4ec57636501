"""The plain reference of ViT-B/16 ("An Image is Worth 16x16 Words",
Dosovitskiy et al., ICLR 2021, Table 1 "ViT-Base" at patch 16 and 224
px), in plain PyTorch operations on a dict of tensors named as timm's
``vit_base_patch16_224`` state dict less ``head.*``.

Images whose side is not ``input_size`` are resized to it (bilinear, no
antialiasing).  The patch embedding is a convolution of stride = kernel =
``patch``; the class token is prepended and the position embedding added.
Each of ``depth`` pre-LayerNorm blocks adds ``proj`` of ``heads``-head
attention, softmax(Q K^T / sqrt(head_dim)) V written out, from one packed
``qkv`` product, then ``fc2(GELU(fc1(.)))`` with the exact (erf) GELU;
LayerNorm (eps 1e-6) is written out with the two-pass biased variance.
The feature is the final LayerNorm's class-token row.  In train mode
dropout at ``drop_rate`` follows the position embedding, the attention's
``proj``, the GELU and ``fc2``, its masks drawn from ``gen`` in that
order, block by block.  No buffers, no batch statistic: ``mask`` has
nothing to act on.

f32 throughout, with TF32 off (set below, as the program's device setup
sets it; the FSCIL reference switches TF32 on around its control).
``operand_round`` (the control) rounds the operands of every matrix
product, the patch embedding's and attention's two included.

As every backbone reference (``backbone.py``), it counts one image's
forward (``forward_flops``: every matrix product, as the stand-in of the
benchmark's tests counts them), the dense products alone
(``dense_flops``: patch embedding, qkv, proj, fc1, fc2) and gives the
feature width and the CPU tests' tiny sizes (``TINY``).  It imports
nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark import flops

Tensors = Dict[str, torch.Tensor]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EPS = 1e-6
# 16 px images resized to 32 and cut into 8 px patches: 16 tokens + 1
TINY = {"width": 32, "depth": 2, "heads": 2, "mlp": 64, "patch": 8,
        "input_size": 32, "img_size": 16}


def _sizes(config: dict):
    return (int(config["width"]), int(config["depth"]), int(config["heads"]),
            int(config["mlp"]), int(config["patch"]),
            int(config["input_size"]))


def _mm(a, b, operand_round):
    if operand_round is not None:
        a, b = operand_round(a), operand_round(b)
    return a @ b


def _linear(t, p: Tensors, prefix: str, operand_round):
    return (_mm(t, p[prefix + "weight"].T, operand_round)
            + p[prefix + "bias"])


def _layer_norm(t, p: Tensors, prefix: str):
    mean = t.mean(-1, keepdim=True)
    var = ((t - mean) ** 2).mean(-1, keepdim=True)
    return ((t - mean) / torch.sqrt(var + EPS) * p[prefix + "weight"]
            + p[prefix + "bias"])


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def forward(p: Tensors, buffers: Tensors, x: torch.Tensor, config: dict,
            train: bool, gen: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None, dtype=None,
            operand_round: Optional[Callable] = None) -> torch.Tensor:
    """(B, 3, H, W) normalized images -> (B, width) f32 features."""
    if dtype is not None:
        raise NotImplementedError("the ViT reference runs in f32 only")
    width, depth, heads, _, patch, size = _sizes(config)
    rate = float(config["drop_rate"]) if train else 0.0

    def drop(t):
        if rate <= 0:
            return t
        keep = 1.0 - rate
        u = torch.rand(t.shape, generator=gen, device=t.device,
                       dtype=torch.float32)
        return torch.where(u < keep, t / keep, torch.zeros_like(t))

    if x.shape[-1] != size:
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False, antialias=False)
    w = p["patch_embed.proj.weight"]
    if operand_round is not None:
        x, w = operand_round(x), operand_round(w)
    t = F.conv2d(x, w, p["patch_embed.proj.bias"], stride=patch)
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([p["cls_token"].expand(t.shape[0], -1, -1), t], 1)
    t = drop(t + p["pos_embed"])
    b, n, _ = t.shape
    dh = width // heads
    for i in range(depth):
        pre = f"blocks.{i}."
        qkv = _linear(_layer_norm(t, p, pre + "norm1."), p,
                      pre + "attn.qkv.", operand_round)
        q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        scores = _mm(q, k.transpose(-1, -2), operand_round) / math.sqrt(dh)
        a = _mm(torch.softmax(scores, -1), v, operand_round)
        a = a.transpose(1, 2).reshape(b, n, width)
        t = t + drop(_linear(a, p, pre + "attn.proj.", operand_round))
        h = drop(_gelu(_linear(_layer_norm(t, p, pre + "norm2."), p,
                               pre + "mlp.fc1.", operand_round)))
        t = t + drop(_linear(h, p, pre + "mlp.fc2.", operand_round))
    return _layer_norm(t, p, "norm.")[:, 0]


def _tokens(config: dict) -> int:
    side = int(config["input_size"]) // int(config["patch"])
    return side * side + 1


def dense_flops(config: dict) -> int:
    """One image's dense products: the patch embedding, and in each block
    qkv, proj, fc1 and fc2."""
    width, depth, _, mlp, patch, size = _sizes(config)
    n, side = _tokens(config), size // patch
    return (flops.conv_flops(3, width, patch, side, side)
            + depth * 2 * n * width * (4 * width + 2 * mlp))


def forward_flops(config: dict) -> int:
    """One image's forward: the dense products and attention's two
    (scores and values), 2 n^2 width each a block."""
    depth, n = int(config["depth"]), _tokens(config)
    return dense_flops(config) + depth * 2 * 2 * n * n * int(config["width"])


def feature_dim(config: dict) -> int:
    return int(config["width"])
