"""Plain reference of the throwaway stand-in backbone (``standin.py``),
written as a backbone reference file (``reference/backbone.py``): the
patch embedding as a strided convolution, the class token and position
embedding, one pre-LayerNorm block (self-attention over ``heads`` heads
from one packed in-projection, a GELU MLP), a final LayerNorm (eps
1e-6); the feature is the class token's row.  It has no buffers and
draws nothing, so train and eval mode agree.  Imports nothing of the
program."""

import math

import torch
import torch.nn.functional as F

from benchmark import flops

EPS = 1e-6
TINY = {"width": 16, "img_size": 16}


def _layer_norm(t, p, prefix):
    mean = t.mean(-1, keepdim=True)
    var = ((t - mean) ** 2).mean(-1, keepdim=True)
    return ((t - mean) / torch.sqrt(var + EPS) * p[prefix + "weight"]
            + p[prefix + "bias"])


def _linear(t, p, prefix):
    return t @ p[prefix + "weight"].T + p[prefix + "bias"]


def forward(p, buffers, x, config, train, gen=None, mask=None, dtype=None,
            operand_round=None):
    if dtype is not None or operand_round is not None:
        raise NotImplementedError("the stand-in runs in f32 only")
    width, heads = int(config["width"]), int(config["heads"])
    t = F.conv2d(x, p["patch_embed.weight"], p["patch_embed.bias"],
                 stride=int(config["patch"]))
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([p["cls_token"].expand(t.shape[0], -1, -1), t], 1)
    t = t + p["pos_embed"]
    b, n, _ = t.shape
    qkv = (_layer_norm(t, p, "norm1.") @ p["attn.in_proj_weight"].T
           + p["attn.in_proj_bias"])
    q, k, v = (z.reshape(b, n, heads, width // heads).transpose(1, 2)
               for z in qkv.split(width, -1))
    att = torch.softmax(q @ k.transpose(-1, -2)
                        / math.sqrt(width // heads), -1)
    a = (att @ v).transpose(1, 2).reshape(b, n, width)
    t = t + _linear(a, p, "attn.out_proj.")
    h = F.gelu(_linear(_layer_norm(t, p, "norm2."), p, "fc1."))
    t = t + _linear(h, p, "fc2.")
    return _layer_norm(t, p, "norm.")[:, 0]


def forward_flops(config):
    """The patch embedding, the four products of attention (in- and
    out-projection, scores, values) and the MLP's two."""
    width, mlp = int(config["width"]), int(config["mlp"])
    side = int(config["img_size"]) // int(config["patch"])
    n = side * side + 1
    return (flops.conv_flops(3, width, int(config["patch"]), side, side)
            + 2 * n * width * 4 * width + 2 * 2 * n * n * width
            + 2 * 2 * n * width * mlp)


def feature_dim(config):
    return int(config["width"])
