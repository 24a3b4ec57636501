"""Vision Transformer backbone: ViT-B/16 of "An Image is Worth 16x16 Words"
(Dosovitskiy et al., ICLR 2021, Table 1 "ViT-Base"; timm's
``vit_base_patch16_224``), as an FSCIL backbone beside the RFS resnets.

(B, 3, img_size, img_size) normalized images -> (B, width) f32 features:

* images whose side is not ``input_size`` are first resized to it,
  bilinear without antialiasing (the ``Resize(224)`` that ViT pipelines
  apply to miniImageNet's 84 px pickles; here after normalization, which
  differs from resize-then-normalize only by rounding: bilinear weights
  sum to 1);
* the patch embedding: (B, 3, 224, 224) cut into 196 rows of 3 x 16 x 16
  values, one linear to ``width`` with bias, the class token prepended,
  the position embedding added, dropout;
* ``depth`` pre-LayerNorm blocks, ``t = t + drop(proj(attn(LN1(t))))``
  then ``t = t + drop(fc2(drop(GELU(fc1(LN2(t))))))``: ``heads``-head
  scaled-dot-product attention (scale head_dim^-1/2, no attention
  dropout) from one packed ``qkv`` linear, an exact (erf) GELU MLP of
  width ``mlp``; LayerNorm eps 1e-6;
* the feature: the final LayerNorm of the class token's row (no
  pre-logits layer).

Dropout sits where the paper puts it (Appendix B.1: after every dense
layer but qkv, and after the position embedding), at the factory's
``drop_rate``, in train mode only; its masks are drawn from the forward's
``generator`` through ``layers.dropout``, as the resnet's are.

Parameters are named as timm names them (``patch_embed.proj.weight``
(width, 3, patch, patch), ``cls_token``, ``pos_embed``,
``blocks.{i}.norm1``, ``blocks.{i}.attn.qkv``, ``blocks.{i}.attn.proj``,
``blocks.{i}.norm2``, ``blocks.{i}.mlp.fc1``, ``blocks.{i}.mlp.fc2``,
``norm``), so a timm state dict less ``head.*`` maps key for key.

f32 only: the products run with TF32 off as ``utils/device.resolve_device``
leaves it.  The patch embedding is stored as timm's convolution weight and
applied as one linear over the patchified rows (exact for stride =
kernel), so every dense product is a plain GEMM.

``ViT.forwards`` and ``ViT.rows_forwarded`` count the forwards and the
rows they took, every instance together; ``srt.vit.*`` ranges
(``utils/spans.py``) mark the forward, its embedding and each block's two
halves while a profiler records.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.spans import span
from .layers import dropout

# LayerNorm's eps (the original Flax release's and timm's) and F.gelu's
# ``approximate``: "none" is the exact erf form (timm's, the published
# config's "gelu"); the Flax release uses "tanh"
EPS = 1e-6
GELU = "none"


class PatchEmbed(nn.Module):
    """(B, 3, S, S) -> (B, (S / patch)^2, width): non-overlapping patches,
    each flattened in (channel, row, column) order, times ``proj``'s
    weight read as a (width, 3 * patch^2) matrix."""

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, width, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        p = self.patch
        rows = (x.reshape(b, c, h // p, p, w // p, p)
                .permute(0, 2, 4, 1, 3, 5)
                .reshape(b, (h // p) * (w // p), c * p * p))
        weight = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        return F.linear(rows, weight, self.proj.bias)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        b, n, c = t.shape
        qkv = (self.qkv(t).reshape(b, n, 3, self.heads, c // self.heads)
               .permute(2, 0, 3, 1, 4))
        a = F.scaled_dot_product_attention(
            qkv[0], qkv[1], qkv[2], scale=(c // self.heads) ** -0.5)
        return self.proj(a.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, width: int, mlp: int):
        super().__init__()
        self.fc1 = nn.Linear(width, mlp)
        self.fc2 = nn.Linear(mlp, width)

    def forward(self, t: torch.Tensor, drop) -> torch.Tensor:
        return self.fc2(drop(F.gelu(self.fc1(t), approximate=GELU)))


class Block(nn.Module):
    def __init__(self, width: int, heads: int, mlp: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=EPS)
        self.attn = Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=EPS)
        self.mlp = Mlp(width, mlp)

    def forward(self, t: torch.Tensor, drop) -> torch.Tensor:
        with span("srt.vit.attn_block"):
            t = t + drop(self.attn(self.norm1(t)))
        with span("srt.vit.mlp_block"):
            return t + drop(self.mlp(self.norm2(t), drop))


class ViT(nn.Module):
    """The backbone: (B, 3, H, W) normalized images -> (B, width)
    features."""

    forwards = 0
    rows_forwarded = 0

    def __init__(self, width: int = 768, depth: int = 12, heads: int = 12,
                 mlp: int = 3072, patch: int = 16, input_size: int = 224,
                 drop_rate: float = 0.0):
        super().__init__()
        if input_size % patch or width % heads:
            raise ValueError(f"ViT: {input_size} px in {patch} px patches, "
                             f"width {width} over {heads} heads")
        self.width, self.input_size = width, input_size
        self.drop_rate = drop_rate
        self.patch_embed = PatchEmbed(width, patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (input_size // patch) ** 2 + 1, width))
        self.blocks = nn.ModuleList(Block(width, heads, mlp)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(width, eps=EPS)
        # timm's initialization; the benchmark draws its own weights
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        nn.init.normal_(self.cls_token, std=1e-6)
        for m in self.blocks.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)

    @property
    def feature_dim(self) -> int:
        return self.width

    def forward(self, x: torch.Tensor,
                sample_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``sample_mask`` marks the rows of a padded batch that the
        resnet's train-mode BatchNorm statistics cover.  A ViT takes no
        batch statistic (LayerNorm normalizes each token alone), so each
        row's feature depends on that row only and the mask has nothing
        to act on.  ``generator`` draws the train-mode dropout masks."""
        with span("srt.vit.forward"):
            ViT.forwards += 1
            ViT.rows_forwarded += x.shape[0]
            rate = self.drop_rate if self.training else 0.0

            def drop(t):
                return dropout(t, rate, generator) if rate > 0 else t

            with span("srt.vit.embed"):
                if x.shape[-1] != self.input_size:
                    x = F.interpolate(x, size=(self.input_size,) * 2,
                                      mode="bilinear", align_corners=False,
                                      antialias=False)
                t = self.patch_embed(x)
                t = torch.cat([self.cls_token.expand(t.shape[0], -1, -1),
                               t], 1)
                t = drop(t + self.pos_embed)
            for blk in self.blocks:
                t = blk(t, drop)
            return self.norm(t[:, 0])


def vit_b16(avg_pool: bool = False, drop_rate: float = 0.0,
            dropblock_size: int = 5, no_dropblock: bool = False,
            dtype=None, width: int = 768, depth: int = 12, heads: int = 12,
            mlp: int = 3072, patch: int = 16, input_size: int = 224,
            img_size: int = 84, **_) -> ViT:
    """The factory's builder: ViT-B/16 at its published sizes unless
    given others by name.  ``img_size``, the side of the images handed
    over, is read off each input (a side other than ``input_size`` is
    resized); ``avg_pool``, ``dropblock_size`` and ``no_dropblock`` are
    the resnets' (the feature is the class token's; there is no
    DropBlock)."""
    if dtype is not None and dtype != torch.float32:
        raise NotImplementedError(
            f"vit_b16 runs in f32 only, not {dtype}: users start from "
            "published weights and do not pretrain it here")
    return ViT(width=width, depth=depth, heads=heads, mlp=mlp, patch=patch,
               input_size=input_size, drop_rate=drop_rate)
