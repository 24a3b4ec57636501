"""A throwaway backbone of another architecture than the resnet, for the
test that a configuration of a new architecture enters the benchmark as
new files and entries alone: a patch embedding, a class token, one
pre-LayerNorm block (multi-head self-attention, a GELU MLP) and a final
LayerNorm; the feature is the class token's row.  Its plain reference is
``standin_reference.py``.  ``build`` takes the port's factory's
arguments, as a builder of ``models.resnet.model_dict`` does."""

import torch
import torch.nn.functional as F
from torch import nn


class StandIn(nn.Module):
    def __init__(self, width: int, patch: int, heads: int, mlp: int,
                 img_size: int, eps: float):
        super().__init__()
        self.feature_dim = width
        self.patch_embed = nn.Conv2d(3, width, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (img_size // patch) ** 2 + 1, width))
        self.norm1 = nn.LayerNorm(width, eps=eps)
        self.attn = nn.MultiheadAttention(width, heads, batch_first=True)
        self.norm2 = nn.LayerNorm(width, eps=eps)
        self.fc1 = nn.Linear(width, mlp)
        self.fc2 = nn.Linear(mlp, width)
        self.norm = nn.LayerNorm(width, eps=eps)

    def forward(self, x, sample_mask=None, generator=None):
        t = self.patch_embed(x).flatten(2).transpose(1, 2)
        t = torch.cat([self.cls_token.expand(t.shape[0], -1, -1), t], 1)
        t = t + self.pos_embed
        h = self.norm1(t)
        t = t + self.attn(h, h, h, need_weights=False)[0]
        t = t + self.fc2(F.gelu(self.fc1(self.norm2(t))))
        return self.norm(t)[:, 0]


def build(width: int = 32, patch: int = 4, heads: int = 2, mlp: int = 64,
          img_size: int = 32, eps: float = 1e-6, dtype=None,
          **_) -> StandIn:
    if dtype is not None:
        raise NotImplementedError("the stand-in runs in f32 only")
    return StandIn(width, patch, heads, mlp, img_size, eps)
