"""Projection heads for contrastive distillation (reference
distill/util.py:6-57).

Counterpart of ``subspace_reg_tpu/distill/embed.py``.  The JAX heads are
flax ``Dense`` layers: kernel (in, out) drawn from lecun_normal (a normal
of variance 1/fan_in truncated at two standard deviations), bias zero.
These ``nn.Linear`` layers are initialized from the same distribution and
keep torch's (out, in) weight; ``embed_from_jax`` / ``embed_to_jax`` carry
a head's flax parameter tree (``{"linear": {"kernel", "bias"}}``, or
``linear1``/``linear2`` for ``MLPEmbed``) into the module and back.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

# flax's truncated_normal stddev correction for truncation at +-2
_TRUNC_STD = 0.87962566103423978


def l2_normalize(x: torch.Tensor, power: int = 2) -> torch.Tensor:
    """Reference Normalize module: x / (sum |x|^p)^(1/p)."""
    norm = torch.sum(torch.abs(x) ** power, dim=1,
                     keepdim=True) ** (1.0 / power)
    return x / torch.clamp_min(norm, 1e-12)


def _dense(d_in: int, d_out: int,
           generator: Optional[torch.Generator]) -> nn.Linear:
    layer = nn.Linear(d_in, d_out)
    std = math.sqrt(1.0 / d_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


class Embed(nn.Module):
    """Linear + L2 norm (reference Embed)."""
    layers = ("linear",)

    def __init__(self, dim_in: int, dim_out: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = _dense(dim_in, dim_out, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.linear(x.reshape(x.shape[0], -1)))


class LinearEmbed(nn.Module):
    layers = ("linear",)

    def __init__(self, dim_in: int, dim_out: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = _dense(dim_in, dim_out, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1))


class MLPEmbed(nn.Module):
    """Two-layer MLP + L2 norm (reference MLPEmbed)."""
    layers = ("linear1", "linear2")

    def __init__(self, dim_in: int, dim_out: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear1 = _dense(dim_in, 2 * dim_out, generator)
        self.linear2 = _dense(2 * dim_out, dim_out, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.linear1(x.reshape(x.shape[0], -1)))
        return l2_normalize(self.linear2(x))


def embed_from_jax(module: nn.Module, params: Mapping[str, Any]) -> None:
    """Load a flax head's parameter tree (numpy or array leaves) into
    ``module`` in place: kernel (in, out) -> weight (out, in)."""
    with torch.no_grad():
        for name in module.layers:
            layer = getattr(module, name)
            p = params[name]
            layer.weight.copy_(torch.from_numpy(
                np.array(p["kernel"], np.float32).T))
            layer.bias.copy_(torch.from_numpy(np.array(p["bias"],
                                                       np.float32)))


def embed_to_jax(module: nn.Module, value=None) -> Dict[str, Any]:
    """``module``'s flax parameter tree as numpy: ``value(parameter)``
    (default: the parameter itself) of each layer, the weight transposed
    to the kernel's (in, out)."""
    if value is None:
        value = lambda p: p.detach().float().cpu().numpy()  # noqa: E731
    return {name: {"kernel": np.ascontiguousarray(
                       np.asarray(value(getattr(module, name).weight),
                                  np.float32).T),
                   "bias": np.asarray(value(getattr(module, name).bias),
                                      np.float32)}
            for name in module.layers}
