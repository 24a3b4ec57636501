"""NCE contrastive memory banks (reference distill/NCEAverage.py:8-381).

Counterpart of ``subspace_reg_tpu/distill/nce.py``.  The state holds two
momentum-updated memory banks (the views 'l' and 'ab'), the normalization
constants Z (-1 until the first batch sets them to mean(out) * N) and the
reference's parameter vector [K, T, -1, -1, momentum].  ``nce_forward``
is functional: it returns a new state whose banks are new tensors
(``index_copy`` out of place), and the input state is left as it was.  No
gradient reaches the banks; as in the JAX step, the gradient does flow
through Z on the batch that sets it.  Under a data mesh (``group``) Z is
set from the global batch's mean and every rank applies the global
batch's bank update, so the banks stay equal bit for bit on every rank.

The contrast is plain torch on the device, as it is XLA (not Pallas) in
the JAX package.  ``mode`` picks how the (B, K+1) dot products are formed;
every mode gives the same dot products:

* ``paired``: one (B, K+1, 2D) row gather from the feature-concatenated
  banks serves both views, then a batched product (the JAX package's
  ``auto``);
* ``gather``: one (B, K+1, D) row gather per bank;
* ``matmul``: the product against the whole bank, then
  ``take_along_dim`` at the sampled columns;
* ``auto``: ``CONTRAST_AUTO``.  On an H100 the NCE step (host-bound)
  reads the same in every form within its run-to-run spread, and matmul
  takes the least device time and memory (chip_smoke.py phase 16b times
  the call and the step in each form).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import all_reduce_sum, gather_rows, group_size

CONTRAST_MODES = ("auto", "paired", "gather", "matmul")
CONTRAST_AUTO = "matmul"


@dataclass
class NCEAverageState:
    memory_l: torch.Tensor     # (output_size, input_size)
    memory_ab: torch.Tensor
    z_l: torch.Tensor          # 0-d normalization constants (-1 = unset)
    z_ab: torch.Tensor
    params: torch.Tensor       # [K, T, Z_l, Z_ab, momentum] (reference)

    def to_jax(self):
        """The JAX state's state-dict form (numpy leaves)."""
        return {k: getattr(self, k).detach().cpu().numpy()
                for k in ("memory_l", "memory_ab", "z_l", "z_ab",
                          "params")}

    @classmethod
    def from_jax(cls, tree, device="cuda") -> "NCEAverageState":
        """The inverse of ``to_jax``."""
        return cls(**{k: torch.from_numpy(np.array(tree[k], np.float32)
                                          ).to(device)
                      for k in ("memory_l", "memory_ab", "z_l", "z_ab",
                                "params")})


def init_nce_average(generator: Optional[torch.Generator],
                     output_size: int, input_size: int, k: int,
                     temperature: float = 0.07, momentum: float = 0.5,
                     device="cuda") -> NCEAverageState:
    """Both banks uniform in +-1/sqrt(input_size/3), drawn from
    ``generator`` on its device and placed on ``device``."""
    stdv = 1.0 / (input_size / 3.0) ** 0.5
    on = device if generator is None else generator.device
    banks = [torch.empty((output_size, input_size), device=on).uniform_(
        -stdv, stdv, generator=generator).to(device) for _ in range(2)]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32,  # noqa: E731
                                 device=device)
    return NCEAverageState(
        memory_l=banks[0], memory_ab=banks[1], z_l=f32(-1.0),
        z_ab=f32(-1.0), params=f32([k, temperature, -1.0, -1.0, momentum]))


def _set_z(z: torch.Tensor, out: torch.Tensor, n: int,
           group=None) -> torch.Tensor:
    """Z, or mean(out) * n while Z is unset; under a data ``group`` the
    mean is the global batch's (equal shards), with its gradient."""
    if group is None:
        mean = out.mean()
    else:
        mean = all_reduce_sum(out.sum(), group) / (out.numel()
                                                   * group_size(group))
    return torch.where(z < 0, mean * n, z)


def _contrast(memory: torch.Tensor, v: torch.Tensor, idx: torch.Tensor,
              temperature: torch.Tensor, z: torch.Tensor, mode: str,
              group=None):
    """out[i, j] = exp(<memory[idx[i, j]], v[i]> / T) / Z."""
    if mode == "matmul":
        out = torch.take_along_dim(v @ memory.T, idx, dim=1)
    else:
        out = torch.einsum("bkd,bd->bk", memory[idx], v)
    out = torch.exp(out / temperature)
    z_new = _set_z(z, out, memory.shape[0], group)
    return out / z_new, z_new


def _contrast_paired(memory_ab, memory_l, l, ab, idx, temperature,
                     z_l, z_ab, group=None):
    """Both views' contrasts from one row gather of the
    feature-concatenated banks (the same idx on both sides)."""
    b, d = l.shape
    w = torch.cat([memory_ab, memory_l], dim=1)[idx]      # (B, K+1, 2D)
    v = torch.stack([l, ab], dim=1)                       # (B, 2, D)
    out = torch.exp(torch.einsum("bktd,btd->bkt",
                                 w.reshape(b, idx.shape[1], 2, d), v)
                    / temperature)
    out_l, out_ab = out[..., 0], out[..., 1]
    z_l = _set_z(z_l, out_l, memory_ab.shape[0], group)
    z_ab = _set_z(z_ab, out_ab, memory_l.shape[0], group)
    return out_l / z_l, out_ab / z_ab, z_l, z_ab


def _update_bank(memory: torch.Tensor, v: torch.Tensor, y: torch.Tensor,
                 momentum: torch.Tensor) -> torch.Tensor:
    """Momentum, L2 renorm, and the rows at ``y`` replaced, in a new
    tensor."""
    with torch.no_grad():
        new = memory[y] * momentum + v.detach() * (1.0 - momentum)
        norm = torch.linalg.vector_norm(new, dim=1, keepdim=True)
        return memory.index_copy(0, y, new / torch.clamp_min(norm, 1e-12))


def _updated(state: NCEAverageState, l, ab, y, z_l, z_ab, group=None):
    """The state after the bank update; under a data ``group`` the update
    is the global batch's (every rank's rows gathered in rank order), so
    every rank's banks stay equal bit for bit."""
    momentum = state.params[4]
    if group is not None:
        l, ab, y = (gather_rows(t.detach(), group) for t in (l, ab, y))
    return replace(state,
                   memory_l=_update_bank(state.memory_l, l, y, momentum),
                   memory_ab=_update_bank(state.memory_ab, ab, y, momentum),
                   z_l=z_l.detach(), z_ab=z_ab.detach())


def nce_forward_full(state: NCEAverageState, l: torch.Tensor,
                     ab: torch.Tensor, y: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, NCEAverageState]:
    """The contrast against the whole bank (reference NCEAverageFull /
    NCEAverageFullSoftmax, distill/NCEAverage.py:144-381): (B,
    output_size) similarities per view, with the same bank update.
    out_l contrasts l with the ab bank, out_ab ab with the l bank."""
    t = state.params[1]
    out_l = torch.exp(l @ state.memory_ab.T / t)
    out_ab = torch.exp(ab @ state.memory_l.T / t)
    z_l = _set_z(state.z_l, out_l, state.memory_l.shape[0])
    z_ab = _set_z(state.z_ab, out_ab, state.memory_ab.shape[0])
    return out_l / z_l, out_ab / z_ab, _updated(state, l, ab, y, z_l, z_ab)


def full_softmax_loss(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over full-bank similarities: the positive is the
    own-index column."""
    logp = torch.log(torch.clamp_min(out, 1e-20))
    logp = logp - torch.log(torch.sum(out, dim=1, keepdim=True))
    return -torch.mean(torch.gather(logp, 1, y[:, None].long()))


def nce_forward(state: NCEAverageState, l: torch.Tensor, ab: torch.Tensor,
                y: torch.Tensor, idx: Optional[torch.Tensor] = None,
                mode: str = "auto", sampler=None,
                generator: Optional[torch.Generator] = None, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor, NCEAverageState]:
    """Contrast both views against K negatives and the positive; returns
    (out_l, out_ab, new state).  ``idx`` (B, K+1) holds the bank rows,
    slot 0 the positive; without it K negatives are drawn from
    ``sampler`` (an ``AliasSampler``) with ``generator`` and slot 0 set
    to ``y``.  ``mode`` is one of ``CONTRAST_MODES``.  ``group``: the
    data-parallel group whose global batch sets Z and updates the banks
    (the rows here are this rank's)."""
    if mode not in CONTRAST_MODES:
        raise ValueError(f"unknown NCE contrast mode {mode!r}; expected one "
                         f"of {CONTRAST_MODES}")
    y = y.long()
    if idx is None:
        k = int(state.params[0])
        idx = sampler.draw(generator, (l.shape[0], k + 1))
        idx[:, 0] = y
    idx = idx.long()
    t = state.params[1]
    if mode == "auto":
        mode = CONTRAST_AUTO
    # reference orientation (NCEAverage.py forward): out_l contrasts the l
    # view against the ab bank, and the other way round
    if mode == "paired":
        out_l, out_ab, z_l, z_ab = _contrast_paired(
            state.memory_ab, state.memory_l, l, ab, idx, t, state.z_l,
            state.z_ab, group)
    else:
        out_l, z_l = _contrast(state.memory_ab, l, idx, t, state.z_l, mode,
                               group)
        out_ab, z_ab = _contrast(state.memory_l, ab, idx, t, state.z_ab,
                                 mode, group)
    return out_l, out_ab, _updated(state, l, ab, y, z_l, z_ab, group)
