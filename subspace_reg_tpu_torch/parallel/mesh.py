"""Data- and class-parallel pretraining on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``: a 2-D
``('data', 'model')`` mesh over the ranks of one process group (one
process a card under ``torchrun``; NCCL for CUDA ranks, gloo for CPU
ranks).  Rank ``r`` sits at data index ``r // n_model`` and model index
``r % n_model``, as the JAX mesh lays its devices out.

* ``data``: each data index takes its rows of the global batch.  The
  BatchNorm statistics and DropBlock's normalization are reduced over the
  data group (models/layers.py::cross_replica), the gradients are reduced
  to the global-batch mean, and the random draws are those of the global
  batch (engine/pretrain.py), so a sharded step equals the single-device
  step on the same global batch.
* ``model``: the classifier's rows are split over the model group; each
  rank computes its classes' logits and the logits are gathered along
  the classes before the loss.

The state is replicated: every rank holds the whole backbone, head and
optimizer, and the reduced gradients keep the copies identical.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


@dataclass
class Mesh:
    n_data: int
    n_model: int
    rank: int
    world_size: int
    data_index: int
    model_index: int
    data_group: Any             # ranks with this rank's model index
    model_group: Any            # ranks with this rank's data index
    world_group: Any
    device: torch.device


def _group(ranks, world, timeout):
    """A process group over ``ranks``; every rank must create every group
    in the same order.  The whole world is the default group."""
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks, timeout=timeout)


def init_distributed(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group (NCCL for ``cuda``, gloo for ``cpu``) from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) or from the given ``init_method``,
    ``rank`` and ``world_size``.  Returns this rank's device: ``cuda:<LOCAL
    RANK>`` on CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {}
        if rank is not None:
            kw = dict(rank=rank, world_size=world_size)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or "env://",
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def under_torchrun() -> bool:
    """True in a process that ``torchrun`` started."""
    return "TORCHELASTIC_RUN_ID" in os.environ or (
        "LOCAL_RANK" in os.environ and "WORLD_SIZE" in os.environ)


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                device=None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The mesh over every rank of the initialized process group;
    ``n_data`` defaults to world size // ``n_model``, and n_data x n_model
    must be the world size.  ``device`` is this rank's device (default:
    the current CUDA device under NCCL, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs an initialized process group "
                           "(init_distributed or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} does not cover the "
                         f"{world} ranks")
    timeout = datetime.timedelta(seconds=timeout_s)
    data_groups = [_group([d * n_model + m for d in range(n_data)], world,
                          timeout) for m in range(n_model)]
    model_groups = [_group([d * n_model + m for m in range(n_model)], world,
                           timeout) for d in range(n_data)]
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    d, m = rank // n_model, rank % n_model
    return Mesh(n_data=n_data, n_model=n_model, rank=rank, world_size=world,
                data_index=d, model_index=m, data_group=data_groups[m],
                model_group=model_groups[d], world_group=dist.group.WORLD,
                device=torch.device(device))


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n``: the data axis splits
    the leading dimension into equal shards."""
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.n_data} data ranks")
    per = n // mesh.n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each array (tensor or numpy) of a global
    batch."""
    out = tuple(a[batch_sharding(mesh, len(a))] for a in arrays)
    return out if len(out) > 1 else out[0]


def head_sharding(mesh: Mesh, n_cls: int) -> slice:
    """This rank's rows of an ``n_cls``-row classifier: the model axis
    splits the classes into shards of ceil(n_cls / n_model)."""
    per = -(-n_cls // mesh.n_model)
    lo = min(mesh.model_index * per, n_cls)
    return slice(lo, min(lo + per, n_cls))


def replicated(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` made equal on every rank: rank 0's value, broadcast in
    place."""
    if mesh.world_size > 1:
        dist.broadcast(tensor, src=0, group=mesh.world_group)
    return tensor


def replicate_tree(mesh: Mesh, tree):
    """Every tensor of a nested dict / list / tuple, or of a module's
    state dict, broadcast in place from rank 0."""
    if isinstance(tree, torch.nn.Module):
        replicate_tree(mesh, tree.state_dict())
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            replicate_tree(mesh, v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate_tree(mesh, v)
    elif isinstance(tree, torch.Tensor):
        with torch.no_grad():
            replicated(mesh, tree)
    return tree


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` whose gradient is the sum of the ranks'
    gradients: every rank's loss depends on every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Autograd-aware sum of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


class _GatherClasses(torch.autograd.Function):
    """(B, c) logits of this rank's class shard -> (B, n_cls) logits of
    every class.  The gather is an all-reduce of zero-padded shards
    (gloo reduces CUDA tensors but does not gather them).  Every rank of
    the group computes the same loss from the gathered logits, so the
    backward keeps this rank's columns only; the ranks' partial backbone
    gradients are summed with the others (``reduce_gradients``)."""

    @staticmethod
    def forward(ctx, local, group, n_model, index, n_cls):
        per = -(-n_cls // n_model)
        ctx.cols = (index * per, index * per + local.shape[1])
        full = local.new_zeros((local.shape[0], per * n_model))
        full[:, ctx.cols[0]:ctx.cols[1]] = local
        dist.all_reduce(full, group=group)
        return full[:, :n_cls]

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.cols[0]:ctx.cols[1]], None, None, None, None


def gather_classes(mesh: Mesh, local: torch.Tensor,
                   n_cls: int) -> torch.Tensor:
    if mesh.n_model == 1:
        return local
    return _GatherClasses.apply(local, mesh.model_group, mesh.n_model,
                                mesh.model_index, n_cls)


def reduce_gradients(mesh: Mesh, params) -> None:
    """Sum every gradient over the world in one flat all-reduce and divide
    by the data ranks: the global batch's mean gradient (the model ranks
    of one data index each hold a part of it)."""
    if mesh.world_size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.world_group)
    if mesh.n_data > 1:
        flat.div_(mesh.n_data)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n


def mean_over_data(mesh: Mesh, values: torch.Tensor) -> torch.Tensor:
    """The mean of per-rank ``values`` over the data group (the global
    batch's mean of equal shards' means)."""
    if mesh.n_data == 1:
        return values
    values = values.clone()
    dist.all_reduce(values, group=mesh.data_group)
    return values / mesh.n_data


def group_size(group) -> int:
    """The ranks in ``group`` (1 for None, the process without a
    mesh)."""
    return 1 if group is None else dist.get_world_size(group)


def reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place (no autograd; no-op for
    None)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` stacked along the rows in rank
    order (equal shapes on every rank), without autograd: an all-reduce
    of zero-padded shards, exact because each element has one non-zero
    term (gloo reduces CUDA tensors but does not gather them)."""
    if group is None:
        return x
    n, r = x.shape[0], dist.get_rank(group)
    full = x.new_zeros((n * dist.get_world_size(group),) + x.shape[1:])
    full[r * n:(r + 1) * n] = x
    dist.all_reduce(full, group=group)
    return full


def lane_devices(n_seeds: int, shard_over_devices: Union[bool, Sequence],
                 device):
    """(devices, seed -> device index): the layout of the seed axis that
    both multi-seed engines (evaluation and pretraining) use.
    ``shard_over_devices=True`` spreads the seeds over the visible CUDA
    devices (for ``device`` a card; the CPU is one device), a sequence of
    devices over those, in contiguous seed blocks over the largest
    divisor of S that fits, as the JAX engines lay the seed axis out.
    Each device holds its own copy of its seeds' state and data."""
    device = torch.device(device)
    if shard_over_devices is False or shard_over_devices is None:
        return [device], [0] * n_seeds
    if shard_over_devices is True:
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if device.type == "cuda" else [device])
    else:
        devs = [torch.device(d) for d in shard_over_devices]
    n_dev = max(d for d in range(1, len(devs) + 1) if n_seeds % d == 0)
    per = n_seeds // n_dev
    return devs[:n_dev], [i // per for i in range(n_seeds)]


def rows_of(generator, n_global: int, rows: slice):
    """A draw callable (models/layers.py::uniform) that draws the global
    batch's uniforms from ``generator`` and returns this rank's rows, so
    the dropout and DropBlock masks equal the single-device step's."""
    from ..models.layers import uniform

    def draw(shape, device):
        return uniform((n_global,) + tuple(shape[1:]), generator,
                       device)[rows]
    return draw

