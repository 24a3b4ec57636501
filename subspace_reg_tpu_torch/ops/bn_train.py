"""K5: train-mode BatchNorm, optionally followed by LeakyReLU(0.1), on bf16
activations on the card, forward and backward.

The function is ``TorchBatchNorm``'s train-mode bf16 chain (statistics in
f32, the single-pass biased variance clamped at 0, the running statistics
at momentum 0.1 with the unbiased ratio n/(n-1), the affine folded into a
bf16 scale and shift, two roundings) followed, when ``leaky``, by
``layers.leaky_relu``, and its gradient is autograd's through that chain,
bit for bit.  That chain, ``TorchBatchNorm._normalize`` then
``leaky_relu`` (models/layers.py), is K5's plain twin: every call K5 does
not take runs it.  The backward is derived by hand, so it has a plain twin
here, ``bn_train_backward_plain`` (autograd's backward of the chain, op
for op).  ``bn_train`` is one ``torch.autograd.Function`` for CUDA tensors
only: its forward and its backward each launch the hand-written kernel
pair of ``csrc/bn_train.cu`` or raise.  It replaces no TPU kernel: the
JAX package leaves BatchNorm to XLA, which fuses the chain.

The per-channel sums are torch's own reductions of the tensors the chain
reduces (forward: mean(f32(x)), and mean(f32(x)^2) of launch 1's squares;
backward: the sums of g and of bf16(g*x), which launch 1 writes, g the
gradient at the BatchNorm's output), taken between the two launches of a
direction: the single-pass variance cancels on inputs whose mean dwarfs
their spread (the benchmark's class-coloured images), and another order of
the sums flips bf16 scales and moves a pretraining step far beyond its
check's limits.  Everything else, per channel and per element, is the
kernels'.  The backward saves x and two per-channel vectors (the mean and
the mean of squares) and recomputes the LeakyReLU's mask from x.

Layout: x channels_last (C contiguous: the first stage's maps, as
``F.conv2d`` hands them on) or NCHW-contiguous (every map after a dropout,
whose mask is NCHW); y and dx come out in x's layout; any other stride
raises ``ValueError``, as do more than ``MAX_C`` channels, and a
channels_last row wider than a block (``k5_plan``).

Routing (``wanted``, asked of train-mode calls only): a bf16 CUDA tensor
without a ``sample_mask`` and outside ``cross_replica``.  Every other call
keeps ``TorchBatchNorm``'s own ops.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

BF16 = torch.bfloat16
CL = torch.channels_last
THREADS = 256
# channels a call may have: the channels_last kernels keep four floats a
# channel in shared memory (16 KB at 1,024), and csrc/bn_train.cu refuses
# more
MAX_C = 1024
AXES = (0, 2, 3)
_CHAN = (1, -1, 1, 1)


def _channel_vector_width(c: int, align: int = 16) -> int:
    """The channels a thread owns in the channels_last kernels: the
    largest of 8, 4, 2, 1 that divides C and whose bytes divide the
    pointers' common alignment ``align``."""
    return next(v for v in (8, 4, 2, 1) if c % v == 0 and align % (2 * v)
                == 0)


def wanted(x: torch.Tensor, sample_mask: Optional[torch.Tensor],
           sync_group) -> bool:
    """True where a train-mode BatchNorm of ``x`` goes to K5: bf16 on a
    CUDA card, no sample mask, no cross-replica group."""
    return (x.dtype == BF16 and x.is_cuda and sample_mask is None
            and sync_group is None)


def _slope(y: torch.Tensor) -> torch.Tensor:
    return torch.tensor(0.1, dtype=y.dtype, device=y.device)


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def bn_train_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                            mean: torch.Tensor, e2: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor,
                            eps: float = 1e-5, leaky: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """K5's backward in plain torch, from x, dy and the forward's mean and
    mean of squares: (dx, dweight, dbias), autograd's backward of the
    layer's chain (``TorchBatchNorm._normalize``, then ``leaky_relu`` if
    ``leaky``) op for op, in the order autograd's engine adds the gradients
    of a tensor used more than once.  An f64 x keeps its statistics in
    f64."""
    sdt = _stat_dtype(x)
    var_raw = e2 - mean * mean
    inv = torch.rsqrt(torch.clamp_min(var_raw, 0.0) + eps)
    mi = mean * inv
    a = (inv * weight).to(x.dtype).reshape(_CHAN)
    if leaky:
        b = (bias - mi * weight).to(x.dtype).reshape(_CHAN)
        z = x * a + b
        g = torch.where(z >= 0, dy, dy * _slope(dy))
    else:
        g = dy
    # the sums autograd takes to the (1, C, 1, 1) scale and shift
    db = g.sum(AXES, keepdim=True).reshape(-1).to(sdt)
    da = (g * x).sum(AXES, keepdim=True).reshape(-1).to(sdt)
    dmiw = -db
    dmi = dmiw * weight
    dinv = da * weight + dmi * mean
    dvar = -0.5 * dinv * inv.pow(3)
    dvar = torch.where(var_raw >= 0, dvar, torch.zeros_like(dvar))
    t = -dvar * mean
    dmean = (dmi * inv + t) + t
    n = x.numel() // x.shape[1]
    u = (dvar / n).reshape(_CHAN) * x.to(sdt)
    dxs = (u + u) + (dmean / n).reshape(_CHAN)
    dx = g * a + dxs.to(x.dtype)
    return dx, da * inv + dmiw * mi, db


# ---------------------------------------------------------------- the card

@dataclass(frozen=True)
class BNPlan:
    """One direction's two launches: ``layout`` 0 channels_last (``outer``
    rows of C, ``v`` channels a thread, ``parts`` blocks) or 1 NCHW
    (``outer`` images, ``inner`` = H*W, ``parts`` batch slices, a block
    per channel and slice)."""
    layout: int
    outer: int
    inner: int
    v: int
    parts: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def k5_plan(b: int, c: int, h: int, w: int, channels_last: bool, align: int,
            n_sm: int) -> BNPlan:
    """The plan for a (B, C, H, W) map on a card of ``n_sm`` SMs, its
    pointers aligned to ``align`` bytes.  Channels_last: at most one block
    per SM, each with at least 8 rows a thread (every block makes all C
    channels' constants); NCHW: C x S blocks, about 4 per SM."""
    if channels_last:
        rows = b * h * w
        v = _channel_vector_width(c, align)
        if c // v > THREADS:
            raise ValueError(f"bn_train: {c} channels at {v} a thread exceed "
                             f"{THREADS} threads a row")
        per_pass = THREADS // (c // v)
        return BNPlan(0, rows, 1, v,
                      max(1, min(n_sm, _cdiv(rows, 8 * per_pass))))
    return BNPlan(1, b, h * w, 1, max(1, min(b, _cdiv(4 * n_sm, c))))


_C = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
      "f": ctypes.c_float}
# each launcher's arguments: pointers, ints, 64-bit ints, floats, in order
# (csrc/bn_train.cu); the last is the stream
_SIGNATURES = {"k5_bn_square": "ppliip",
               "k5_bn_apply": "ppppppppiliiiiiffffp",
               "k5_bn_grad": "ppppppppiliiiiifp",
               "k5_bn_dx": "ppppppppppiliiiiiffp"}


def _fn(symbol: str):
    from ..utils.cuda_build import load
    fn = getattr(load("bn_train"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [_C[k] for k in _SIGNATURES[symbol]]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _is_cl(x: torch.Tensor) -> bool:
    """True for channels_last, False for NCHW-contiguous; raises for any
    other stride."""
    if x.is_contiguous(memory_format=CL):
        return True
    if x.is_contiguous():
        return False
    raise ValueError("bn_train: x must be channels_last or NCHW-contiguous, "
                     f"got strides {tuple(x.stride())}")


def _align(*ts: torch.Tensor) -> int:
    a = 16
    for t in ts:
        while t.data_ptr() % a:
            a //= 2
    return a


def _plan(x: torch.Tensor, cl: bool, *ts: torch.Tensor) -> BNPlan:
    b, c, h, w = x.shape
    return k5_plan(b, c, h, w, cl, _align(x, *ts), _sm_count(x.device))


def _call(symbol: str, *args) -> None:
    if len(args) != len(_SIGNATURES[symbol]):
        raise TypeError(f"{symbol}: {len(args)} arguments for "
                        f"{len(_SIGNATURES[symbol])}")
    err = _fn(symbol)(*args)
    if err != 0:
        raise RuntimeError(f"bn_train kernel launch failed ({symbol}): "
                           f"cudaError {err}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _k5_forward(x, weight, bias, running_mean, running_var, momentum, eps,
                leaky):
    """(y, mean, mean of squares) on the card: launch 1, torch's two means
    (the chain's own reductions), launch 2."""
    c = x.shape[1]
    cl = _is_cl(x)
    # x's own strides, as (x.to(float32) ** 2) keeps them: the reductions
    # see the tensors the chain reduces.  torch reduces bf16 x to an f32
    # mean in the order it reduces x.to(float32) (the card tests hold the
    # two bit-identical at every shape of the step)
    sq = torch.empty_like(x, dtype=torch.float32)
    n = x.numel()
    vec8 = n % 8 == 0 and _align(x) == 16 and sq.data_ptr() % 32 == 0
    _call("k5_bn_square", x.data_ptr(), sq.data_ptr(), n, int(vec8),
          min(_cdiv(n, THREADS * (8 if vec8 else 1)),
              8 * _sm_count(x.device)), _stream(x))
    mean = x.mean(AXES, dtype=torch.float32)
    e2 = sq.mean(AXES)
    del sq
    y = torch.empty_like(x)
    p = _plan(x, cl, y)
    count = float(n // c)
    _call("k5_bn_apply", x.data_ptr(), y.data_ptr(), weight.data_ptr(),
          bias.data_ptr(), mean.data_ptr(), e2.data_ptr(),
          running_mean.data_ptr(), running_var.data_ptr(), p.layout,
          p.outer, c, p.inner, p.v, p.parts, int(leaky), eps, momentum,
          1.0 - momentum, count / max(count - 1.0, 1.0), _stream(x))
    bn_train.launches += 2
    return y, mean, e2


def _k5_backward(x, dy, mean, e2, weight, bias, eps, leaky):
    """(dx, dweight, dbias) on the card: launch 1, torch's two sums (the
    ones autograd takes), launch 2."""
    c = x.shape[1]
    cl = _is_cl(x)
    if not dy.is_contiguous(memory_format=CL if cl else
                            torch.contiguous_format):
        dy = dy.contiguous(memory_format=CL if cl else
                           torch.contiguous_format)
    gx = torch.empty_like(x)
    g = torch.empty_like(x) if leaky else dy
    p = _plan(x, cl, dy, gx, g)
    args = (p.layout, p.outer, c, p.inner, p.v, p.parts, int(leaky), eps)
    _call("k5_bn_grad", x.data_ptr(), dy.data_ptr(), gx.data_ptr(),
          g.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
          e2.data_ptr(), *args, _stream(x))
    db = g.sum(AXES, keepdim=True)
    da = gx.sum(AXES, keepdim=True)
    del gx, g
    dx = torch.empty_like(x)
    dwb = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    n = x.numel() // c
    _call("k5_bn_dx", x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
          weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
          e2.data_ptr(), da.data_ptr(), db.data_ptr(), dwb.data_ptr(),
          *args, float(np.float32(1.0) / np.float32(n)), _stream(x))
    bn_train.launches += 2
    return dx, dwb[:c], dwb[c:]


class _BNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, leaky):
        y, mean, e2 = _k5_forward(x, weight, bias, running_mean,
                                  running_var, momentum, eps, leaky)
        ctx.save_for_backward(x, weight, bias, mean, e2)
        ctx.eps, ctx.leaky = eps, leaky
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, mean, e2 = ctx.saved_tensors
        dx, dw, db = _k5_backward(x, dy, mean, e2, weight, bias, ctx.eps,
                                  ctx.leaky)
        return dx, dw, db, None, None, None, None, None


def bn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             running_mean: torch.Tensor, running_var: torch.Tensor,
             momentum: float = 0.1, eps: float = 1e-5,
             leaky: bool = False) -> torch.Tensor:
    """K5: ``TorchBatchNorm``'s train-mode chain, then LeakyReLU(0.1) if
    ``leaky``, with ``bn_train_backward_plain``'s gradient; updates the
    running statistics in place.  x (B, C, H, W) bf16 on a CUDA card,
    channels_last or NCHW-contiguous, 1 to ``MAX_C`` channels; weight, bias
    and the running statistics (C,) contiguous float32 on x's device.  The
    forward and the backward each launch the kernel pair around two of
    torch's reductions (``bn_train.launches`` counts the kernels'
    launches, in a CUDA graph at each replay); any other operand raises
    ``ValueError``."""
    if x.dim() != 4:
        raise ValueError(f"bn_train: x (B, C, H, W) expected, got "
                         f"{tuple(x.shape)}")
    _is_cl(x)
    c = x.shape[1]
    if not 0 < c <= MAX_C:
        raise ValueError(f"bn_train: {c} channels; 1 to {MAX_C} taken")
    if x.dtype != BF16:
        raise ValueError(f"bn_train: x must be bfloat16, got {x.dtype}")
    if not x.is_cuda:
        raise ValueError(f"bn_train: x must be on a CUDA card, got "
                         f"{x.device}")
    if x.numel() == 0:
        raise ValueError("bn_train: empty x")
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.shape != (c,) or t.device != x.device:
            raise ValueError(f"bn_train: {name} must be ({c},) on "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"bn_train: {name} must be contiguous float32")
    return _BNTrain.apply(x, weight, bias, running_mean, running_var,
                          momentum, eps, leaky)


# launches of the kernels (two a forward, two a backward; torch's
# reductions between them not counted); a CUDA graph's count at each of
# its replays (engine/pretrain.py::StepRunner)
bn_train.launches = 0
