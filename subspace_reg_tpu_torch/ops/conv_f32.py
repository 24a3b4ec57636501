"""K4: the backbone's f32 convolution without gradients.

A stride-1, same-padded 3x3 or 1x1 convolution without bias in f32, the
function of ``nn.Conv2d`` in ``models/resnet.py::BasicBlock``, for the
forwards that need no gradient: the evaluation's epoch-1, cached and base
forwards, every f32 no-grad forward of ``ResNetRFS``.  ``conv_f32``
launches the hand-written CUDA kernel (``csrc/conv_f32.cu``, an implicit
GEMM on FFMA) for CUDA tensors and runs ``conv_f32_plain``, the same
arithmetic in plain torch, for CPU tensors.  There is no fallback between
the two: a CUDA call launches the kernel or raises.  It replaces no TPU
kernel: the JAX package leaves its convolutions to XLA.

Layout: activations are channels_last (NHWC in memory), in and out, so the
element-wise work between convolutions keeps that layout.  An
NCHW-contiguous input (the first layer's images) is converted in the
call; channels are padded with zeros to a multiple of 4 (the first layer's
3 to 4).  The weight is laid out K-major, (R*R*Cin, Cout) with k = (r*R +
s)*Cin + c, on every call (~50 MB of copies for resnet18's 22 weights).

Routing (``wanted``): an f32 call with no gradient to compute, either
because autograd is off or because neither operand requires one.  The
training forwards (bf16 pretraining, the general freeze's f32 epochs with
gradients into the backbone) keep ``F.conv2d``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

CL = torch.channels_last
# the kernel's instances, in the order of csrc/conv_f32.cu::K4_INSTANCES:
# (warps along M, warps along N, k tile depth); the tile is (64 WM) x (32 WN)
K4_CONFIGS = ((2, 2, 16), (4, 1, 16), (2, 2, 4))
# each instance's share of the FP32 peak on an H100 at resnet18's 3x3
# convolutions at 1000 rows (64 or 320 output channels for 128 x 64, 160
# for 256 x 32; the k tile of 4 serves the first layer alone)
K4_SHARE = (0.675, 0.668, 0.32)
_INT_MAX = 2 ** 31 - 1


def wanted(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """True where a convolution of ``x`` by ``weight`` goes to
    ``conv_f32``: both f32, and no gradient to compute."""
    return (x.dtype == torch.float32 and weight.dtype == torch.float32
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or weight.requires_grad)))


def conv_f32_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: per tap (r, s), in k order,
    the shifted NHWC pixels times that tap's (Cin, Cout) weight, summed in
    f32.  Returns (B, Cout, H, W) channels_last."""
    b, c, h, w = x.shape
    n, _, r, _ = weight.shape
    p = r // 2
    xp = F.pad(x.permute(0, 2, 3, 1), (0, 0, p, p, p, p))
    wk = weight.permute(2, 3, 1, 0)
    y = None
    for i in range(r):
        for j in range(r):
            term = xp[:, i:i + h, j:j + w, :].reshape(-1, c) @ wk[i, j]
            y = term if y is None else y + term
    return y.reshape(b, h, w, n).permute(0, 3, 1, 2)


@dataclass(frozen=True)
class ConvPlan:
    """One launch: the instance (index into K4_CONFIGS), its tile, the
    tiles and the persistent grid."""
    config: int
    bm: int
    bn: int
    tiles: int
    grid: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=512)
def conv_f32_plan(m: int, n: int, c: int, n_sm: int,
                  occupancy: Tuple[int, ...]) -> ConvPlan:
    """The instance for an (M pixels) x (N channels) output with C (padded)
    input channels on a card of ``n_sm`` SMs, where ``occupancy[i]`` blocks
    of instance i fit on one SM: among the instances whose k tile divides
    C (16, else 4), the least time of the busiest SM, ceil(tiles / SMs)
    tiles of BM x BN at the instance's share of the peak (K4_SHARE), the
    first instance on a tie.  The grid holds every resident block, at most
    one a tile."""
    bk = 16 if c % 16 == 0 else 4
    best = None
    for i, (wm, wn, k) in enumerate(K4_CONFIGS):
        if k != bk or occupancy[i] < 1:
            continue
        bm, bn = 64 * wm, 32 * wn
        tiles = _cdiv(m, bm) * _cdiv(n, bn)
        key = _cdiv(tiles, n_sm) * bm * bn / K4_SHARE[i]
        if best is None or key < best[0]:
            best = (key, ConvPlan(i, bm, bn, tiles,
                                  min(tiles, n_sm * occupancy[i])))
    if best is None:
        raise ValueError(f"conv_f32: no kernel instance fits C = {c}")
    return best[1]


def _fn(symbol: str, argtypes):
    from ..utils.cuda_build import load
    fn = getattr(load("conv_f32"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launch_failed(err: int):
    raise RuntimeError(f"conv_f32 kernel launch failed: cudaError {err}")


@functools.lru_cache(maxsize=None)
def _occupancy(dev: torch.device) -> Tuple[int, ...]:
    """Blocks of each instance resident on one SM of ``dev``."""
    fn = _fn("k4_conv_f32_occupancy",
             [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    out = []
    with torch.cuda.device(dev):
        for i in range(len(K4_CONFIGS)):
            blocks = ctypes.c_int(0)
            err = fn(i, ctypes.byref(blocks))
            if err != 0:
                _launch_failed(err)
            out.append(blocks.value)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _nhwc(x: torch.Tensor, c_pad: int) -> torch.Tensor:
    """``x`` (B, C, H, W) as a contiguous (B, H, W, c_pad) tensor: a view of
    a channels_last input, a copy of an NCHW-contiguous one (zero channels
    appended up to ``c_pad``)."""
    c = x.shape[1]
    xh = x.permute(0, 2, 3, 1)
    if c_pad != c:
        return F.pad(xh, (0, c_pad - c))
    return xh.contiguous()


def _k_major(weight: torch.Tensor, c_pad: int) -> torch.Tensor:
    """(Cout, Cin, R, R) -> the kernel's (R*R*c_pad, Cout): row (r*R + s) *
    c_pad + c, each aligned group of four output channels rotated by one,
    as (1, 2, 3, 0) (csrc/conv_f32.cu)."""
    n, c, r, _ = weight.shape
    if c_pad != c:
        weight = F.pad(weight, (0, 0, 0, 0, 0, c_pad - c))
    wk = weight.permute(2, 3, 1, 0).reshape(r * r * c_pad, n // 4, 4)
    return wk.roll(-1, 2).reshape(r * r * c_pad, n)


def conv_f32(x: torch.Tensor, weight: torch.Tensor, stride=1,
             padding=None) -> torch.Tensor:
    """K4: ``F.conv2d(x, weight, None, stride, padding)`` for a stride-1,
    same-padded (``padding`` = R // 2, the default) convolution by a
    (Cout, Cin, R, R) weight, R = 1 or 3, both f32.  CPU tensors run
    ``conv_f32_plain``; CUDA tensors launch the kernel (x channels_last or
    NCHW-contiguous, Cout a multiple of 4) or raise.  Returns (B, Cout, H,
    W) channels_last."""
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise ValueError(f"conv_f32: operands must be float32, got "
                         f"{x.dtype} and {weight.dtype}")
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[1] != x.shape[1]:
        raise ValueError(f"conv_f32: x (B, C, H, W) and weight (Cout, C, R, "
                         f"R) expected, got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    n, c, r, r2 = weight.shape
    if r != r2 or r not in (1, 3):
        raise ValueError(f"conv_f32: a 1x1 or 3x3 weight expected, got "
                         f"{r}x{r2}")
    pad = r // 2 if padding is None else padding
    if _pair(stride) != (1, 1) or _pair(pad) != (r // 2,) * 2:
        raise ValueError(f"conv_f32: stride 1 and padding {r // 2} only, got "
                         f"stride {stride} and padding {padding}")
    if not (x.is_contiguous(memory_format=CL) or x.is_contiguous()):
        raise ValueError("conv_f32: x must be channels_last or "
                         f"NCHW-contiguous, got strides {tuple(x.stride())}")
    if x.device != weight.device:
        raise ValueError(f"conv_f32: x on {x.device}, weight on "
                         f"{weight.device}")
    if x.device.type == "cpu":
        return conv_f32_plain(x, weight)
    if x.device.type != "cuda":
        raise ValueError(f"conv_f32: unsupported device {x.device}")
    if n % 4:
        raise ValueError(f"conv_f32: Cout {n} must be a multiple of 4")
    dev = x.device
    b, _, h, w = x.shape
    c_pad = _cdiv(c, 4) * 4
    m = b * h * w
    if max(m * c_pad, m * n, r * r * c_pad * n) > _INT_MAX:
        raise ValueError("conv_f32: an operand of 2^31 elements or more")
    xh = _nhwc(x, c_pad)
    wt = _k_major(weight, c_pad)
    y = torch.empty((b, h, w, n), dtype=torch.float32, device=dev)
    if m == 0:
        return y.permute(0, 3, 1, 2)
    if xh.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("conv_f32: x and y must be 16-byte aligned")
    plan = conv_f32_plan(m, n, c_pad, _sm_count(dev), _occupancy(dev))
    err = _fn("k4_conv_f32", [ctypes.c_int] + [ctypes.c_void_p] * 3
              + [ctypes.c_int] * 7 + [ctypes.c_void_p])(
        plan.config, xh.data_ptr(), wt.data_ptr(), y.data_ptr(), m, h, w,
        c_pad, n, r, plan.grid, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _launch_failed(err)
    conv_f32.launches += 1
    return y.permute(0, 3, 1, 2)


# launches of the kernel
conv_f32.launches = 0


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)
