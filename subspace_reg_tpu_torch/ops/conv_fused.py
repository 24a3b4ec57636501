"""K2 and K3: the fused stage-1/2 block's 3x3 convolution and block tail.

Counterparts of ``subspace_reg_tpu/ops/pallas/conv_fused.py``:

* ``conv3x3_pair`` (K2) becomes ``conv3x3_fused``: a 3x3 convolution
  (stride 1, padding 1, no bias) whose prologue applies the previous BN's
  folded affine and LeakyReLU(0.1) to the input, with the zero halo applied
  after the activation, and whose epilogue emits the per-channel sum and sum
  of squares of the bf16-rounded output;
* ``block_tail`` (K3): ``o = lrelu((y3*a3 + b3) + (r*ad + bd))``, a 2x2
  stride-2 max-pool with first-max tie-breaking, and an int8 record per
  pooled element (bits 0-1: the winner, row*2 + col; bit 2: the winner is
  >= 0) for the backward pass;
* ``fold_stats`` and ``bn_affine``.

Layout.  Tensors are NCHW at the interface and NHWC in memory
(``torch.channels_last``), which is what the kernels read and write.  The
TPU's paired ``(B, H, W/2, 2C)`` layout, its packed weights and the 3 -> 4
channel pad are lane tricks of the TPU's matrix unit and do not carry over:
weights come in as OIHW f32 and affines as per-channel ``(C,)`` vectors.

Rounding.  bf16 arithmetic rounds after every operation, as the JAX package
does: the prologue is ``bf16(bf16(x*a) + b)`` with ``a``, ``b`` and the
slope 0.1 rounded to bf16 first.  The plain versions compute each operation
in f32 from bf16 values and round to bf16 after it; the kernels use the
same f32 operations with round-to-nearest intrinsics and no contraction into
FMA.

``conv3x3_fused`` and ``block_tail`` launch the hand-written CUDA kernels
(``csrc/conv3x3_fused.cu``, ``csrc/block_tail.cu``) for CUDA tensors and
run the plain versions for CPU tensors; a CUDA call launches the kernel or
raises.  Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
CL = torch.channels_last
# the kernels' limits (csrc/conv3x3_fused.cu: MAX_NTILES * 8 output channels)
MAX_COUT = 160

Affine = Tuple[torch.Tensor, torch.Tensor]


def _round(v: torch.Tensor, dtype) -> torch.Tensor:
    """Round an f32 value to ``dtype`` and back (identity for f32)."""
    return v.to(dtype).to(torch.float32)


def _const(value: float, dtype) -> float:
    """A scalar constant as the working type holds it (bf16(0.1) for bf16)."""
    return float(torch.tensor(value, dtype=dtype))


def _cvec(v: torch.Tensor, dtype) -> torch.Tensor:
    """A per-channel f32 vector rounded to ``dtype``, shaped for NCHW."""
    return _round(v.to(torch.float32), dtype).reshape(1, -1, 1, 1)


def affine_act_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     relu: bool) -> torch.Tensor:
    """``act(x*a + b)`` in x's dtype: a and b rounded to it, one rounding
    per operation; LeakyReLU(0.1) as ``max(z, z*0.1)``."""
    dt = x.dtype
    z = _round(x.to(torch.float32) * _cvec(a, dt), dt)
    z = _round(z + _cvec(b, dt), dt)
    if relu:
        m = _round(z * _const(0.1, dt), dt)
        z = torch.where(m > z, m, z)
    return z.to(dt)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def conv3x3_fused_plain(x: torch.Tensor, w: torch.Tensor,
                        affine: Optional[Affine] = None,
                        relu_in: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's function in plain torch.  x (B, Cin, H, W) in the working type
    (bf16, or f32 for gradient checks); w (Cout, Cin, 3, 3) f32, rounded to
    the working type.  Returns (y (B, Cout, H, W) channels_last in the
    working type, stats (2, Cout) f32 = (sum y, sum y^2) of the rounded
    y).  The convolution runs in f64 and rounds once: the products of bf16
    values and their sums are exact to far below a bf16 ulp, so y is the
    exact result rounded, and the kernel's f32 accumulation is measured
    against it alone."""
    dt = x.dtype
    if affine is not None:
        x = affine_act_plain(x, affine[0], affine[1], relu_in)
    elif relu_in:
        x = affine_act_plain(x, torch.ones(x.shape[1], device=x.device),
                             torch.zeros(x.shape[1], device=x.device), True)
    y = F.conv2d(x.to(torch.float64),
                 _round(w.to(torch.float32), dt).to(torch.float64),
                 padding=1).to(torch.float32).to(dt).contiguous(
                     memory_format=CL)
    yf = y.to(torch.float32)
    stats = torch.stack([yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))])
    return y, stats


def block_tail_plain(y3: torch.Tensor, res: torch.Tensor, aff3: Affine,
                     affd: Affine) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain torch: (pooled (B, C, H/2, W/2) channels_last
    in the working type, idx (B, C, H/2, W/2) int8 channels_last)."""
    dt = y3.dtype
    f32 = torch.float32
    t = _round(_round(y3.to(f32) * _cvec(aff3[0], dt), dt)
               + _cvec(aff3[1], dt), dt)
    u = _round(_round(res.to(f32) * _cvec(affd[0], dt), dt)
               + _cvec(affd[1], dt), dt)
    o = _round(t + u, dt)
    m = _round(o * _const(0.1, dt), dt)
    o = torch.where(m > o, m, o)
    c0, c1 = o[:, :, 0::2, 0::2], o[:, :, 0::2, 1::2]
    c2, c3 = o[:, :, 1::2, 0::2], o[:, :, 1::2, 1::2]
    # strict comparisons: the first maximum in window order wins
    t01, t23 = c1 > c0, c3 > c2
    m01 = torch.where(t01, c1, c0)
    m23 = torch.where(t23, c3, c2)
    tm = m23 > m01
    mx = torch.where(tm, m23, m01)
    low = torch.where(tm, 2 + t23.to(torch.int8), t01.to(torch.int8))
    idx = (low + 4 * (mx >= 0).to(torch.int8)).to(torch.int8)
    return (mx.to(dt).contiguous(memory_format=CL),
            idx.contiguous(memory_format=CL))


def fold_stats(stats: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(2, C) (sum, sum of squares) over n elements per channel ->
    (mean, biased variance), the variance as E[y^2] - mean^2 clamped at 0."""
    mean = stats[0] / n
    var = torch.clamp_min(stats[1] / n - mean * mean, 0.0)
    return mean, var


def bn_affine(mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor, eps: float = 1e-5) -> Affine:
    """Per-channel (a, b) with ``bn(y) = y*a + b``."""
    a = torch.rsqrt(var + eps) * scale
    return a, bias - mean * a


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------
def _fn(kernel: str, symbol: str, n_ptr: int, n_int: int):
    from ..utils.cuda_build import load
    fn = getattr(load(kernel), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_act(name: str, t: torch.Tensor, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != BF16:
        raise ValueError(f"{name} is {t.dtype}; the kernel takes bf16")
    if t.dim() != 4 or not t.is_contiguous(memory_format=CL):
        raise ValueError(f"{name} must be a 4-d channels_last tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_vec(name: str, t: torch.Tensor, c: int, device) -> torch.Tensor:
    if t.device != device or tuple(t.shape) != (c,):
        raise ValueError(f"{name} must be a ({c},) tensor on {device}")
    return t.to(torch.float32).contiguous()


def _launch_failed(name: str, err: int):
    raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def conv3x3_fused(x: torch.Tensor, w: torch.Tensor,
                  affine: Optional[Affine] = None, relu_in: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: see ``conv3x3_fused_plain`` for the function.  CUDA tensors:
    x bf16 channels_last, w (Cout, Cin, 3, 3) with Cout a multiple of 8 up
    to 160; the weights are cast to bf16 once per call."""
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, w, affine, relu_in)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fused: unsupported device {x.device}")
    dev = x.device
    _check_act("conv3x3_fused: x", x, dev)
    b, cin, h, wd = x.shape
    if w.device != dev or w.dim() != 4 or tuple(w.shape[1:]) != (cin, 3, 3):
        raise ValueError(f"conv3x3_fused: w must be (Cout, {cin}, 3, 3) "
                         f"on {dev}, got {tuple(w.shape)}")
    cout = w.shape[0]
    if cout % 8 or cout > MAX_COUT:
        raise ValueError(f"conv3x3_fused: Cout {cout} must be a multiple of "
                         f"8 up to {MAX_COUT}")
    if cin > MAX_COUT:
        raise ValueError(f"conv3x3_fused: Cin {cin} above {MAX_COUT}")
    a = bb = None
    if affine is not None:
        a = _check_vec("conv3x3_fused: affine scale", affine[0], cin, dev)
        bb = _check_vec("conv3x3_fused: affine shift", affine[1], cin, dev)
    # (9, Cout, Cin): one tap's weights are a contiguous (Cout, Cin) matrix
    wt = w.to(BF16).permute(2, 3, 0, 1).reshape(9, cout, cin).contiguous()
    y = torch.empty((b, cout, h, wd), dtype=BF16, device=dev,
                    memory_format=CL)
    n_blk = b * -(-h // 8) * -(-wd // 16)
    partials = torch.empty((2, cout, n_blk), dtype=torch.float32, device=dev)
    stats = torch.empty((2, cout), dtype=torch.float32, device=dev)
    err = _fn("conv3x3_fused", "k2_conv3x3_fused", 7, 7)(
        _ptr(x), _ptr(wt), _ptr(a), _ptr(bb), _ptr(y), _ptr(partials),
        _ptr(stats), b, h, wd, cin, cout, int(relu_in), n_blk,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _launch_failed("conv3x3_fused", err)
    conv3x3_fused.launches += 1
    return y, stats


conv3x3_fused.launches = 0


def block_tail(y3: torch.Tensor, res: torch.Tensor, aff3: Affine,
               affd: Affine) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: see ``block_tail_plain`` for the function.  CUDA tensors: y3 and
    res bf16 channels_last of one shape with even H and W."""
    if y3.device.type == "cpu":
        return block_tail_plain(y3, res, aff3, affd)
    if y3.device.type != "cuda":
        raise ValueError(f"block_tail: unsupported device {y3.device}")
    dev = y3.device
    _check_act("block_tail: y3", y3, dev)
    _check_act("block_tail: res", res, dev)
    if res.shape != y3.shape:
        raise ValueError("block_tail: y3 and res differ in shape")
    b, c, h, w = y3.shape
    if h % 2 or w % 2:
        raise ValueError("block_tail: H and W must be even")
    vecs = [_check_vec(f"block_tail: {n}", v, c, dev) for n, v in
            (("a3", aff3[0]), ("b3", aff3[1]), ("ad", affd[0]),
             ("bd", affd[1]))]
    out = torch.empty((b, c, h // 2, w // 2), dtype=BF16, device=dev,
                      memory_format=CL)
    idx = torch.empty((b, c, h // 2, w // 2), dtype=torch.int8, device=dev,
                      memory_format=CL)
    err = _fn("block_tail", "k3_block_tail", 8, 4)(
        _ptr(y3), _ptr(res), *(_ptr(v) for v in vecs), _ptr(out), _ptr(idx),
        b, h, w, c, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _launch_failed("block_tail", err)
    block_tail.launches += 1
    return out, idx


block_tail.launches = 0
