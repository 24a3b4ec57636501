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
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
CL = torch.channels_last
# K2's limits and layout, mirrored from csrc/conv3x3_fused.cu: output widths
# padded to one of K2_WIDTHS, halo rows padded by K2_CPAD bf16, the packed
# weights' core matrices K2_LBO bytes apart along K and K2_SBO along N
MAX_COUT = 160
K2_WIDTHS = (64, 160)
K2_CPAD = 8
K2_LBO = 128
K2_SBO = 256
# K chunks of 16 input channels in one weight unit; dynamic shared memory
# of one block
K2_KG = 5
K2_SMEM_MAX = 232448
# K3's limits, mirrored from csrc/block_tail.cu: threads a block may have,
# resident blocks per SM its register budget allows and vector widths (bf16
# channels a thread owns)
K3_THREADS = 256
K3_MIN_BLOCKS = 4
K3_WIDTHS = (8, 4, 2, 1)

Affine = Tuple[torch.Tensor, torch.Tensor]


class K2Plan(NamedTuple):
    """How K2 covers one call.  ``tiles`` tiles per image, each ``m_tile``
    = ``nc`` x 64 consecutive flat positions of the image read at the
    padded width ``wp`` = W + 2 (``nc`` consumer warpgroups of 64 rows);
    ``grid`` persistent blocks walk the ``n_blk`` = B x tiles tiles.
    Output widths padded to ``n_pad``, input channels to ``cin_pad``;
    ``stages`` weight slots of one unit (up to 5 K chunks of 16 of one
    tap), all 9 taps held for the block's life when ``resident``;
    ``nbuf`` halo buffers (2: the next tile's halo is in flight during this
    tile's math); ``smem`` bytes of shared memory per block."""
    n_pad: int
    cin_pad: int
    wp: int
    nc: int
    m_tile: int
    stages: int
    resident: bool
    nbuf: int
    tiles: int
    n_blk: int
    grid: int
    smem: int


class K3Plan(NamedTuple):
    """How K3 covers one call.  Each thread owns ``v`` consecutive channels
    of one pooled pixel; a block is ``gx`` channel groups x ``py`` pooled
    pixels; the C / v channel groups fall into ``gtiles`` tiles of gx.
    Pixel p of the batch is pooled row q = p // (W/2) (b*H/2 + ph), which
    reads input rows 2q and 2q + 1.  One launch of ``grid`` persistent
    blocks walks the tiles t = group tile * pixel tiles + pixel tile,
    block k taking t = k, k + grid, ..."""
    v: int
    gx: int
    py: int
    gtiles: int
    grid: int


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


def _check_act(name: str, t: torch.Tensor, device, align: int = 16):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != BF16:
        raise ValueError(f"{name} is {t.dtype}; the kernel takes bf16")
    if t.dim() != 4 or not t.is_contiguous(memory_format=CL):
        raise ValueError(f"{name} must be a 4-d channels_last tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary")


def _check_vec(name: str, t: torch.Tensor, c: int, device) -> torch.Tensor:
    if t.device != device or tuple(t.shape) != (c,):
        raise ValueError(f"{name} must be a ({c},) tensor on {device}")
    return t.to(torch.float32).contiguous()


def _launch_failed(name: str, err: int):
    raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _k2_units(cin_pad: int) -> Tuple[int, int]:
    """(K chunks of 16 in one weight unit, units in the 9 taps)."""
    kch = cin_pad // 16
    kgn = min(kch, K2_KG)
    return kgn, 9 * -(-kch // kgn)


def k2_smem_bytes(n_pad: int, cin_pad: int, stages: int, nc: int,
                  nbuf: int, w: int) -> int:
    """Shared memory of one K2 block (csrc/conv3x3_fused.cu::layout): the
    weight ring, the halo buffers, the bf16 affine table, the statistics
    scratch, the mbarriers (of the ring slots and the two halo buffers)."""
    ring = stages * _k2_units(cin_pad)[0] * 16 * n_pad * 2
    halo = nbuf * (nc * 64 + 2 * (w + 2) + 2) * (cin_pad + K2_CPAD) * 2
    return (ring + halo + cin_pad * 4 + nc * 4 * 2 * n_pad * 4
            + (2 * stages + 4) * 8)


@functools.lru_cache(maxsize=256)
def k2_plan(b: int, h: int, w: int, cin: int, cout: int,
            n_sm: int = 132) -> K2Plan:
    """K2's launch plan on a card of ``n_sm`` SMs: one persistent block per
    SM of consumer warpgroups and two producer warpgroups, as many consumer
    warpgroups (3 at 64 output channels, 2 at 160) and
    weight slots (all units, if they fit) as one block's shared memory
    holds with two halo buffers, then with one; fewer warpgroups, then a
    single slot, where a wide image leaves no room.  Raises if even that
    does not fit."""
    n_pad = next(n for n in K2_WIDTHS if cout <= n)
    cin_pad = -(-cin // 16) * 16
    units = _k2_units(cin_pad)[1]
    max_nc = 3 if n_pad == 64 else 2
    for least in (2, 1):
        for nc in range(max_nc, 0, -1):
            for nbuf in ((2, 1) if cin % 8 == 0 else (1,)):
                stages = next(
                    (s for s in range(units, least - 1, -1)
                     if k2_smem_bytes(n_pad, cin_pad, s, nc, nbuf, w)
                     <= K2_SMEM_MAX), None)
                if stages is None:
                    continue
                m_tile = nc * 64
                tiles = -(-(h * (w + 2)) // m_tile)
                return K2Plan(
                    n_pad, cin_pad, w + 2, nc, m_tile, stages,
                    stages >= units, nbuf, tiles, b * tiles,
                    min(b * tiles, n_sm),
                    k2_smem_bytes(n_pad, cin_pad, stages, nc, nbuf, w))
    raise ValueError(f"conv3x3_fused: a {w}-pixel-wide image with {cin} "
                     "input channels does not fit K2's shared memory")


def pack_k2_weights(w: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(Cout, Cin, 3, 3) weights -> bf16 (9, Cin/16, n_pad/8, 2, 8, 8), the
    shared-memory image of each tap's wgmma B operand: for tap kh*3 + kw,
    K chunk of 16 input channels, group of 8 output channels and half of
    the chunk, one 8 x 8 core matrix (8 output channels x 16 bytes of
    input channels).  Element (tap, n, k) lies at byte
    tap*cin_pad*n_pad*2 + (k//16)*(n_pad//8)*K2_SBO + (n//8)*K2_SBO
    + ((k%16)//8)*K2_LBO + (n%8)*16 + (k%8)*2.  Output channels are padded
    to ``n_pad`` and input channels to a multiple of 16 with zeros."""
    cout, cin = w.shape[:2]
    cin_pad = -(-cin // 16) * 16
    if (cout, cin) != (n_pad, cin_pad):
        w = F.pad(w, (0, 0, 0, 0, 0, cin_pad - cin, 0, n_pad - cout))
    # (n/8, n%8, k/16, (k%16)/8, k%8, kh, kw) -> (kh, kw, k/16, n/8,
    # (k%16)/8, n%8, k%8), cast to bf16 in the same copy
    src = w.view(n_pad // 8, 8, cin_pad // 16, 2, 8, 3, 3).permute(
        5, 6, 2, 0, 3, 1, 4)
    out = torch.empty((9, cin_pad // 16, n_pad // 8, 2, 8, 8), dtype=BF16,
                      device=w.device)
    out.view(3, 3, cin_pad // 16, n_pad // 8, 2, 8, 8).copy_(src)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _sm_threads(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(
        dev).max_threads_per_multi_processor


def k3_width(c: int, ptrs: Tuple[int, int, int, int]) -> int:
    """K3's vector width: the largest of K3_WIDTHS that divides C, with
    y3, r and out (bf16) aligned to 2V bytes and idx (int8) to V bytes.
    ``ptrs``: the four data pointers (y3, r, out, idx)."""
    for v in K3_WIDTHS:
        if (c % v == 0 and all(p % (2 * v) == 0 for p in ptrs[:3])
                and ptrs[3] % v == 0):
            return v
    raise ValueError("block_tail: a bf16 operand is not 2-byte aligned")


def k3_plan(b: int, h: int, w: int, c: int,
            ptrs: Tuple[int, int, int, int] = (0, 0, 0, 0),
            n_sm: int = 132, sm_threads: int = 2048) -> K3Plan:
    """K3's launch plan for (B, C, H, W) operands at ``ptrs`` (y3, r, out,
    idx) on a card of ``n_sm`` SMs of ``sm_threads`` threads: the vector
    width (``k3_width``), blocks of up to K3_THREADS threads (all C / v
    channel groups of up to ``py`` pixels, or tiles of K3_THREADS groups
    where there are more), and a grid of as many blocks as the
    SMs hold resident (K3_MIN_BLOCKS each, fewer where a block's threads
    fill the SM), at most one per tile."""
    return _k3_plan(b, h, w, c, k3_width(c, ptrs), n_sm, sm_threads)


@functools.lru_cache(maxsize=256)
def _k3_plan(b: int, h: int, w: int, c: int, v: int, n_sm: int,
             sm_threads: int) -> K3Plan:
    groups = c // v
    gx = min(groups, K3_THREADS)
    py = K3_THREADS // gx
    gtiles = -(-groups // gx)
    tiles = -(-b * (h // 2) * (w // 2) // py) * gtiles
    resident = n_sm * max(1, min(K3_MIN_BLOCKS, sm_threads // (gx * py)))
    return K3Plan(v, gx, py, gtiles, min(tiles, resident))


def conv3x3_fused(x: torch.Tensor, w: torch.Tensor,
                  affine: Optional[Affine] = None, relu_in: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: see ``conv3x3_fused_plain`` for the function.  CUDA tensors:
    x bf16 channels_last, w (Cout, Cin, 3, 3) with Cout a multiple of 8 up
    to 160; the weights are cast to bf16 and packed once per call
    (``pack_k2_weights``)."""
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
    plan = k2_plan(b, h, wd, cin, cout, _sm_count(dev))
    wt = pack_k2_weights(w, plan.n_pad)
    y = torch.empty((b, cout, h, wd), dtype=BF16, device=dev,
                    memory_format=CL)
    partials = torch.empty((2, cout, plan.n_blk * plan.nc),
                           dtype=torch.float32, device=dev)
    stats = torch.empty((2, cout), dtype=torch.float32, device=dev)
    err = _fn("conv3x3_fused", "k2_conv3x3_fused", 7, 11)(
        _ptr(x), _ptr(wt), _ptr(a), _ptr(bb), _ptr(y), _ptr(partials),
        _ptr(stats), b, h, wd, cin, cout, int(relu_in), plan.nc,
        plan.stages, plan.nbuf, plan.grid, plan.n_blk,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _launch_failed("conv3x3_fused", err)
    conv3x3_fused.launches += 1
    return y, stats


conv3x3_fused.launches = 0


def _k3_operands(y3: torch.Tensor, res: torch.Tensor, aff3: Affine,
                 affd: Affine):
    """A K3 call's checked operands on the card and its outputs, allocated
    here: (the four affine vectors as f32, out, idx)."""
    dev = y3.device
    _check_act("block_tail: y3", y3, dev, align=2)
    _check_act("block_tail: res", res, dev, align=2)
    if res.shape != y3.shape:
        raise ValueError("block_tail: y3 and res differ in shape")
    b, c, h, w = y3.shape
    if h % 2 or w % 2:
        raise ValueError("block_tail: H and W must be even")
    if not y3.numel():
        raise ValueError("block_tail: empty operands")
    vecs = [_check_vec(f"block_tail: {n}", v, c, dev) for n, v in
            (("a3", aff3[0]), ("b3", aff3[1]), ("ad", affd[0]),
             ("bd", affd[1]))]
    out = torch.empty((b, c, h // 2, w // 2), dtype=BF16, device=dev,
                      memory_format=CL)
    idx = torch.empty((b, c, h // 2, w // 2), dtype=torch.int8, device=dev,
                      memory_format=CL)
    return vecs, out, idx


def _k3_launch(y3, res, vecs, out, idx) -> None:
    """K3's launch on checked operands, with no allocation (the kernel-alone
    timer calls it too), by ``k3_plan`` for this card; counts it in
    ``block_tail.launches``."""
    b, c, h, w = y3.shape
    dev = y3.device
    ptrs = (y3.data_ptr(), res.data_ptr(), out.data_ptr(), idx.data_ptr())
    plan = k3_plan(b, h, w, c, ptrs, _sm_count(dev), _sm_threads(dev))
    err = _fn("block_tail", "k3_block_tail", 8, 8)(
        *ptrs[:2], *(_ptr(v) for v in vecs), *ptrs[2:], b, h // 2, w // 2, c,
        plan.v, plan.gx, plan.py, plan.grid,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _launch_failed("block_tail", err)
    block_tail.launches += 1


def block_tail(y3: torch.Tensor, res: torch.Tensor, aff3: Affine,
               affd: Affine) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: see ``block_tail_plain`` for the function.  CUDA tensors: y3 and
    res bf16 channels_last of one shape with even H and W; the launch plan
    is ``k3_plan``."""
    if y3.device.type == "cpu":
        return block_tail_plain(y3, res, aff3, affd)
    if y3.device.type != "cuda":
        raise ValueError(f"block_tail: unsupported device {y3.device}")
    vecs, out, idx = _k3_operands(y3, res, aff3, affd)
    _k3_launch(y3, res, vecs, out, idx)
    return out, idx


block_tail.launches = 0
