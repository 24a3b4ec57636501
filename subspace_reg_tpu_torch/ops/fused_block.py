"""The fused BasicBlock of stages 1-2 (K2 + K3), an autograd Function.

Counterpart of ``subspace_reg_tpu/ops/fused_block.py``.  For the
pretraining step only, it replaces the module composition of
``models/resnet.py::BasicBlock``:

    y1=conv1(x); x2=lrelu(bn1(y1)); y2=conv2(x2); x3=lrelu(bn2(y2));
    y3=conv3(x3); r=ds_bn(ds_conv(x)); out=maxpool2(lrelu(bn3(y3)+r))

Train-mode BN normalizes with the biased batch variance of the ROUNDED conv
output; the caller updates the running statistics from the returned
``BlockStats`` (models/fused_forward.py).  LeakyReLU slope 0.1; max-pool
2x2, floor mode, first-max gradient routing through K3's int8 record.

Backends (the JAX package's names, so the step's signature maps one to one):

* ``"pallas"``: the hand-written kernels -- K2 (``conv3x3_fused``) for the
  three 3x3 convolutions with the BN affine + LeakyReLU in their prologue and
  the batch statistics in their epilogue, K3 (``block_tail``) for the tail.
  On CPU tensors the kernels' plain versions run.
* ``"xla"``: the same program as plain torch ops (library convolutions in
  the working dtype, separate BN/activation passes, the tail written out as
  the JAX package's XLA backend writes it).

The 1x1 downsample is a torch convolution in both, as the JAX package
leaves it to XLA.  The working dtype is x's: bf16 in the pretraining step,
f32 for gradient checks (the kernels take bf16 only; f32 runs on the CPU).

The backward is the JAX package's hand-derived rule (``_block_bwd_rule``):
the idx-record unpool, the train-mode BN backward, and the convolutions'
dgrad/wgrad as torch's convolution backward (cuDNN on the card), recomputing
the cheap BN/activation inputs of conv2/conv3.  ``need_dx=False`` (the image
entry) skips the dgrad of conv1 and of the downsample and returns no input
gradient.  The statistics are outputs that carry no gradient.

Under a data mesh (``group``) each rank holds its rows of the global
batch and every BN statistic is the global batch's, as GSPMD makes them
in the JAX package: the sums of each K2 epilogue are all-reduced between
the launches (the next K2's prologue takes the global affine), and the
backward reduces its BN sums likewise.  The kernels do not change.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import leaky_relu
from ..parallel.mesh import group_size, reduce_sum_
from . import conv_fused as cf

CL = torch.channels_last
BACKENDS = ("pallas", "xla")


class BlockStats(NamedTuple):
    """Per-BN (mean, biased var) of this step's batch."""
    bn1: Tuple[torch.Tensor, torch.Tensor]
    bn2: Tuple[torch.Tensor, torch.Tensor]
    bn3: Tuple[torch.Tensor, torch.Tensor]
    ds_bn: Tuple[torch.Tensor, torch.Tensor]


def block_params(block) -> Tuple[torch.Tensor, ...]:
    """(w1, w2, w3, wd, g1, b1, g2, b2, g3, b3, gd, bd) of a BasicBlock with
    a downsample."""
    ds_conv, ds_bn = block.downsample[0], block.downsample[1]
    return (block.conv1.weight, block.conv2.weight, block.conv3.weight,
            ds_conv.weight, block.bn1.weight, block.bn1.bias,
            block.bn2.weight, block.bn2.bias, block.bn3.weight,
            block.bn3.bias, ds_bn.weight, ds_bn.bias)


def _chan(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def _affine_act(y, mean, var, scale, bias):
    """x_next = lrelu(bn(y)) in y's dtype (JAX ``_affine_act``)."""
    a, b = cf.bn_affine(mean, var, scale, bias)
    return leaky_relu(y * _chan(a.to(y.dtype)) + _chan(b.to(y.dtype)))


def _sum_stats(y: torch.Tensor) -> torch.Tensor:
    yf = y.to(torch.float32)
    return torch.stack([yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))])


def _conv1x1(x, wd):
    return F.conv2d(x, wd.to(x.dtype)).contiguous(memory_format=CL)


def _forward_pallas(x, p, group=None):
    w1, w2, w3, wd, g1, b1, g2, b2, g3, b3, gd, bd = p
    b, _, h, w = x.shape
    # the statistics of each K2 epilogue are summed over the data group
    # before they fold into the next launch's prologue affine
    n = b * h * w * group_size(group)
    y1, st1 = cf.conv3x3_fused(x, w1)
    m1, v1 = cf.fold_stats(reduce_sum_(st1, group), n)
    y2, st2 = cf.conv3x3_fused(y1, w2, cf.bn_affine(m1, v1, g1, b1), True)
    m2, v2 = cf.fold_stats(reduce_sum_(st2, group), n)
    y3, st3 = cf.conv3x3_fused(y2, w3, cf.bn_affine(m2, v2, g2, b2), True)
    m3, v3 = cf.fold_stats(reduce_sum_(st3, group), n)
    dsr = _conv1x1(x, wd)
    md, vd = cf.fold_stats(reduce_sum_(_sum_stats(dsr), group), n)
    pooled, idx = cf.block_tail(y3, dsr, cf.bn_affine(m3, v3, g3, b3),
                                cf.bn_affine(md, vd, gd, bd))
    return pooled, idx, (y1, y2, y3, dsr), (m1, v1, m2, v2, m3, v3, md, vd)


def _forward_xla(x, p, group=None):
    w1, w2, w3, wd, g1, b1, g2, b2, g3, b3, gd, bd = p
    dt = x.dtype

    def conv(v, wt):
        return F.conv2d(v, wt.to(dt), padding=1).contiguous(memory_format=CL)

    def stats_of(y):
        yf = y.to(torch.float32)
        if group is None:
            m = yf.mean((0, 2, 3))
            return m, torch.clamp_min((yf * yf).mean((0, 2, 3)) - m * m,
                                      0.0)
        # the global batch's: Σy, Σy² summed over the data group
        return cf.fold_stats(reduce_sum_(_sum_stats(y), group),
                             yf.numel() // yf.shape[1] * group_size(group))

    y1 = conv(x, w1)
    m1, v1 = stats_of(y1)
    y2 = conv(_affine_act(y1, m1, v1, g1, b1), w2)
    m2, v2 = stats_of(y2)
    y3 = conv(_affine_act(y2, m2, v2, g2, b2), w3)
    m3, v3 = stats_of(y3)
    dsr = _conv1x1(x, wd)
    md, vd = stats_of(dsr)
    a3, c3 = cf.bn_affine(m3, v3, g3, b3)
    ad, cd = cf.bn_affine(md, vd, gd, bd)
    # the JAX XLA backend's order: ((y3*a3 + b3) + dsr*ad) + bd
    o = leaky_relu(y3 * _chan(a3.to(dt)) + _chan(c3.to(dt))
                   + dsr * _chan(ad.to(dt)) + _chan(cd.to(dt)))
    c0, c1 = o[:, :, 0::2, 0::2], o[:, :, 0::2, 1::2]
    c2, c3_ = o[:, :, 1::2, 0::2], o[:, :, 1::2, 1::2]
    m01, m23 = torch.maximum(c0, c1), torch.maximum(c2, c3_)
    mx = torch.maximum(m01, m23)
    low = torch.where(m23 > m01, torch.where(c3_ > c2, 3, 2),
                      (c1 > c0).to(torch.int64))
    idx = (low + torch.where(mx >= 0, 4, 0)).to(torch.int8)
    return (mx.contiguous(memory_format=CL), idx.contiguous(memory_format=CL),
            (y1, y2, y3, dsr), (m1, v1, m2, v2, m3, v3, md, vd))


def _bn_bwd(g_z, y, mean, var, scale, group=None, eps=1e-5):
    """Train-mode BN backward; returns (g_y, g_scale, g_bias).  Under a
    data ``group`` the statistics were the global batch's, so g_y takes
    the global Σg, Σg·x̂ and count; g_scale and g_bias stay this rank's
    sums, which the gradient all-reduce (parallel/mesh.py::
    reduce_gradients) adds up once."""
    inv = torch.rsqrt(var + eps)
    a = scale * inv
    gf = g_z.to(torch.float32)
    xhat = (y.to(torch.float32) - _chan(mean)) * _chan(inv)
    s1 = gf.sum((0, 2, 3))
    s2 = (gf * xhat).sum((0, 2, 3))
    n = gf.numel() // gf.shape[1]
    t1, t2 = s1, s2
    if group is not None:
        t1, t2 = reduce_sum_(torch.stack([s1, s2]), group)
        n *= group_size(group)
    g_y = _chan(a / n) * (n * gf - _chan(t1) - xhat * _chan(t2))
    return g_y.to(g_z.dtype), s2, s1


def _lrelu_bwd(g, act):
    """lrelu'(z) from the activation (sign-preserving), 1 at exactly 0."""
    one = torch.ones((), dtype=g.dtype, device=g.device)
    slope = torch.tensor(0.1, dtype=g.dtype, device=g.device)
    return g * torch.where(act >= 0, one, slope)


def _conv_bwd(x, w, g_y, padding: int, need_dx: bool):
    """(dgrad or None, wgrad) of ``conv2d(x, w)`` in x's dtype."""
    gx, gw, _ = torch.ops.aten.convolution_backward(
        g_y, x, w, None, [1, 1], [padding, padding], [1, 1], False, [0, 0],
        1, [need_dx, True, False])
    return gx, gw


class _FusedBlock(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, need_dx, backend, group, *params):
        fwd = _forward_pallas if backend == "pallas" else _forward_xla
        pooled, idx, acts, stats = fwd(x, params, group)
        ctx.need_dx, ctx.group = need_dx, group
        ctx.save_for_backward(x, *acts, idx, *stats, *params)
        ctx.mark_non_differentiable(*stats)
        return (pooled,) + tuple(stats)

    @staticmethod
    def backward(ctx, g_out, *_unused):
        x, y1, y2, y3, dsr, idx, *rest = ctx.saved_tensors
        m1, v1, m2, v2, m3, v3, md, vd = rest[:8]
        w1, w2, w3, wd, g1, b1, g2, b2, g3, b3, gd, bd = rest[8:]
        dt, group = y1.dtype, ctx.group
        # ---- tail: unpool + lrelu through the idx record -----------------
        g = g_out.to(dt)
        low = idx & 3
        slope = torch.where((idx & 4) != 0,
                            torch.ones((), dtype=dt, device=g.device),
                            torch.tensor(0.1, dtype=dt, device=g.device))
        gs = g * slope
        zero = torch.zeros((), dtype=dt, device=g.device)
        g_opre = torch.zeros_like(y3)
        for k, (r, c) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            g_opre[:, :, r::2, c::2] = torch.where(low == k, gs, zero)
        # ---- bn3 / ds_bn ---------------------------------------------------
        g_y3, gg3, gb3 = _bn_bwd(g_opre, y3, m3, v3, g3, group)
        g_dsr, ggd, gbd = _bn_bwd(g_opre, dsr, md, vd, gd, group)
        # ---- conv3, bn2, conv2, bn1 ----------------------------------------
        x3 = _affine_act(y2, m2, v2, g2, b2)
        g_x3, gw3 = _conv_bwd(x3, w3.to(dt), g_y3, 1, True)
        g_y2, gg2, gb2 = _bn_bwd(_lrelu_bwd(g_x3, x3), y2, m2, v2, g2,
                                 group)
        x2 = _affine_act(y1, m1, v1, g1, b1)
        g_x2, gw2 = _conv_bwd(x2, w2.to(dt), g_y2, 1, True)
        g_y1, gg1, gb1 = _bn_bwd(_lrelu_bwd(g_x2, x2), y1, m1, v1, g1,
                                 group)
        # ---- conv1 and the downsample ---------------------------------------
        g_xc, gw1 = _conv_bwd(x, w1.to(dt), g_y1, 1, ctx.need_dx)
        g_xd, gwd = _conv_bwd(x, wd.to(dt), g_dsr, 0, ctx.need_dx)
        g_x = g_xc + g_xd if ctx.need_dx else None
        grads = (gw1, gw2, gw3, gwd, gg1, gb1, gg2, gb2, gg3, gb3, ggd, gbd)
        params = (w1, w2, w3, wd, g1, b1, g2, b2, g3, b3, gd, bd)
        return (g_x, None, None, None) + tuple(
            gr.to(pr.dtype) for gr, pr in zip(grads, params))


def fused_block_apply(x: torch.Tensor, block, need_dx: bool = True,
                      backend: str = "pallas", group=None
                      ) -> Tuple[torch.Tensor, BlockStats]:
    """Apply the fused block (a BasicBlock with a downsample, stride 2) to
    x (B, Cin, H, W) in the working dtype.  Returns (pooled (B, Cout, H/2,
    W/2) channels_last, BlockStats).  ``backend``: ``"pallas"`` runs the
    hand-written kernels K2/K3, ``"xla"`` the same program as torch ops.
    ``group`` (a data-parallel process group, parallel/mesh.py) makes
    every batch statistic the global batch's: the forward's Σy, Σy² and
    the backward's Σg, Σg·x̂ are summed over its ranks."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    out, *st = _FusedBlock.apply(x.contiguous(memory_format=CL), need_dx,
                                 backend, group, *block_params(block))
    return out, BlockStats((st[0], st[1]), (st[2], st[3]), (st[4], st[5]),
                           (st[6], st[7]))
