"""What the port's tests and chip_smoke.py share: the operands each kernel
is held at (K1-K5, at the main paths' shapes and at edge shapes) with
their agreement measures, the golden evaluation's flags and its small and
full-size inputs, pretraining states with the envelope that holds the
fused step against the module step, checkpoint readers, and the mesh
harness, whose ranks run this file as a script (``main``).

It imports torch, numpy and the port only: chip_smoke.py runs it on the
card's machine, which has no JAX.  The card's measurements and its
arithmetic (peaks, bounds) are chip_smoke.py's and benchmark/'s.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import datetime
import functools
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from subspace_reg_tpu_torch.parallel import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SESSIONS = 8

BATCH = 64

GOLDEN_ARGV = [
    "--model", "resnet18", "--no_dropblock", "--n_shots", "5",
    "--classifier", "linear", "--eval_mode", "few-shot-incremental-fine-tune",
    "--min_novel_epochs", "20", "--learning_rate", "0.002",
    "--freeze_backbone_at", "1", "--test_base_batch_size", "2000",
    "--continual", "--n_queries", "25", "--lmbd_reg_transform_w", "0.2",
    "--target_train_loss", "0.0", "--label_pull", "1.0",
    "--lmbd_reg_novel", "0.1", "--set_seed", "1",
    "--attraction_override", "distance2subspace",
    "--n_base_support_samples", "1", "--memory_replay", "1",
]


def check(cond, msg: str):
    if not cond:
        raise RuntimeError(msg)


# --------------------------------------------------------------------------
# K1 operands at the evaluation's shapes
# --------------------------------------------------------------------------

TIERED_BASE = 351


def k1_case(kind: str, device, max_epochs: int = 100, seed: int = 0,
            session: int = N_SESSIONS, stable_target: int = 10,
            orig_base: int = 60, feat: int = 640):
    """Operands of session ``session`` (1..8, default the last) of the
    golden run over ``orig_base`` base classes (60: miniImageNet and
    CIFAR; 351: tieredImageNet) at ``feat`` features (640: the resnets;
    768: ViT-B/16): orig_base + 5*session active classes of
    orig_base + 40, 125 novel support rows + one exemplar per base class,
    25*(session-1) of 200 replay rows, 5*(session-1) reserved rows.
    ``kind``: 'sgd' (subspace pull + memory), 'adam', 'bias' (the [W | b]
    layout, D = 641, no novel anchor), 'semantic' (the semantic pull) or
    'plain' (no pull, no memory).  A ``stable_target`` no run reaches makes
    the loop run to ``max_epochs``, as the golden run on random weights
    does."""
    from subspace_reg_tpu_torch.ops.finetune import LoopConfig, pack_scalars
    r = np.random.RandomState(seed)
    n_ways = 5
    cp, ns, nm = orig_base + 8 * n_ways, 125 + orig_base, 200
    n_active, mem_count = orig_base + 5 * session, 25 * (session - 1)
    bias, adam = kind == "bias", kind == "adam"
    memory_on = kind != "plain"
    pull_mode = {"semantic": "semantic", "plain": "none"}.get(kind,
                                                             "subspace")
    n_reserved = 0 if bias else 5 * (session - 1)
    d = feat + (1 if bias else 0)
    f32 = np.float32
    f_sup = (0.5 * np.abs(r.randn(ns, d))).astype(f32)
    f_mem = np.zeros((nm, d), f32)
    f_mem[:mem_count] = 0.5 * np.abs(r.randn(mem_count, d))
    if bias:
        f_sup[:, feat] = 1.0
        f_mem[:, feat] = 1.0
    y_sup = np.concatenate([np.repeat(np.arange(n_active - n_ways,
                                                n_active), 25),
                            np.arange(orig_base)]).astype(np.int32)
    y_mem = np.zeros(nm, np.int32)
    y_mem[:mem_count] = np.repeat(np.arange(orig_base, n_active - n_ways),
                                  5)
    k = 1.0 / math.sqrt(feat)
    w = r.uniform(-k, k, (cp, d)).astype(f32)
    w0 = np.zeros_like(w)
    w0[:orig_base] = w[:orig_base] + 0.01 * r.randn(orig_base, d)
    reserved = np.zeros_like(w)
    reserved[orig_base:orig_base + n_reserved] = (
        w[orig_base:orig_base + n_reserved]
        + 0.01 * r.randn(n_reserved, d))
    mom = (1e-3 * r.randn(cp, d)).astype(f32)
    nu = (1e-6 * r.rand(cp, d)).astype(f32)
    q, _ = np.linalg.qr(w0[:orig_base, :feat].T.astype(np.float64))
    pull_op = np.zeros((d, d), f32)
    pull_op[:feat, :feat] = np.eye(feat) - q @ q.T
    pull_tgt = np.zeros_like(w)
    pull_tgt[n_active - n_ways:n_active, :feat] = 0.05 * r.randn(n_ways, feat)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    ops = dict(f_sup=t(f_sup), y_sup=t(y_sup), f_mem=t(f_mem),
               y_mem=t(y_mem), w=t(w), mom=t(mom),
               nu=t(nu) if adam else None, w0=t(w0),
               reserved=None if bias else t(reserved),
               pull_op=t(pull_op) if pull_mode == "subspace" else None,
               pull_tgt=t(pull_tgt) if pull_mode == "semantic" else None)
    ops["scalars"] = pack_scalars(
        device, lr=0.002, wd=5e-4, momentum=0.9, lmbd_base=0.2,
        lmbd_novel=0.0 if bias else 0.1, gamma=1.0, eps=1e-4,
        target_loss=0.0, min_epochs=20, max_epochs=max_epochs,
        stable_target=stable_target, adam_b1=0.9, adam_b2=0.999,
        adam_eps=1e-8, prev_loss0=5.0, stable0=0.0)
    cfg = LoopConfig(n_sup=ns, mem_count=mem_count, n_active=n_active,
                     n_reserved=n_reserved, orig_base=orig_base,
                     n_ways=n_ways, memory_on=memory_on, use_regbase=True,
                     use_regnovel=not bias, pull_mode=pull_mode,
                     stable_mode=True,
                     trace_rows=((max_epochs + 2 + 7) // 8) * 8,
                     use_adam=adam, bias_col=feat if bias else None)
    return ops, cfg


def k1_seed_case(kind: str, device, n_seeds: int, max_epochs: int = 100,
                 stable_target: int = 10, stop=None, orig_base: int = 60):
    """S seeds of one geometry for the seed-batched K1: ``k1_case``'s
    operands drawn from seeds 0..S-1, stacked on a leading seed axis.
    ``stop`` = (seed, epochs) caps that seed's loop at ``epochs`` (its own
    max-epoch scalar), so its group stops while the others run.  Returns
    (stacked operands, the per-seed operands, the shared config)."""
    from subspace_reg_tpu_torch.ops.finetune import SCALARS
    per = []
    for s in range(n_seeds):
        ops, cfg = k1_case(kind, device, max_epochs=max_epochs, seed=s,
                           stable_target=stable_target, orig_base=orig_base)
        per.append(ops)
    if stop is not None:
        sc = per[stop[0]]["scalars"].clone()
        sc[SCALARS.index("max_epochs")] = float(stop[1])
        per[stop[0]]["scalars"] = sc
    stacked = {k: None if t is None else torch.stack([p[k] for p in per])
               for k, t in per[0].items()}
    return stacked, per, cfg


def check_k1_matches_plain(ops, cfg, out, acc_flips: int = 0) -> int:
    """K1's output ``out`` against its plain version on the same operands:
    epochs exact, max |dW| <= 1e-4, the last loss and accuracies to 1e-4
    relative, the loss of every epoch to rtol 1e-4, nothing traced past
    the last epoch.  The accuracies of every epoch agree to rtol 1e-4 too,
    except on at most ``acc_flips`` epochs, where they may differ by one
    support row: over a long run a support row's logits come within an
    ulp of a rival class's and the two sum orders may rank it either
    side.  Returns the epochs run."""
    from subspace_reg_tpu_torch.ops.finetune import finetune_loop_plain
    w_k, st_k, tr_k = out
    w_p, st_p, tr_p = finetune_loop_plain(**ops, cfg=cfg)
    torch.cuda.synchronize()
    ep = int(st_p[1])
    check(int(st_k[1]) == ep > 2,
          f"K1 ran {int(st_k[1])} epochs, its plain version {ep}")
    err = float((w_k - w_p).abs().max())
    check(err <= 1e-4, f"K1: max |dW| {err:.3e} > 1e-4")
    check(torch.allclose(st_k[[0, 3, 4]], st_p[[0, 3, 4]], rtol=1e-4,
                         atol=0.0),
          f"K1: loss and accuracies {st_k[[0, 3, 4]].tolist()}, the plain "
          f"version's {st_p[[0, 3, 4]].tolist()}")
    t_k, t_p = tr_k[:ep + 1], tr_p[:ep + 1]
    check(torch.allclose(t_k[:, 0], t_p[:, 0], rtol=1e-4, atol=1e-5),
          "K1: the loss trace differs")
    off = ~torch.isclose(t_k[:, 1:], t_p[:, 1:], rtol=1e-4, atol=1e-5)
    flips = int(off.any(1).sum())
    rows_off = float((t_k[:, 1:] - t_p[:, 1:]).abs().max()) * cfg.n_sup / 100
    check(flips <= acc_flips and rows_off <= 1.001,
          f"K1: the accuracy trace differs on {flips} epochs, by up to "
          f"{rows_off:.3f} support rows")
    check(bool(torch.all(tr_k[ep + 1:] == 0)),
          "K1 traced past its last epoch")
    return ep


# --------------------------------------------------------------------------
# K2 / K3 operands at the fused pretraining step's shapes (batch 64)
# --------------------------------------------------------------------------

# (name, Cin, Cout, H = W, prologue): stage 1 at 84 px (conv1 on the image,
# conv2/conv3 with the folded BN + LeakyReLU prologue), stage 2 at 42 px
K2_SHAPES = (("stage1 3->64", 3, 64, 84, False),
             ("stage1 64->64", 64, 64, 84, True),
             ("stage2 64->160", 64, 160, 42, False),
             ("stage2 160->160", 160, 160, 42, True))

# resnet12's fused step on CIFAR's 32 px images: stage 1 at 32 px, stage 2
# at 16 px
K2_CIFAR_SHAPES = (("32px stage1 3->64", 3, 64, 32, False),
                   ("32px stage1 64->64", 64, 64, 32, True),
                   ("32px stage2 64->160", 64, 160, 16, False),
                   ("32px stage2 160->160", 160, 160, 16, True))

# (name, C, H = W) of the two block tails
K3_SHAPES = (("stage1", 64, 84), ("stage2", 160, 42))


K3_CIFAR_SHAPES = (("32px stage1", 64, 32), ("32px stage2", 160, 16))

# (name, Cin, Cout, H = W, prologue, batch): ragged tiles, a one-pixel
# image, the scalar halo path (Cin not a multiple of 8), channel padding
# (Cin not a multiple of 16) and output widths padded up to 64 or 160
K2_EDGE_SHAPES = (("13x13 b1 64->64", 64, 64, 13, True, 1),
                  ("13x13 b1 160->160", 160, 160, 13, True, 1),
                  ("13x13 b2 3->64", 3, 64, 13, False, 2),
                  ("42x42 b8 160->8", 160, 8, 42, True, 8),
                  ("21x21 b2 64->96", 64, 96, 21, True, 2),
                  ("9x9 b2 24->40", 24, 40, 9, True, 2),
                  ("7x7 b2 5->16", 5, 16, 7, True, 2),
                  ("1x1 b3 3->8", 3, 8, 1, False, 3))

# (name, C, H, W, batch): K3 at each vector width (8 channels a thread
# where C is a multiple of 8, then 4, 2, 1), a single window, non-square
# maps and a channel count below one group of threads
K3_EDGE_SHAPES = (("2x2 b1 c3", 3, 2, 2, 1),
                  ("6x10 b3 c3", 3, 6, 10, 3),
                  ("6x10 b3 c6", 6, 6, 10, 3),
                  ("14x14 b3 c6", 6, 14, 14, 3),
                  ("6x10 b1 c20", 20, 6, 10, 1),
                  ("14x14 b64 c20", 20, 14, 14, 64),
                  ("2x2 b3 c24", 24, 2, 2, 3),
                  ("6x10 b64 c24", 24, 6, 10, 64),
                  ("84x84 b1 c64", 64, 84, 84, 1),
                  ("14x14 b3 c160", 160, 14, 14, 3))


def k2_case(cin: int, cout: int, hw: int, prologue: bool, device,
            batch: int = BATCH, seed: int = 0):
    """K2 operands: x (B, Cin, H, W) bf16 channels_last, w (Cout, Cin, 3, 3)
    f32 at the kaiming scale, and with ``prologue`` a BN-like affine."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((batch, cin, hw, hw), generator=g)
    w = torch.randn((cout, cin, 3, 3), generator=g) * math.sqrt(2 / (9 * cout))
    aff = None
    if prologue:
        aff = (torch.rand(cin, generator=g) + 0.5,
               0.1 * torch.randn(cin, generator=g))
        aff = tuple(t.to(device) for t in aff)
    x = x.to(device=device, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    return x, w.to(device), aff


def k3_case(c: int, h: int, w: int, device, ties: bool = False,
            batch: int = BATCH, seed: int = 0):
    """K3 operands: raw conv3 / downsample outputs (B, C, H, W) bf16
    channels_last and the two folded affines.  ``ties``: values on a grid of
    five levels around 0 with identity affines, so pooling windows hold
    ties and exact zeros."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (batch, c, h, w)
    if ties:
        y3 = torch.randint(-2, 3, shape, generator=g).to(torch.float32)
        res = torch.zeros(shape)
        affs = [torch.ones(c), torch.zeros(c), torch.ones(c), torch.zeros(c)]
    else:
        y3, res = torch.randn(shape, generator=g), torch.randn(shape,
                                                               generator=g)
        affs = [torch.rand(c, generator=g) + 0.5,
                0.1 * torch.randn(c, generator=g),
                torch.rand(c, generator=g) + 0.5,
                0.1 * torch.randn(c, generator=g)]
    cl = dict(memory_format=torch.channels_last)
    y3 = y3.to(device=device, dtype=torch.bfloat16).contiguous(**cl)
    res = res.to(device=device, dtype=torch.bfloat16).contiguous(**cl)
    affs = [t.to(device) for t in affs]
    return y3, res, (affs[0], affs[1]), (affs[2], affs[3])


def k3_agreement(ops):
    """K3 against its plain version on one input: (out, idx, bit-identical,
    max |d out|)."""
    from subspace_reg_tpu_torch.ops import conv_fused as cf
    out, idx = cf.block_tail(*ops)
    out_p, idx_p = cf.block_tail_plain(*ops)
    torch.cuda.synchronize()
    same = (out.shape == out_p.shape and idx.shape == idx_p.shape
            and torch.equal(out.view(torch.int16), out_p.view(torch.int16))
            and torch.equal(idx, idx_p))
    err = float((out.float() - out_p.float()).abs().max())
    return out, idx, same, err


def k2_term_scale(x, w, aff, relu_in: bool) -> torch.Tensor:
    """Per output element, 2^-8 of the sum of |terms| the convolution adds
    up.  An output smaller than that is a near-cancellation, where the f32
    accumulation order alone moves the rounded bf16 value by many of ITS
    ulps; the comparison takes the ulp at no less than this scale."""
    from subspace_reg_tpu_torch.ops.conv_fused import affine_act_plain
    xa = x
    if aff is not None:
        xa = affine_act_plain(x, aff[0], aff[1], relu_in)
    wb = w.to(torch.bfloat16).to(torch.float32)
    s = torch.nn.functional.conv2d(xa.to(torch.float32).abs(), wb.abs(),
                                   padding=1)
    return s * 2.0 ** -8


def bf16_ulp_diff(a: torch.Tensor, b: torch.Tensor, floor=None):
    """(max difference in bf16 ulps of b, share of elements that differ);
    with ``floor``, the ulp is taken at max(|b|, floor)."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    mag = b.abs() if floor is None else torch.maximum(b.abs(), floor)
    e = torch.floor(torch.log2(mag.clamp_min(2.0 ** -126)))
    ulp = torch.exp2(e - 7)
    d = (a - b).abs() / ulp
    return float(d.max()), float((a != b).to(torch.float32).mean())


def k2_agreement(x, w, aff, pro: bool):
    """K2 against its plain version on one input: (y, stats, max ulps,
    share of elements that differ, statistics relative error, max |dy|).
    The statistics are held to the sums of the kernel's own rounded y."""
    from subspace_reg_tpu_torch.ops import conv_fused as cf
    y, st = cf.conv3x3_fused(x, w, aff, relu_in=pro)
    yp, _ = cf.conv3x3_fused_plain(x, w, aff, relu_in=pro)
    torch.cuda.synchronize()
    check(y.shape == yp.shape and y.is_contiguous(
        memory_format=torch.channels_last), "K2 output shape or layout")
    ulps, share = bf16_ulp_diff(y, yp, k2_term_scale(x, w, aff, pro))
    yf = y.double()
    ref = torch.stack([yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))])
    scale = torch.stack([yf.abs().sum((0, 2, 3)), ref[1]]).clamp_min(1e-30)
    st_err = float(((st.double() - ref).abs() / scale).max())
    err = float((y.float() - yp.float()).abs().max())
    return y, st, ulps, share, st_err, err


# --------------------------------------------------------------------------
# K4 operands at the evaluation's forward
# --------------------------------------------------------------------------

# K4: the 22 convolutions of resnet18's forward at 84 px, as (name, Cin,
# Cout, H = W, R, convolutions of that shape in one forward); 18 are 3x3
# and 4 the downsample's 1x1
K4_SHAPES = (("s1 3->64", 3, 64, 84, 3, 1), ("s1 64->64", 64, 64, 84, 3, 2),
             ("s1 ds 3->64", 3, 64, 84, 1, 1),
             ("s2 64->160", 64, 160, 42, 3, 1),
             ("s2 160->160", 160, 160, 42, 3, 2),
             ("s2 ds 64->160", 64, 160, 42, 1, 1),
             ("s3a 160->320", 160, 320, 21, 3, 1),
             ("s3a 320->320", 320, 320, 21, 3, 2),
             ("s3a ds 160->320", 160, 320, 21, 1, 1),
             ("s3b 320->320", 320, 320, 10, 3, 3),
             ("s4a 320->640", 320, 640, 10, 3, 1),
             ("s4a 640->640", 640, 640, 10, 3, 2),
             ("s4a ds 320->640", 320, 640, 10, 1, 1),
             ("s4b 640->640", 640, 640, 5, 3, 3))

# the evaluation's batch sizes: queries (125 a session), the support (185
# on miniImageNet, 476 on tieredImageNet), the replay buffer (200) and the
# base batch (1000)
K4_ROWS = (125, 185, 200, 476, 1000)

# (name, Cin, Cout, H, W, R, batch): a one-pixel image, non-square maps,
# the k tile of 4 (Cin not a multiple of 16, with and without padding to
# 4), output widths that leave a tile's columns partly empty, ragged rows
K4_EDGE_SHAPES = (("1x1 b1 64->64", 64, 64, 1, 1, 3, 1),
                  ("7x9 b3 8->12", 8, 12, 7, 9, 3, 3),
                  ("13x13 b2 3->64", 3, 64, 13, 13, 3, 2),
                  ("5x11 b3 24->40 1x1", 24, 40, 5, 11, 1, 3),
                  ("6x6 b5 160->96", 160, 96, 6, 6, 3, 5),
                  ("3x17 b7 5->4", 5, 4, 3, 17, 3, 7),
                  ("9x9 b33 48->200", 48, 200, 9, 9, 3, 33))

# K4 against an f64 convolution: the largest |y - y64| over max |y64| (f32
# sums of up to 5,760 products in another order; TF32 reads ~1e-3)
K4_TOL = 1e-5


def k4_case(cin: int, cout: int, h: int, w: int, r: int, batch: int,
            device, seed: int = 0):
    """K4's operands: x (batch, Cin, H, W) f32, channels_last as the
    forward hands it on (NCHW-contiguous at 3 input channels, as the
    engine's images arrive), and a (Cout, Cin, R, R) weight at the
    backbone's initial scale (N(0, 2 / fan_out))."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((batch, cin, h, w), generator=g).to(device)
    if cin != 3:
        x = x.contiguous(memory_format=torch.channels_last)
    wt = torch.randn((cout, cin, r, r), generator=g) * math.sqrt(
        2.0 / (cout * r * r))
    return x, wt.to(device)


def k4_error(x, w, y, images=None) -> float:
    """max |y - y64| / max |y64| over ``images`` (default: the first, a
    middle and the last one), y64 the f64 convolution."""
    F = torch.nn.functional
    b = x.shape[0]
    idx = sorted({0, b // 2, b - 1}) if images is None else images
    ref = F.conv2d(x[idx].double(), w.double(), padding=w.shape[-1] // 2)
    return float((y[idx].double() - ref).abs().max() / ref.abs().max())


# --------------------------------------------------------------------------
# K5 operands at the pretraining step's BatchNorms
# --------------------------------------------------------------------------

# K5: resnet18's 22 train-mode BatchNorms at 84 px, as (name, C, H = W,
# BatchNorms followed by the LeakyReLU (bn1, bn2), without it (bn3 and the
# downsample's), the layout the module step hands them in: the first
# stage's maps channels_last from the input, every later one NCHW from the
# dropout mask before it)
K5_SHAPES = (("s1", 64, 84, 2, 2, "cl"), ("s2", 160, 42, 2, 2, "nchw"),
             ("s3", 320, 21, 4, 3, "nchw"), ("s4", 640, 10, 4, 3, "nchw"))


def k5_case(c: int, hw: int, batch: int, layout: str, device,
            seed: int = 0):
    """K5's operands at one BatchNorm: x (batch, C, H, W) bf16 in
    ``layout`` ("cl" or "nchw") with a per-channel offset and scale as a
    convolution's output has, weight near 1 and bias near 0 (f32), the
    running statistics, and a bf16 dy."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    shift = torch.randn((1, c, 1, 1), generator=g)
    scale = torch.rand((1, c, 1, 1), generator=g) * 2 + 0.1
    x = (torch.randn((batch, c, hw, hw), generator=g) * scale + shift)
    fmt = (torch.channels_last if layout == "cl" else
           torch.contiguous_format)
    x = x.to(torch.bfloat16).to(device).contiguous(memory_format=fmt)
    w = (1 + 0.2 * torch.randn(c, generator=g)).to(device)
    b = (0.2 * torch.randn(c, generator=g)).to(device)
    rm = (0.1 * torch.randn(c, generator=g)).to(device)
    rv = (1 + torch.rand(c, generator=g)).to(device)
    dy = (torch.randn((batch, c, hw, hw), generator=g) * 1e-3).to(
        torch.bfloat16).to(device).contiguous(memory_format=fmt)
    return x, w, b, rm, rv, dy


def k5_module(w, b, rm, rv):
    """A train-mode ``TorchBatchNorm`` holding copies of ``w`` and ``b`` as
    its parameters and ``rm``, ``rv`` themselves as its running
    statistics (updated in place)."""
    from subspace_reg_tpu_torch.models.layers import TorchBatchNorm
    bn = TorchBatchNorm(w.shape[0]).to(w.device).train()
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    bn.running_mean, bn.running_var = rm, rv
    return bn


def k5_chain(bn, x, leaky: bool):
    """K5's plain twin: the layer's own ops, ``TorchBatchNorm._normalize``
    then ``leaky_relu`` if ``leaky``."""
    from subspace_reg_tpu_torch.models.layers import leaky_relu
    out = bn._normalize(x, None)
    return leaky_relu(out) if leaky else out


def k5_agreement(x, w, b, rm, rv, dy, leaky: bool) -> dict:
    """K5 through its wrapper ``bn_train`` under autograd, forward and
    backward, against autograd through its plain twin (the layer's chain)
    and against the plain backward twin, on the card from the same
    operands: the elements of each output that differ (all 0: the sums
    are torch's own reductions on the same tensors, the rest rounds where
    the chain rounds), and against a second run of the wrapper (``rerun``:
    all 0, bit for bit); the largest absolute difference, and whether y
    and dx keep x's layout."""
    from subspace_reg_tpu_torch.ops import bn_train as k5

    def wrapper():
        rm_k, rv_k = rm.clone(), rv.clone()
        xk = x.detach().requires_grad_()
        wk, bk = w.clone().requires_grad_(), b.clone().requires_grad_()
        y = k5.bn_train(xk, wk, bk, rm_k, rv_k, 0.1, 1e-5, leaky)
        mean, e2 = y.grad_fn.saved_tensors[3:5]
        y.backward(dy)
        return y, mean, e2, xk.grad, wk.grad, bk.grad, rm_k, rv_k

    first, again = wrapper(), wrapper()
    y, mean, e2, dx, dw, db, rm_k, rv_k = first
    rm_p, rv_p = rm.clone(), rv.clone()
    xg = x.detach().requires_grad_()
    bn = k5_module(w, b, rm_p, rv_p)
    yp = k5_chain(bn, xg, leaky)
    yp.backward(dy)
    xs = x.float()
    mean_p, e2_p = xs.mean((0, 2, 3)), (xs * xs).mean((0, 2, 3))
    dx_t, dw_t, db_t = k5.bn_train_backward_plain(x, dy, mean_p, e2_p, w, b,
                                                  1e-5, leaky)
    torch.cuda.synchronize()
    groups = dict(
        stats=((mean, mean_p), (e2, e2_p)), y=((y, yp),),
        running=((rm_k, rm_p), (rv_k, rv_p)), dx=((dx, xg.grad),),
        dweight=((dw, bn.weight.grad),), dbias=((db, bn.bias.grad),),
        twin=((dx, dx_t), (dw, dw_t), (db, db_t)),
        rerun=tuple(zip(first, again)))
    out = {k: sum(int((p != q).sum()) for p, q in pairs)
           for k, pairs in groups.items()}
    out["max_abs_err"] = max(
        float((p.detach().float() - q.detach().float()).abs().max())
        for pairs in groups.values() for p, q in pairs)
    out["layout_kept"] = (y.stride() == x.stride()
                          and dx.stride() == x.stride())
    return out


def k5_agreement_ok(r: dict) -> bool:
    return r["layout_kept"] and not any(v for k, v in r.items()
                                        if k != "layout_kept")


# --------------------------------------------------------------------------
# the evaluation engine at small and full size
# --------------------------------------------------------------------------
def engine_inputs(opt):
    """The samplers and the base-test split of the synthetic sets (10
    training and 2 validation images a base class)."""
    from subspace_reg_tpu_torch.data.episodes import EpisodeSampler
    from subspace_reg_tpu_torch.data.mini_imagenet import load_mini_imagenet

    def split(**kw):
        return load_mini_imagenet(opt, train_per_class=10, val_per_class=2,
                                  **kw)
    base_test = split(split="train", phase="test")
    base_train = split(split="train", phase="train")
    novel = split(split="val")
    return dict(meta_sampler=EpisodeSampler(novel, opt, split="val",
                                            disjoint_classes=True),
                base_test_split=base_test,
                base_support_sampler=EpisodeSampler(
                    base_train, opt, split="train", phase="train"))


def run_engine(root, opt, backbone, head, device, draws=None,
               verbose=True, meta=None):
    from subspace_reg_tpu_torch.engine.incremental import (
        few_shot_finetune_incremental_test)
    return few_shot_finetune_incremental_test(
        backbone, head, meta or {}, opt, **engine_inputs(opt),
        verbose=verbose, device=device, draws=draws)


def config_argv(config: str, data_root: str):
    """The golden flags for ``config``, with the synthetic word embeds."""
    argv = list(GOLDEN_ARGV)
    i = argv.index("--attraction_override")
    if config == "semantic":
        del argv[i:i + 2]
    elif config == "mapping":
        argv[i + 1] = "mapping_linear_label2image"
        argv.append("--glove")
    return argv + ["--data_root", data_root, "--word_embed_path",
                   f"{data_root}/word_embeds"]


def golden_opt(data_root, *extra, config: str = "subspace"):
    from subspace_reg_tpu_torch.config import parse_option_eval
    return parse_option_eval(config_argv(config, data_root) + list(extra))

SMALL_WIDTHS = (8, 16, 24, 80)

SMALL_ARGS = ("--n_queries", "4", "--test_base_batch_size", "200",
              "--max_novel_epochs", "30", "--min_novel_epochs", "5",
              "--stable_epochs", "3", "--convergence_epsilon", "1e-2",
              "--learning_rate", "0.01")


def small_data(tmp):
    """Synthetic miniImageNet at 16 px (100 classes x 20 images) and its
    word embeds."""
    from subspace_reg_tpu_torch.data import synthetic
    root = f"{tmp}/small"
    synthetic.make_mini_imagenet(f"{root}/miniImageNet", n_classes=100,
                                 per_class=20, img_size=16, seed=0)
    synthetic.make_word_embeds(f"{root}/word_embeds")
    return root


def small_model(seed: int = 1, n_base: int = 60, drop_rate: float = 0.0):
    """A narrow backbone and its head over ``n_base`` classes (room for 8
    sessions of 5), drawn from ``seed``; the last stage is 80 wide, or 96
    above 60 base classes, so the subspace pull is not vacuous."""
    from subspace_reg_tpu_torch.models.head import init_head
    from subspace_reg_tpu_torch.models.resnet import ResNetRFS
    widths = SMALL_WIDTHS[:3] + (max(SMALL_WIDTHS[-1], n_base + 16),)
    torch.manual_seed(seed)
    backbone = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=drop_rate,
                         no_dropblock=True, widths=widths)
    head = init_head(n_base, widths[-1], with_bias=False,
                     max_classes=n_base + 8 * 5,
                     generator=torch.Generator().manual_seed(seed + 1))
    return backbone, head


def write_continual_mini(root: str, per_class: int = 560, img: int = 84,
                         n_classes: int = 100, seed: int = 0) -> None:
    """``all.pickle`` + ``class_labels.txt`` in the layout of
    data/synthetic.py::make_mini_imagenet (class-coloured uint8 noise),
    with the 560 images a class that the CLIs' 500/50 continual split
    needs, made class by class to bound the host memory."""
    import os
    import pickle
    os.makedirs(root, exist_ok=True)
    r = np.random.RandomState(seed)
    colors = r.randint(30, 226, size=(n_classes, 3))
    imgs = np.empty((n_classes * per_class, img, img, 3), np.uint8)
    for c in range(n_classes):
        noise = r.randint(-25, 26, size=(per_class, img, img, 3),
                          dtype=np.int16)
        imgs[c * per_class:(c + 1) * per_class] = np.clip(colors[c] + noise,
                                                          0, 255)
    cats = {f"n{900000 + i:08d}": i for i in range(n_classes)}
    with open(f"{root}/all.pickle", "wb") as f:
        pickle.dump({"data": imgs, "labels": np.repeat(
            np.arange(n_classes), per_class).tolist(),
            "catname2label": cats}, f, protocol=4)
    with open(f"{root}/class_labels.txt", "w") as f:
        for cat, lbl in cats.items():
            f.write(f"{cat} synthetic_{lbl}\n")


# --------------------------------------------------------------------------
# pretraining states and the fused-against-module step envelope
# --------------------------------------------------------------------------

PRETRAIN_CLASSES = 64


def pretrain_data(device, n_cls: int = PRETRAIN_CLASSES, per_class: int = 20,
                  img: int = 84, seed: int = 0):
    """A device-resident uint8 store (n_cls * per_class, img, img, 3) of
    class-coloured synthetic images and its labels."""
    r = np.random.RandomState(seed)
    labels = np.repeat(np.arange(n_cls), per_class)
    colors = r.randint(30, 226, size=(n_cls, 3))
    imgs = np.clip(colors[labels][:, None, None, :]
                   + r.randint(-25, 26, size=(len(labels), img, img, 3)),
                   0, 255).astype(np.uint8)
    return (torch.from_numpy(imgs).to(device),
            torch.from_numpy(labels).to(device))


def pretrain_backbone(widths=None, drop_rate: float = 0.1, seed: int = 0,
                      n_blocks=(1, 1, 2, 2), no_dropblock: bool = True):
    """resnet18-RFS in bf16 (golden flags: --no_dropblock, drop rate 0.1)
    with weights drawn from ``seed``; ``n_blocks=(1, 1, 1, 1)`` is
    resnet12; ``no_dropblock=False`` drops 5 x 5 blocks in stages 3-4."""
    from subspace_reg_tpu_torch.models.resnet import WIDTHS, ResNetRFS
    torch.manual_seed(seed)
    return ResNetRFS(n_blocks=n_blocks, drop_rate=drop_rate,
                     no_dropblock=no_dropblock, avg_pool=True,
                     widths=widths or WIDTHS, dtype=torch.bfloat16)


def golden_tx():
    """The golden SGD (lr 0.05, momentum 0.9, wd 5e-4) as ``params ->
    optimizer``."""
    import functools
    from subspace_reg_tpu_torch.utils.optim import sgd_torch
    return functools.partial(sgd_torch, learning_rate=0.05, momentum=0.9,
                             weight_decay=5e-4)


def pretrain_state(backbone, device, n_cls: int = PRETRAIN_CLASSES):
    """A fresh state over a copy of ``backbone``: golden SGD, no linear
    bias, the head drawn from seed 1."""
    import copy
    from subspace_reg_tpu_torch.engine.pretrain import init_pretrain_state
    return init_pretrain_state(copy.deepcopy(backbone), n_cls, golden_tx(),
                               False, torch.Generator().manual_seed(1),
                               device)


def pretrain_teacher(device, widths=None, n_cls: int = PRETRAIN_CLASSES,
                     seed: int = 7):
    """A KD teacher ``(module, head_w, None)``: a bf16 resnet18-RFS with
    weights and a ``torch.nn.Linear``-initialized ``n_cls``-row head drawn
    from ``seed``, in eval mode on ``device``."""
    from subspace_reg_tpu_torch.models.head import torch_linear_init
    module = pretrain_backbone(widths, seed=seed).to(device).eval()
    w, _ = torch_linear_init(n_cls, module.feature_dim, False,
                             torch.Generator().manual_seed(seed))
    return module, w.to(device), None


def pretrain_step(state, device, fused: bool, backend: str = "xla",
                  transform: str = "A", teacher=None):
    """The device-data step over ``state``'s backbone (golden schedule:
    decay at epochs 60 and 80, 100 steps an epoch; ``transform`` 'A' at
    84 px, 'D' at CIFAR's 32 px), with the KD term when a ``teacher`` is
    given (T 4, alpha and beta 1)."""
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.engine.pretrain import (
        make_train_step_device_data)
    from subspace_reg_tpu_torch.utils.optim import step_decay_schedule
    spec, _ = transforms_options[transform]
    return make_train_step_device_data(
        state.backbone, step_decay_schedule(0.05, [60, 80], 0.1, 100), spec,
        False, TorchDraws(1, device), fused=fused, fused_backend=backend,
        teacher=teacher)


def _named_params(state):
    out = dict(state.backbone.named_parameters())
    out.update({f"head.{k}": v for k, v in state.head.items()})
    return out


def pretrain_run(backbone, device, data, labels, batches, decay_at: int,
                 eager: bool = False, n_cls: int = PRETRAIN_CLASSES,
                 streamed: bool = False):
    """``len(batches)`` device-data steps (golden SGD, ``TorchDraws(1)``,
    transform 'A') from a fresh state over a copy of ``backbone``, the
    learning rate 0.05 until step ``decay_at`` and 0.005 from it; with
    ``streamed`` the step takes each batch gathered beforehand, as from
    the loader; with ``eager`` the step's runner replays no CUDA graph.
    Returns (the state at the start, the state, the steps' metrics)."""
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.engine.pretrain import (
        StepRunner, make_train_step, make_train_step_device_data)
    from subspace_reg_tpu_torch.utils.optim import step_decay_schedule
    state = pretrain_state(backbone, device, n_cls)
    args = (state.backbone, step_decay_schedule(0.05, [1], 0.1, decay_at),
            transforms_options["A"][0], False, TorchDraws(1, device))
    if streamed:
        step = make_train_step(*args)
        feed = [(data[i], labels[i]) for i in batches]
    else:
        step = make_train_step_device_data(*args)
        feed = [(data, labels, i) for i in batches]
    start = pretrain_snapshot(state)
    with (mock.patch.object(StepRunner, "engages", lambda self, st: False)
          if eager else contextlib.nullcontext()):
        metrics = [step(state, *batch) for batch in feed]
    return start, state, metrics


def pretrain_snapshot(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """Copies of a pretraining state's parameters, momentum buffers (by
    parameter) and backbone buffers."""
    params = {k: v.detach().clone() for k, v in _named_params(state).items()}
    by_id = {id(v): k for k, v in _named_params(state).items()}
    momentum = {by_id[id(p)]: st["momentum_buffer"].detach().clone()
                for p, st in state.optimizer.state.items()
                if st.get("momentum_buffer") is not None}
    buffers = {k: v.detach().clone()
               for k, v in state.backbone.named_buffers()}
    return {"params": params, "momentum": momentum, "buffers": buffers}


def _worst_leaf_gap(got, ref) -> float:
    """The worst leaf's ||got - ref|| over the larger of ||ref|| and the
    median leaf's norm."""
    norms = {k: float(v.double().norm()) for k, v in ref.items()}
    med = float(np.median(list(norms.values())))
    return max(float((got[k].double() - ref[k].double()).norm())
               / max(norms[k], med, 1e-30) for k in ref)


def pretrain_gaps(start, got, ref, got_metrics, ref_metrics) -> dict:
    """Two runs of pretraining steps from one start (``pretrain_run``)
    under the names of the benchmark's ``correct`` limits: ``loss_gap``
    the worst step's relative loss difference, ``update_gap`` the worst
    leaf's difference of the parameters' change, ``grad_gap`` of the
    momentum buffers, ``bn_stat_gap`` of the running statistics (each
    over the larger of the leaf's and the median leaf's norm), and
    ``counter_gap`` the largest difference of the blocks' counters."""
    g, r = pretrain_snapshot(got), pretrain_snapshot(ref)
    p0 = start["params"]
    stats = [k for k in r["buffers"] if "running" in k]
    counters = [k for k in r["buffers"] if k.endswith("num_batches_tracked")]
    return {
        "loss_gap": max(abs(float(a["loss"]) - float(b["loss"]))
                        / abs(float(b["loss"]))
                        for a, b in zip(got_metrics, ref_metrics)),
        "update_gap": _worst_leaf_gap(
            {k: v - p0[k] for k, v in g["params"].items()},
            {k: v - p0[k] for k, v in r["params"].items()}),
        "grad_gap": _worst_leaf_gap(g["momentum"], r["momentum"]),
        "bn_stat_gap": _worst_leaf_gap({k: g["buffers"][k] for k in stats},
                                       {k: r["buffers"][k] for k in stats}),
        "counter_gap": max(abs(int(g["buffers"][k]) - int(r["buffers"][k]))
                           for k in counters)}


def step_agreement(device, backbone, data, labels, idxs,
                   backend: str = "pallas", n_cls: int = PRETRAIN_CLASSES,
                   transform: str = "A", teacher=None):
    """The fused step against the module step from the same weights and
    batch, inside the chaos-control envelope of
    tests/test_fused_forward.py:55-125: loss within 3%, running statistics
    within 0.05 (rtol and atol), every block counter at 1, and per
    parameter the fused-vs-module update difference at most 3x that of the
    module step from weights perturbed by 0.4% (bf16's half ulp), or 2% of
    the update.  Both steps draw the same augmentation and dropout.  With
    a KD ``teacher`` every step carries its term, and the teacher's
    statistics and counters must be unchanged.
    Returns (module loss, fused loss, worst difference / allowance)."""
    s_ref = pretrain_state(backbone, device, n_cls)
    s_ctl = pretrain_state(backbone, device, n_cls)
    s_fus = pretrain_state(backbone, device, n_cls)
    init = {k: v.detach().clone() for k, v in _named_params(s_ref).items()}
    r = np.random.RandomState(5)
    with torch.no_grad():
        for p in _named_params(s_ctl).values():
            noise = torch.from_numpy(
                r.standard_normal(tuple(p.shape)).astype(np.float32))
            p.mul_(1.0 + 0.004 * noise.to(p.device))
    init_ctl = {k: v.detach().clone()
                for k, v in _named_params(s_ctl).items()}
    t_bufs = None if teacher is None else {
        k: v.clone() for k, v in teacher[0].state_dict().items()}
    m_ref = pretrain_step(s_ref, device, False, transform=transform,
                          teacher=teacher)(s_ref, data, labels, idxs)
    pretrain_step(s_ctl, device, False, transform=transform,
                  teacher=teacher)(s_ctl, data, labels, idxs)
    m_fus = pretrain_step(s_fus, device, True, backend, transform,
                          teacher)(s_fus, data, labels, idxs)
    if teacher is not None:
        check(all(torch.equal(v, t_bufs[k]) for k, v in
                  teacher[0].state_dict().items()),
              "the KD steps moved the teacher's weights, statistics or "
              "counters")
    l_ref, l_fus = float(m_ref["loss"]), float(m_fus["loss"])
    check(abs(l_fus - l_ref) <= 0.03 * abs(l_ref),
          f"fused loss {l_fus} vs module {l_ref}")
    bufs_ref = dict(s_ref.backbone.named_buffers())
    for k, v in s_fus.backbone.named_buffers():
        a, b = bufs_ref[k], v
        if k.endswith("num_batches_tracked"):
            check(int(a) == int(b) == 1, f"{k}: {int(a)} vs {int(b)}")
        else:
            check(torch.allclose(b, a, rtol=0.05, atol=0.05),
                  f"{k}: running statistic differs")
    p_ref, p_fus = _named_params(s_ref), _named_params(s_fus)
    p_ctl = _named_params(s_ctl)
    worst = 0.0
    for k, p0 in init.items():
        if p0.numel() < 32:
            continue
        u_ref = (p_ref[k].detach() - p0).float()
        u_fus = (p_fus[k].detach() - p0).float()
        u_ctl = (p_ctl[k].detach() - init_ctl[k]).float()
        d_fus = float((u_fus - u_ref).norm())
        allow = max(3.0 * float((u_ctl - u_ref).norm()),
                    0.02 * max(float(u_ref.norm()), 1e-9))
        worst = max(worst, d_fus / allow)
        check(d_fus <= allow, f"{k}: fused update differs by {d_fus:.3e}, "
              f"allowed {allow:.3e}")
    return l_ref, l_fus, worst


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def tree_items(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ckpt_leaves(path: str) -> dict:
    """Every leaf of a ``.ckpt``: variables, optimizer state, step, head."""
    from subspace_reg_tpu_torch.utils.checkpoint import load_checkpoint
    variables, head, meta = load_checkpoint(path)
    out = dict(tree_items(variables))
    out.update({f"extra/{k}": v for k, v in
                tree_items(meta.get("extra") or {})})
    out["head"] = np.asarray(head.weight)
    return out


def ckpt_diff(a: str, b: str):
    """(max |difference| over the leaves of two ``.ckpt``s, bit-identical)."""
    la, lb = ckpt_leaves(a), ckpt_leaves(b)
    check(la.keys() == lb.keys(), f"{a} and {b} hold different leaves")
    diff = max(float(np.abs(np.asarray(la[k], np.float64)
                            - np.asarray(lb[k], np.float64)).max())
               if np.asarray(la[k]).size else 0.0 for k in la)
    same = all(np.array_equal(la[k], lb[k]) for k in la)
    return diff, same


def seeded_ckpt(path: str, model: str, n_base: int, seed: int = 0) -> None:
    """A ``.ckpt`` of a seeded random ``model`` at full width and an
    ``n_base``-class head, written by the port's ``save_checkpoint``."""
    from subspace_reg_tpu_torch.models.factory import create_model
    from subspace_reg_tpu_torch.models.head import Head
    from subspace_reg_tpu_torch.utils.checkpoint import save_checkpoint
    from subspace_reg_tpu_torch.weights import to_jax_variables

    class O:
        no_dropblock = True
    torch.manual_seed(seed)
    sd = create_model(model, O()).state_dict()
    k = 1.0 / math.sqrt(640)
    w = torch.empty(n_base, 640).uniform_(-k, k)
    save_checkpoint(path, to_jax_variables(sd),
                    Head(weight=w, bias=None, n_active=n_base), {"epoch": 1})


# --------------------------------------------------------------------------
# the mesh harness: sharded pretraining steps against the single process
# --------------------------------------------------------------------------
# A configuration holds the backbone's ``widths`` and ``n_blocks``, ``img``,
# the global ``batch``, ``n_cls``, ``n_store`` (images to draw batches
# from), ``device``, optionally ``init_state`` (a pickle of the JAX
# package's initial state, which every rank and the reference start from:
# tests/test_torch_mesh_fused.py::jax_initial_state) and ``scenarios``: a
# list of {"name", "n_data", "n_model", "steps", "mode"} with ``mode``
# "streamed" or "device_data", and optionally ``dtype`` ("f32", the
# default, or "bf16"), ``pixels`` ("random", the default, or "coloured": a
# colour a class plus noise, as data/synthetic.py draws its images) and
# ``kind``: none (the plain step), "fused" (``backend`` "xla" or
# "pallas"), "kd" (``fused`` optional), "nce" or "crd" (``feat_dim`` and
# ``nce_k`` optional).  The step has dropout 0.1 and DropBlock at the end
# of its ramp, the golden SGD and transform A; on a card cuDNN runs its
# deterministic algorithms and TF32 is off.
SMALL = dict(widths=(8, 16, 24, 32), n_blocks=(1, 1, 2, 2), img=16,
             batch=8, n_cls=12, n_store=64, timeout_s=120.0)

SEED = 1
DROPBLOCK_RAMP = 40000      # forwards (models/resnet.py::dropblock_gamma)
# each rank's CPU threads; the reference runs at the same count, as CPU
# convolutions sum in an order that depends on it
THREADS = 2
# the contrastive scenarios' geometry unless a scenario sets its own
NCE_FEAT, NCE_K, NCE_T, NCE_M = 8, 16, 0.07, 0.5
# the ranks' script: this file (``main``)
RANK_SCRIPT = os.path.abspath(__file__)


def _data(cfg, pixels):
    r = np.random.RandomState(SEED)
    n, img = cfg["n_store"], cfg["img"]
    labels = r.randint(0, cfg["n_cls"], size=(n,)).astype(np.int64)
    if pixels == "coloured":
        base = r.randint(30, 226, size=(cfg["n_cls"], 3))
        store = np.clip(base[labels][:, None, None, :]
                        + r.randint(-25, 26, size=(n, img, img, 3)),
                        0, 255).astype(np.uint8)
    else:
        store = r.randint(0, 256, size=(n, img, img, 3)).astype(np.uint8)
    steps = max(s["steps"] for s in cfg["scenarios"])
    batches = [r.randint(0, n, size=(cfg["batch"],)).astype(np.int64)
               for _ in range(steps)]
    return store, labels, batches


def _tx():
    from subspace_reg_tpu_torch.utils import optim
    return functools.partial(optim.sgd_torch, learning_rate=0.05,
                             momentum=0.9, weight_decay=5e-4)


def carried_state(cfg):
    """``cfg["init_state"]``'s pickle, or None."""
    import pickle
    if not cfg.get("init_state"):
        return None
    with open(cfg["init_state"], "rb") as f:
        return pickle.load(f)


def _state(cfg, device, dtype):
    """The seeded state; its backbone's parameters and statistics and its
    head then taken from ``cfg["init_state"]`` when the configuration
    carries one (the block counters stay the harness's)."""
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.models.resnet import ResNetRFS
    from subspace_reg_tpu_torch.weights import from_jax_variables
    torch.manual_seed(SEED)
    bb = ResNetRFS(n_blocks=tuple(cfg["n_blocks"]), drop_rate=0.1,
                   no_dropblock=True, avg_pool=True,
                   widths=tuple(cfg["widths"]),
                   dtype=torch.bfloat16 if dtype == "bf16" else None)
    # the end of DropBlock's ramp: its full rate, and its batch-level
    # normalization, from the first step
    for block in bb.blocks():
        block.num_batches_tracked.fill_(DROPBLOCK_RAMP)
    state = pt.init_pretrain_state(
        bb, cfg["n_cls"], _tx(), False,
        generator=torch.Generator().manual_seed(SEED), device=device)
    init = carried_state(cfg)
    if init is not None:
        sd = dict(state.backbone.state_dict())
        sd.update({k: v for k, v in from_jax_variables(
            init["variables"]).items()
            if not k.endswith("num_batches_tracked")})
        state.backbone.load_state_dict(sd)
        with torch.no_grad():
            state.head["w"].copy_(torch.from_numpy(init["head"]))
    return state


def _teacher(cfg, device, dtype):
    """A seeded teacher of the student's geometry and class count:
    (module in eval mode, head weight, None)."""
    from subspace_reg_tpu_torch.models.resnet import ResNetRFS
    torch.manual_seed(SEED + 1)
    bb = ResNetRFS(n_blocks=tuple(cfg["n_blocks"]), drop_rate=0.1,
                   no_dropblock=True, avg_pool=True,
                   widths=tuple(cfg["widths"]),
                   dtype=torch.bfloat16 if dtype == "bf16" else None)
    w = 0.1 * torch.randn((cfg["n_cls"], cfg["widths"][-1]),
                          generator=torch.Generator().manual_seed(SEED + 2))
    return bb.to(device).eval(), w.to(device), None


def host_state(state) -> Dict[str, torch.Tensor]:
    """The backbone's entries, the head and the momentum buffers, on the
    host."""
    out = {k: v.detach().cpu().clone()
           for k, v in state.backbone.state_dict().items()}
    out.update({f"head.{k}": v.detach().cpu().clone()
                for k, v in state.head.items()})
    names = [n for n, _ in state.backbone.named_parameters()]
    names += [f"head.{k}" for k in state.head]
    for n, p in zip(names, state.optimizer.param_groups[0]["params"]):
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"momentum.{n}"] = buf.detach().cpu().clone()
    return out


def _plain_run(cfg, scenario, device, mesh=None) -> dict:
    """The plain step's scenario (this rank's part under ``mesh``)."""
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.utils.device import resolve_device
    resolve_device(device)          # TF32 off on a card
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    store, labels, batches = _data(cfg, scenario.get("pixels", "random"))
    state = _state(cfg, device, scenario.get("dtype", "f32"))
    if mesh is not None:
        mesh_lib.replicate_tree(mesh, state.backbone)
        mesh_lib.replicate_tree(mesh, state.head)
    init = host_state(state)
    spec, _ = transforms_options["A"]
    draws = TorchDraws(SEED, device)
    if scenario["mode"] == "device_data":
        step = pt.make_train_step_device_data(
            state.backbone, None, spec, False, draws, mesh=mesh)
        store_d = torch.from_numpy(store).to(device)
        labels_d = torch.from_numpy(labels).to(device)
    else:
        step = pt.make_train_step(state.backbone, None, spec, False, draws,
                                  mesh=mesh)
    metrics = []
    t0 = time.time()
    for i in range(scenario["steps"]):
        idx = batches[i]
        if scenario["mode"] == "device_data":
            m = step(state, store_d, labels_d,
                     torch.from_numpy(idx).to(device))
        else:
            if mesh is not None:
                idx = mesh_lib.shard_batch(mesh, idx)
            m = step(state, torch.from_numpy(store[idx]).to(device),
                     torch.from_numpy(labels[idx]).to(device))
        metrics.append({k: float(v) for k, v in m.items()})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dict(metrics=metrics, init=init, final=host_state(state),
                seconds=time.time() - t0)


def can_fuse_any_dtype(backbone, img_size, train):
    """``can_fuse`` without its bf16 condition: the fused step's f32 twin
    (the kernels' plain versions on the CPU, backend "xla" on a card)."""
    from subspace_reg_tpu_torch.models.fused_forward import can_fuse
    dt = backbone.dtype
    backbone.dtype = torch.bfloat16
    try:
        return can_fuse(backbone, img_size, train)
    finally:
        backbone.dtype = dt


def _step_run(cfg, scenario, device, mesh):
    """The plain run of the fused or KD step, the fused blocks' statistics
    recorded call by call (each a list of 8 tensors: mean and variance of
    bn1, bn2, bn3 and the downsample's BN), and K2's and K3's launches in
    the run."""
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.models import fused_forward as ff
    from subspace_reg_tpu_torch.ops import conv_fused as cf
    kw = {}
    fused = scenario["kind"] == "fused" or scenario.get("fused", False)
    if fused:
        kw.update(fused=True, fused_backend=scenario.get("backend", "pallas"))
    if scenario["kind"] == "kd":
        kw["teacher"] = _teacher(cfg, device, scenario.get("dtype", "f32"))
    recorded = []
    apply = ff.fb.fused_block_apply

    def record(*args, **kwargs):
        out, st = apply(*args, **kwargs)
        recorded.append([t.detach().cpu().clone() for pair in st
                         for t in pair])
        return out, st

    kernels = (cf.conv3x3_fused, cf.block_tail)
    for k in kernels:
        k.launches = 0
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            pt, "make_train_step", functools.partial(pt.make_train_step,
                                                     **kw)))
        stack.enter_context(mock.patch.object(ff.fb, "fused_block_apply",
                                              record))
        if fused and scenario.get("dtype", "f32") == "f32":
            stack.enter_context(mock.patch.object(pt, "can_fuse",
                                                  can_fuse_any_dtype))
        res = _plain_run(cfg, scenario, device, mesh)
    res["block_stats"] = recorded
    # the kernels' launches in this process (their plain versions on CPU
    # tensors count none), printed as a JSON line
    res["launches"] = {k.__name__: k.launches for k in kernels}
    print(json.dumps({"rank": None if mesh is None else mesh.rank,
                      "scenario": scenario["name"],
                      "steps": scenario["steps"],
                      "launches": res["launches"]}), flush=True)
    return res


def contrastive_state(state, nce_state):
    """``host_state`` of a contrastive state (its optimizer's momentum left
    out: the embed heads join its parameters), the embed heads, and the
    banks, Z and parameters of ``nce_state``, on the host."""
    out = {k: v for k, v in host_state(state).items()
           if not k.startswith("momentum.")}
    for name, module in state.embeds().items():
        out.update({f"{name}.{k}": v.detach().cpu().clone()
                    for k, v in module.state_dict().items()})
    out.update({f"nce.{k}": torch.from_numpy(v)
                for k, v in nce_state.to_jax().items()})
    return out


def _contrastive_run(cfg, scenario, device, mesh):
    """NCE or CRD steps from a seeded state, teacher, embed heads and
    banks over the ``n_store`` items, on batches of distinct items (one
    writer a bank row, as JAX assumes)."""
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.utils.device import resolve_device
    resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    dtype = scenario.get("dtype", "f32")
    store, labels, _ = _data(cfg, scenario.get("pixels", "random"))
    r = np.random.RandomState(SEED + 7)
    batches = [r.permutation(cfg["n_store"])[:cfg["batch"]]
               for _ in range(scenario["steps"])]
    state = _state(cfg, device, dtype)
    teacher = _teacher(cfg, device, dtype)
    nce_k = scenario.get("nce_k", NCE_K)
    state, embed_s, embed_t, nce_state = pt.init_nce_training(
        torch.Generator().manual_seed(SEED), state, _tx(),
        teacher_feat_dim=teacher[0].feature_dim,
        student_feat_dim=state.backbone.feature_dim,
        feat_dim=scenario.get("feat_dim", NCE_FEAT), n_data=cfg["n_store"],
        nce_k=nce_k, nce_t=NCE_T, nce_m=NCE_M, device=device)
    init = carried_state(cfg)
    if init is not None:
        from subspace_reg_tpu_torch.distill.embed import embed_from_jax
        from subspace_reg_tpu_torch.distill.nce import NCEAverageState
        for module, name in ((embed_s, "embed_s"), (embed_t, "embed_t")):
            embed_from_jax(module, init[name])
        nce_state = NCEAverageState.from_jax(init["nce"], device)
    if mesh is not None:
        for tree in (state.backbone, state.head, embed_s, embed_t,
                     list(vars(nce_state).values())):
            mesh_lib.replicate_tree(mesh, tree)
    init = contrastive_state(state, nce_state)
    spec, _ = transforms_options["A"]
    step = pt.make_train_step_nce(
        state.backbone, None, spec, False, TorchDraws(SEED, device),
        teacher, embed_s, embed_t, n_data=cfg["n_store"], nce_k=nce_k,
        mode=scenario["kind"], mesh=mesh)
    neg_table = tuple(torch.from_numpy(a).long().to(device) for a in
                      pt.build_negative_table(labels, cfg["n_cls"]))
    store_d = torch.from_numpy(store).to(device)
    labels_d = torch.from_numpy(labels).to(device)
    metrics, z = [], []
    t0 = time.time()
    for idx in batches:
        idx_d = torch.from_numpy(idx).to(device)
        if scenario["mode"] == "device_data":
            nce_state, m = step.device_data(state, nce_state, store_d,
                                            labels_d, neg_table, idx_d)
        else:
            if mesh is not None:
                idx_d = mesh_lib.shard_batch(mesh, idx_d)
            nce_state, m = step(state, nce_state, store_d[idx_d],
                                labels_d[idx_d], idx_d, neg_table)
        metrics.append({k: float(v) for k, v in m.items()})
        z.append((float(nce_state.z_l), float(nce_state.z_ab)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dict(metrics=metrics, init=init,
                final=contrastive_state(state, nce_state), z=z,
                seconds=time.time() - t0)


def _run(cfg, scenario, device, mesh=None) -> dict:
    """One scenario by its ``kind`` (this rank's part under ``mesh``)."""
    kind = scenario.get("kind")
    if kind in ("nce", "crd"):
        return _contrastive_run(cfg, scenario, device, mesh)
    if kind in ("fused", "kd"):
        return _step_run(cfg, scenario, device, mesh)
    return _plain_run(cfg, scenario, device, mesh)


def reference(cfg) -> Dict[str, dict]:
    """Every scenario's steps in this process, without a mesh, on the
    global batches, on ``cfg["device"]``."""
    device = torch.device(cfg["device"])
    threads = torch.get_num_threads()
    cudnn = torch.backends.cudnn
    pinned = (cudnn.deterministic, cudnn.benchmark)
    torch.set_num_threads(THREADS)
    try:
        return {s["name"]: _run(cfg, s, device) for s in cfg["scenarios"]}
    finally:
        torch.set_num_threads(threads)
        cudnn.deterministic, cudnn.benchmark = pinned


def run_rank(cfg, rank: int, world: int, init_method: str) -> Dict[str,
                                                                   dict]:
    """This rank's part of every scenario (called in the rank's
    process)."""
    torch.set_num_threads(THREADS)
    # gloo, whether the tensors lie on the CPU or on a card
    mesh_lib.init_distributed("cpu", timeout_s=cfg["timeout_s"],
                              init_method=init_method, rank=rank,
                              world_size=world)
    device = torch.device(cfg["device"])
    out = {}
    try:
        for s in cfg["scenarios"]:
            mesh = mesh_lib.create_mesh(s["n_data"], s["n_model"],
                                        device=device,
                                        timeout_s=cfg["timeout_s"])
            out[s["name"]] = _run(cfg, s, device, mesh)
    finally:
        dist.destroy_process_group()
    return out


def launch(cfg, world: int, workdir: str) -> List[Dict[str, dict]]:
    """Run the scenarios on ``world`` ranks, one process each, over gloo
    (CPU tensors, or CUDA tensors when ``cfg["device"]`` is a card);
    returns each rank's results.  A rank that fails or outlives
    ``cfg["timeout_s"]`` fails the launch, and every rank is stopped."""
    os.makedirs(workdir, exist_ok=True)
    init_file = os.path.join(workdir, "pg_init")
    if os.path.exists(init_file):
        os.remove(init_file)
    cfg_path = os.path.join(workdir, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    procs = []
    for r in range(world):
        cmd = [sys.executable, RANK_SCRIPT, "--config", cfg_path, "--rank",
               str(r), "--world", str(world), "--init",
               f"file://{init_file}", "--out",
               os.path.join(workdir, f"rank{r}.pt")]
        procs.append(subprocess.Popen(cmd, env=repo_env(),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + cfg["timeout_s"] + 60.0
    failed = []
    try:
        for r, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=max(1.0,
                                                   deadline - time.time()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} timed out")
                break
            if p.returncode != 0:
                failed.append(f"rank {r} exited {p.returncode}:\n{log}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("mesh check failed: " + "\n".join(failed))
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"))
            for r in range(world)]


# the JAX package's multi-chip tolerances (tests/test_multichip_equiv.py)
LOSS_RTOL = 2e-5
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5
COS_MIN, NORM_RTOL = 0.999, 0.01


def _updates(res: dict):
    """Each parameter's update (final - initial, float64, flat), for the
    parameters of 32 elements or more: smaller ones are BN vectors whose
    updates are noise-dominated, as in the JAX test."""
    out = {}
    for k, v in res["final"].items():
        if (v.is_floating_point() and "running" not in k
                and not k.startswith("momentum.") and v.numel() >= 32):
            out[k] = (v.double() - res["init"][k].double()).reshape(-1)
    return out


def agreement(ref: dict, got: dict, step: int = 0) -> dict:
    """One scenario's rank result against the reference: ``loss_rel`` (at
    ``step``), ``stats_excess`` (the running statistics' worst
    |diff| / (atol + rtol |ref|); at most 1 agrees), ``cos_min`` and
    ``norm_rel_max`` over the parameter updates (``_updates``), and
    ``ok``."""
    lr = ref["metrics"][step]["loss"]
    loss_rel = abs(got["metrics"][step]["loss"] - lr) / max(abs(lr), 1e-30)
    excess = 0.0
    for k, v in ref["final"].items():
        if "running" in k:
            d = (got["final"][k].double() - v.double()).abs()
            excess = max(excess, float((d / (STATS_ATOL + STATS_RTOL
                                             * v.double().abs())).max()))
    cos_min, norm_rel = 1.0, 0.0
    ua, ub = _updates(ref), _updates(got)
    for k in ua:
        na, nb = float(ua[k].norm()), float(ub[k].norm())
        if na < 1e-12 and nb < 1e-12:
            continue
        cos_min = min(cos_min, float(ua[k] @ ub[k]) / max(na * nb, 1e-30))
        norm_rel = max(norm_rel, abs(na - nb) / max(na, nb))
    return dict(loss_rel=loss_rel, stats_excess=excess, cos_min=cos_min,
                norm_rel_max=norm_rel,
                ok=(loss_rel <= LOSS_RTOL and excess <= 1.0
                    and cos_min >= COS_MIN and norm_rel <= NORM_RTOL))


def stats_excess(ref, got) -> float:
    """The worst |got - ref| / (atol + rtol |ref|) over lists of tensors,
    at the running statistics' tolerances (at most 1 agrees)."""
    worst = 0.0
    for a, b in zip(ref, got):
        d = (b.double() - a.double()).abs()
        worst = max(worst, float((d / (STATS_ATOL + STATS_RTOL
                                       * a.double().abs())).max()))
    return worst


def ranks_identical(results: List[Dict[str, dict]], name: str) -> bool:
    """Every rank's final state of scenario ``name`` bit-identical to rank
    0's."""
    first = results[0][name]["final"]
    return all(first.keys() == r[name]["final"].keys()
               and all(torch.equal(first[k], r[name]["final"][k])
                       for k in first) for r in results[1:])


# --------------------------------------------------------------------------
# the pretraining CLI on a mesh
# --------------------------------------------------------------------------
@contextlib.contextmanager
def f32_compute():
    """Inside the block the pretraining CLI builds its backbone to compute
    in f32 (it computes in bf16): a CLI run's f32 twin."""
    from subspace_reg_tpu_torch import train_supervised
    build = train_supervised.create_model

    def f32_build(*args, **kwargs):
        return build(*args, **dict(kwargs, dtype=None))

    train_supervised.create_model = f32_build
    try:
        yield
    finally:
        train_supervised.create_model = build


def cli_rank(runs) -> None:
    """One ``torchrun`` rank of the pretraining CLI, for each (argv,
    dtype) of ``runs`` in turn ("f32" under ``f32_compute``).  The rank
    joins gloo itself and, on a card, every rank uses card 0 (NCCL
    refuses two ranks on one card) with cuDNN's deterministic
    algorithms."""
    from subspace_reg_tpu_torch import train_supervised
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ["LOCAL_RANK"] = "0"
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=600))
    try:
        for argv, dtype in runs:
            with (f32_compute() if dtype == "f32"
                  else contextlib.nullcontext()):
                train_supervised.main(argv)
    finally:
        dist.destroy_process_group()


def write_one_step_split(root: str, img: int, pixels: str) -> None:
    """The category-split miniImageNet pickles with one image a class: 64
    training images, one CLI step at batch 64.  ``pixels`` "coloured"
    keeps data/synthetic.py's class colour plus noise; "random" redraws
    every pixel."""
    import pickle
    from subspace_reg_tpu_torch.data import synthetic
    synthetic.make_mini_imagenet_category_split(root, per_class=1,
                                                img_size=img, seed=0)
    if pixels == "coloured":
        return
    r = np.random.RandomState(1)
    for name in sorted(os.listdir(root)):
        if name.endswith(".pickle"):
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                blob = pickle.load(f)
            blob["data"] = r.randint(0, 256, size=blob["data"].shape,
                                     dtype=np.uint8)
            with open(path, "wb") as f:
                pickle.dump(blob, f)


def cli_agreement(ref: str, got: str, init: str) -> dict:
    """Two CLI ``.ckpt`` results of one step from the same initial
    ``.ckpt``, with ``agreement``'s criteria: ``stats_excess`` of the
    running statistics, ``cos_min`` and ``norm_rel_max`` of the updates
    of every float entry of 32 elements or more (the head included), and
    ``ok``."""
    from subspace_reg_tpu_torch.utils.checkpoint import load_any
    parts = []
    for path in (ref, got, init):
        sd, head, meta = load_any(path)
        sd = dict(sd, head=head.weight)
        parts.append((sd, meta))
    (r, _), (g, meta), (i, _) = parts
    excess, cos_min, norm_rel = 0.0, 1.0, 0.0
    for k, v in r.items():
        w = g[k]
        if "running" in k:
            d = (w.double() - v.double()).abs()
            excess = max(excess, float((d / (STATS_ATOL + STATS_RTOL
                                             * v.double().abs())).max()))
        elif v.is_floating_point() and v.numel() >= 32:
            ua = (v - i[k]).double().reshape(-1)
            ub = (w - i[k]).double().reshape(-1)
            na, nb = float(ua.norm()), float(ub.norm())
            cos_min = min(cos_min, float(ua @ ub) / max(na * nb, 1e-30))
            norm_rel = max(norm_rel, abs(na - nb) / max(na, 1e-30))
    return dict(step=int(meta["extra"]["step"]), stats_excess=excess,
                cos_min=cos_min, norm_rel_max=norm_rel,
                ok=excess <= 1.0 and cos_min >= COS_MIN
                and norm_rel <= NORM_RTOL)


# How much less accurate than the single process a sharded bf16 step may
# be, against the f32 twin: each parameter's update error and each
# statistic's error at most this times the single process's.  Two ranks
# sum their batch statistics and convolutions in another order (a card's
# cuDNN picks its algorithm by batch shape), so they round elsewhere; on
# the CPU the ratios read 0.99-1.003 on random pixels and 0.84-1.12 on
# class-coloured images, where faults of the mesh read >= 3 (gradients
# summed and not averaged: ~3; shard-local statistics: far above).
BF16_ACCURACY_MAX = 1.25


def bf16_readings(plain: str, got: str, f32: str, init: str) -> dict:
    """A bf16 CLI result ``got`` beside the single-process bf16 result
    ``plain`` and its f32 twin ``f32`` (all one step from ``init``'s
    ``.ckpt``), over the updates of 32 elements or more and the running
    statistics: ``accuracy_update`` / ``accuracy_stats``, the worst ratio
    of ``got``'s error against the f32 twin to ``plain``'s;
    ``departure_update`` / ``departure_stats``, the worst ratio of
    ||got - plain|| to ``plain``'s error; the worst update cosines of
    ``plain`` and ``got`` against the f32 twin; ``ok`` (accuracy within
    BF16_ACCURACY_MAX)."""
    from subspace_reg_tpu_torch.utils.checkpoint import load_any
    sds = []
    for path in (plain, got, f32, init):
        sd, head, _ = load_any(path)
        sds.append(dict(sd, head=head.weight))
    p, g, f, i = sds
    out = dict(accuracy_update=0.0, accuracy_stats=0.0,
               departure_update=0.0, departure_stats=0.0,
               cos_plain_f32=1.0, cos_got_f32=1.0)

    def worst(key, value):
        out[key] = max(out[key], value)

    for k, v in p.items():
        if not v.is_floating_point():
            continue
        if "running" in k:
            vp, vg, vf = (t[k].double() for t in (p, g, f))
            own = max(float((vp - vf).norm()), 1e-30)
            worst("accuracy_stats", float((vg - vf).norm()) / own)
            worst("departure_stats", float((vg - vp).norm()) / own)
        elif v.numel() >= 32:
            up, ug, uf = ((t[k] - i[k]).double().reshape(-1)
                          for t in (p, g, f))
            own = max(float((up - uf).norm()), 1e-30)
            worst("accuracy_update", float((ug - uf).norm()) / own)
            worst("departure_update", float((ug - up).norm()) / own)
            for key, u in (("cos_plain_f32", up), ("cos_got_f32", ug)):
                out[key] = min(out[key], float(u @ uf) / max(
                    float(u.norm() * uf.norm()), 1e-30))
    out["ok"] = (out["accuracy_update"] <= BF16_ACCURACY_MAX
                 and out["accuracy_stats"] <= BF16_ACCURACY_MAX)
    return out


def repo_env() -> dict:
    """This process's environment with the repository's root first on
    PYTHONPATH, for the processes the harness starts."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of the mesh harness")
    ap.add_argument("--cli", help="JSON list of [argv, dtype]: CLI runs "
                    "of a torchrun rank (cli_rank)")
    ap.add_argument("--config")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--init")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.cli:
        cli_rank(json.loads(args.cli))
        return 0
    with open(args.config) as f:
        cfg = json.load(f)
    res = run_rank(cfg, args.rank, args.world, args.init)
    torch.save(copy.deepcopy(res), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
