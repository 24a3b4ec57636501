#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (subspace_reg_tpu_torch) on one
NVIDIA card.  Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

  1. device   the card's name and count, ``nvidia-smi``'s name and power
              limit; TF32 off for matmuls and cuDNN convolutions.
  2. build    every CUDA kernel of the port from csrc/, one nvcc per source,
              all started together; build seconds, ``-Xptxas -v`` and each
              library's count of HGMMA (wgmma) instructions in its SASS
              (``cuobjdump -sass``; K2's must be above 0); each K3
              instance within 64 registers and without spills.
  3. kernels  K1 (the fused head fine-tune loop, a cooperative grid of P
              blocks, one per SM) against its plain torch version on the
              card at the main path's shapes (100 classes, D=640, 185
              support rows, 175 of 200 replay rows; the last session's
              counts), for SGD + subspace pull + memory, Adam, and the
              [W | b] bias column (99 epochs): us/epoch, each phase's and
              barrier's share of a block's time, the grid barrier alone;
              then at the golden run's 1000 epochs: agreement, a
              bit-identical rerun, CUDA-event times of the kernel and the
              plain version, and the bound.
  4. agree    the port's 8-session engine on the card against the same
              engine on the CPU (plain twin) at a small size with the same
              draws: equal epoch counts, accuracies within 0.5.
  5. main     the evaluation path: the golden subspace-reg + memory
              evaluation (README quick start flags) through
              ``few_shot_finetune_incremental_test``:
              8 sessions, full-width resnet18, 84 px synthetic
              miniImageNet made from a seed, random weights from a seed.
              Every kernel launch counter is set to 0 just before and read
              just after; K1 must have launched once per session, K2/K3
              never.
  6. profile  the same run again under torch.profiler: device time of K1,
              of the convolutions and of the rest per 8-session run, and
              the busy share.
  7. pretrain-agree  the fused-"pallas" pretraining step (K2 + K3) against
              the module step at full resnet18 width, 84 px, batch 64, from
              the same weights and batch: loss, running statistics,
              counters and parameter updates inside the chaos-control
              envelope.
  8. pretrain the pretraining path: 20 timed device-data steps each of the
              module path, fused "xla" and fused "pallas" (two rounds),
              with every launch counter set to 0 just before each run and
              read just after (K2 6 and K3 2 launches per fused-"pallas"
              step, none elsewhere); ms/step, images/s, peak memory.
  9. pretrain-profile  fused-"pallas" steps under torch.profiler: device
              time of K2, K3, the library convolutions and the rest.
  10. cli     ``python -m subspace_reg_tpu_torch.train_supervised`` for one
              epoch (golden model/optimizer flags, 84 px, 64 classes x 100
              synthetic images) to a saved ``.pth``, read back.

Phase 3 also holds K2 and K3 against their plain versions at every shape
of the fused step (K2 within 1 bf16 ulp, K3 bit-identical) and at edge
shapes (``K2_EDGE_SHAPES``, ``K3_EDGE_SHAPES``), checks that K2 at
160->160 and K3 at both step shapes rerun bit-identically, times K2 beside
``F.conv2d`` (each shape's share of its bound and ratio to ``F.conv2d``)
and K3 alone (bare launches in a CUDA graph; torch.profiler's mean kernel
duration must agree within ``K3_PROFILER_SHARE``) and through its wrapper, beside a device-to-device copy of
each shape's y3 (effective GB/s of both).  The line before
the last is one JSON object with each kernel's launches on its path, its
error against the plain version, its time, the plain version's time, its
roofline bound and the library call's time; the last line is
``{"ok": true, "device": ...}``.

``--only-kernels`` stops after phase 3 for quick iteration on a kernel: it
prints the kernels line (launches null) and no ok line.
"""

from __future__ import annotations

import io
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_SESSIONS = 8
# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 rate
FP32_PEAK_FLOPS = 67e12
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

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
        raise RuntimeError(f"chip_smoke: {msg}")


# --------------------------------------------------------------------------
# K1 operands at the main path's shapes
# --------------------------------------------------------------------------
def k1_case(kind: str, device, max_epochs: int = 100, seed: int = 0,
            session: int = N_SESSIONS, stable_target: int = 10):
    """Operands of session ``session`` (1..8, default the last) of the
    golden run: 60 + 5*session active classes of 100, 185 support rows (125
    novel + 60 base exemplars), 25*(session-1) of 200 replay rows,
    5*(session-1) reserved rows.  ``kind``: 'sgd' (subspace pull +
    memory), 'adam', 'bias' (the [W | b] layout, D = 641, no novel anchor),
    'semantic' (the semantic pull) or 'plain' (no pull, no memory).  A
    ``stable_target`` no run reaches makes the loop run to ``max_epochs``,
    as the golden run on random weights does."""
    from subspace_reg_tpu_torch.ops.finetune import LoopConfig, pack_scalars
    r = np.random.RandomState(seed)
    cp, feat, ns, nm = 100, 640, 185, 200
    orig_base, n_ways = 60, 5
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


def k1_bound(ops, cfg, epochs_run: int):
    """Least time for the same work: the larger of the FP32 operations of
    the epochs this run needed over the FP32 peak, and the bytes of every
    input read once and every output written once over the HBM rate."""
    d = ops["w"].shape[1]
    per_epoch = (2 * 2 * (cfg.n_sup + cfg.mem_count) * cfg.n_active * d
                 + 2 * cfg.n_ways * d * d)
    t_ops = epochs_run * per_epoch / FP32_PEAK_FLOPS
    n_in = sum(t.numel() * t.element_size() for t in ops.values()
               if t is not None)
    n_out = ops["w"].numel() * 4 + 8 * 4 + cfg.trace_rows * 3 * 4
    t_bytes = (n_in + n_out) / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


# --------------------------------------------------------------------------
# K2 / K3 operands at the fused pretraining step's shapes (batch 64)
# --------------------------------------------------------------------------
# (name, Cin, Cout, H = W, prologue): stage 1 at 84 px (conv1 on the image,
# conv2/conv3 with the folded BN + LeakyReLU prologue), stage 2 at 42 px
K2_SHAPES = (("stage1 3->64", 3, 64, 84, False),
             ("stage1 64->64", 64, 64, 84, True),
             ("stage2 64->160", 64, 160, 42, False),
             ("stage2 160->160", 160, 160, 42, True))
# (name, C, H = W) of the two block tails
K3_SHAPES = (("stage1", 64, 84), ("stage2", 160, 42))
BATCH = 64
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
# K3's kernel-alone time from the CUDA graph and torch.profiler's mean
# kernel duration agree within this share of the former
K3_PROFILER_SHARE = 0.05


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


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up call, from
    CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 3) -> float:
    """Mean device ms per call of ``fn`` with the host out of the way:
    ``reps`` calls captured in one CUDA graph, replayed ``replays`` times
    after a warm-up replay, CUDA events around the replays (the gaps
    between kernels included)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def profiled_kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device duration in ms of the kernel named ``kernel`` over
    ``reps`` calls of ``fn``, from torch.profiler's device events (the
    tracer may drop a record; the mean is over those it kept)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    check(len(us) >= reps // 2, f"the profiler saw {len(us)} of {reps} "
          f"{kernel} launches")
    return sum(us) / len(us) / 1e3


def k1_agreement(kind: str, ops, cfg, out, acc_flips: int = 0):
    """K1's output against its plain version on the same operands: epochs
    exact, max |dW| <= 1e-4, the last loss and accuracies to 1e-4
    relative, the loss of every epoch run to rtol 1e-4.  The accuracies of
    every epoch agree to rtol 1e-4 too, except on at most ``acc_flips``
    epochs, where they may differ by one support row: over a long run a
    support row's logits come within an ulp of a rival class's, and the
    two sum orders may rank it either side.  Returns (epochs, max
    |dW|)."""
    from subspace_reg_tpu_torch.ops.finetune import finetune_loop_plain
    w_k, st_k, tr_k = out
    w_p, st_p, tr_p = finetune_loop_plain(**ops, cfg=cfg)
    torch.cuda.synchronize()
    st_k, st_p = st_k.cpu().numpy(), st_p.cpu().numpy()
    err = float((w_k - w_p).abs().max())
    ep = int(st_k[1])
    print(f"[kernels] K1 {kind}: epochs kernel {ep} plain {int(st_p[1])}"
          f" max|dW| {err:.3e} loss {st_k[0]:.6f}/{st_p[0]:.6f} "
          f"acc1 {st_k[3]:.4f}/{st_p[3]:.4f} "
          f"acc5 {st_k[4]:.4f}/{st_p[4]:.4f}")
    check(ep == int(st_p[1]), f"K1 {kind}: epochs differ")
    check(ep > 2, f"K1 {kind}: the loop ran no epoch")
    check(err <= 1e-4, f"K1 {kind}: max|dW| {err} > 1e-4")
    for i, name in ((0, "loss"), (3, "acc1"), (4, "acc5")):
        check(abs(st_k[i] - st_p[i]) <= 1e-4 * abs(st_p[i]),
              f"K1 {kind}: {name} {st_k[i]} vs {st_p[i]}")
    t_k, t_p = tr_k[2:ep + 1].double(), tr_p[2:ep + 1].double()
    loss_rel = float(((t_k[:, 0] - t_p[:, 0]).abs()
                      / t_p[:, 0].abs().clamp_min(1e-30)).max())
    off = ~torch.isclose(t_k[:, 1:], t_p[:, 1:], rtol=1e-4, atol=1e-5)
    flips = int(off.any(1).sum())
    rows_off = float((t_k[:, 1:] - t_p[:, 1:]).abs().max()) * cfg.n_sup / 100
    print(f"[kernels] K1 {kind} trace: loss max rel diff {loss_rel:.2e}; "
          f"accuracy differs on {flips} of {ep - 1} epochs, by at most "
          f"{rows_off:.3f} support rows")
    check(torch.allclose(t_k[:, 0], t_p[:, 0], rtol=1e-4, atol=1e-5),
          f"K1 {kind}: the loss trace differs")
    check(flips <= acc_flips and rows_off <= 1.001,
          f"K1 {kind}: the accuracy trace differs on {flips} epochs")
    return ep, err


def k1_phase_times(ops, cfg, blocks: int, epochs: int):
    """Where a K1 block's time goes, us per epoch from the kernel's own
    per-block clocks: phase A (its product part apart), the wait at the
    first barrier, phase B (its slot reduction, G product and update
    epilogue apart), the wait at the second; blocks grouped by what they
    own (phase A: a logits tile, a pull chunk or nothing; phase B: a tile
    with the product G, a tile without it, or nothing), mean and max over
    each group."""
    from subspace_reg_tpu_torch.ops import finetune as ft
    prof = torch.zeros((blocks, ft.K1_PROF_SLOTS), dtype=torch.int64,
                       device=ops["w"].device)
    ft._launch(ops, cfg, blocks=blocks, prof=prof)
    torch.cuda.synchronize()
    c = (prof.double() / (1e3 * epochs)).cpu().numpy()
    plan = ft._plan_for(cfg, *ops["w"].shape, blocks)
    work = [ft.k1_work(plan, b) for b in range(blocks)]
    has_g = [any(u[4] for u in w["update"]) for w in work]
    a_groups = (("logits", [b for b in range(blocks) if work[b]["logits"]]),
                ("pull", [b for b in range(blocks) if work[b]["pull"]
                          and not work[b]["logits"]]),
                ("idle", [b for b in range(blocks) if not (
                    work[b]["logits"] or work[b]["pull"])]))
    b_groups = (("G tile", [b for b in range(blocks) if has_g[b]]),
                ("tile without G", [b for b in range(blocks)
                                    if work[b]["update"] and not has_g[b]]),
                ("idle", [b for b in range(blocks) if not work[b]["update"]]))
    parts = {"phase A": (c[:, 0] + c[:, 4], a_groups,
                         (("product", c[:, 4]),)),
             "barrier 1": (c[:, 1], (), ()),
             "phase B": (c[:, 2] + c[:, 5] + c[:, 6] + c[:, 7], b_groups,
                         (("slot reduction", c[:, 5]), ("G", c[:, 6]),
                          ("update", c[:, 7]))),
             "barrier 2": (c[:, 3], (), ())}
    for name, (total, groups, subs) in parts.items():
        out = [f"all {total.mean():.2f} (max {total.max():.2f})"]
        for label, idx in groups:
            if idx:
                sub = "".join(f", {s} {v[idx].mean():.2f}" for s, v in subs)
                out.append(f"{label} x{len(idx)} {total[idx].mean():.2f} "
                           f"(max {total[idx].max():.2f}{sub})")
        print(f"[kernels] K1 sgd {name}, us/epoch per block: "
              + "; ".join(out))


def k1_barrier_us(dev, blocks: int, iters: int = 20000) -> float:
    """Microseconds per grid barrier of K1's kind on ``blocks`` blocks: one
    cooperative launch that runs ``iters`` barriers and nothing else."""
    from subspace_reg_tpu_torch.ops import finetune as ft
    fn = ft._kernel_fn("k1_barrier_probe", 1, 2)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        bar = torch.zeros(1, dtype=torch.int32, device=dev)
        check(fn(bar.data_ptr(), blocks, iters, stream) == 0,
              "the barrier probe did not launch")
    return 1e3 * cuda_ms(run, 3) / iters


def phase_kernels(dev):
    """K1 against its plain version at the last golden session's shapes
    (SGD + subspace pull + memory, Adam, the bias column; 99 epochs), its
    time per epoch there, where a block's time goes (phase A, barrier,
    phase B, barrier), the barrier alone, and K1 at the golden run's 1000
    epochs: agreement, a bit-identical rerun, the time per launch, the
    plain version's and the bound."""
    from subspace_reg_tpu_torch.ops import finetune as ft
    p = ft.k1_blocks(dev)
    print(f"[kernels] K1 grid: P = {p} blocks of {ft.K1_THREADS} threads "
          f"(one per SM)")
    for kind in ("sgd", "adam", "bias"):
        ops, cfg = k1_case(kind, dev)
        ep, _ = k1_agreement(kind, ops, cfg, ft.finetune_loop(**ops, cfg=cfg))
        if kind == "sgd":
            ms = cuda_ms(lambda: ft.finetune_loop(**ops, cfg=cfg), 10)
            us_epoch = 1e3 * ms / (ep - 1)
            print(f"[kernels] K1 sgd: {ep - 1} epochs/launch, kernel "
                  f"{ms:.3f} ms = {us_epoch:.2f} us/epoch at P = {p}")
            k1_phase_times(ops, cfg, p, ep - 1)
    bar_us = k1_barrier_us(dev, p)
    print(f"[kernels] K1 grid barrier alone: {bar_us:.3f} us at P = {p}")
    # the golden run: random weights never meet the stable rule, so every
    # session runs all 1000 epochs
    ops, cfg = k1_case("sgd", dev, max_epochs=1000, stable_target=10 ** 6)
    out = ft.finetune_loop(**ops, cfg=cfg)
    ep, err = k1_agreement("sgd 1000 epochs", ops, cfg, out, acc_flips=10)
    check(ep == 1000, f"K1 ran {ep} of 1000 epochs")
    again = ft.finetune_loop(**ops, cfg=cfg)
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    print(f"[kernels] K1 sgd 1000 epochs: rerun at P = {p} bit-identical "
          f"{same}")
    check(same, "K1: a rerun at the full grid differs")
    ms = cuda_ms(lambda: ft.finetune_loop(**ops, cfg=cfg), 5)
    plain_ms = cuda_ms(lambda: ft.finetune_loop_plain(**ops, cfg=cfg), 1)
    bound_ms, bound_by = k1_bound(ops, cfg, ep - 1)
    print(f"[kernels] K1 sgd: {ep - 1} epochs/launch, kernel {ms:.3f} ms "
          f"({1e3 * ms / (ep - 1):.2f} us/epoch), plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
          f"{100 * bound_ms / ms:.2f}% of the bound")
    return {"finetune_loop": dict(
        name="finetune_loop", route="cuda",
        source="subspace_reg_tpu_torch/csrc/finetune_loop.cu",
        replaces="subspace_reg_tpu/ops/pallas/finetune.py:352",
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        epochs_per_launch=ep - 1, us_per_epoch=1e3 * ms / (ep - 1),
        us_per_epoch_99=us_epoch, blocks=p, barrier_us=bar_us)}


def roofline_ms(flops: float, nbytes: float):
    """The larger of bf16 tensor-core operations at the dense peak and bytes
    at the HBM rate, in ms, and which of the two it is."""
    t_ops, t_bytes = flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def phase_k2():
    """K2 against its plain version at the edge shapes and every shape of
    the fused step (batch 64), with CUDA-event times of the wrapper call,
    the plain version and the one-call yardstick ``F.conv2d`` in bf16
    channels_last (the convolution alone, without prologue or
    statistics); its row sums each time over one step's launches (conv1
    once and conv2/conv3 twice per stage)."""
    from subspace_reg_tpu_torch.ops import conv_fused as cf
    F = torch.nn.functional
    dev = torch.device("cuda")
    k2 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
              max_abs_err=0.0, shapes=[])
    ops_ms = bytes_ms = 0.0
    for name, cin, cout, hw, pro, batch in K2_EDGE_SHAPES:
        x, w, aff = k2_case(cin, cout, hw, pro, dev, batch=batch)
        _, _, ulps, share, st_err, err = k2_agreement(x, w, aff, pro)
        print(f"[kernels] K2 edge {name}: {ulps:.2f} ulp max, "
              f"{100 * share:.4f}% of y differ, max |dy| {err:.3e}, stats "
              f"rel err {st_err:.2e}")
        check(ulps <= 1.0 and share <= 1e-3,
              f"K2 edge {name}: {ulps} ulp, {share} of elements differ")
        check(st_err <= 1e-4, f"K2 edge {name}: stats rel err {st_err}")
    for name, cin, cout, hw, pro in K2_SHAPES:
        x, w, aff = k2_case(cin, cout, hw, pro, dev)
        y, st, ulps, share, st_err, err = k2_agreement(x, w, aff, pro)
        print(f"[kernels] K2 {name}: {ulps:.2f} ulp max, {100 * share:.4f}% "
              f"of y differ, max |dy| {err:.3e}, stats rel err {st_err:.2e}")
        check(ulps <= 1.0 and share <= 1e-3,
              f"K2 {name}: {ulps} ulp, {share} of elements differ")
        check(st_err <= 1e-4, f"K2 {name}: stats rel err {st_err}")
        if cin == cout == 160:
            y2, st2 = cf.conv3x3_fused(x, w, aff, relu_in=pro)
            same = torch.equal(y, y2) and torch.equal(st, st2)
            print(f"[kernels] K2 {name}: rerun bit-identical {same}")
            check(same, f"K2 {name}: a rerun differs")
        wb = w.to(torch.bfloat16)
        ms = cuda_ms(lambda: cf.conv3x3_fused(x, w, aff, relu_in=pro), 20)
        plain_ms = cuda_ms(
            lambda: cf.conv3x3_fused_plain(x, w, aff, relu_in=pro), 5)
        lib_ms = cuda_ms(lambda: F.conv2d(x, wb, padding=1), 20)
        b = x.shape[0]
        flops = 2.0 * b * hw * hw * cout * cin * 9
        nbytes = (x.numel() * 2 + w.numel() * 4 + y.numel() * 2
                  + (2 * cin * 4 if pro else 0) + 2 * cout * 4)
        bound, by = roofline_ms(flops, nbytes)
        reps = 1 if cin == 3 or name.endswith("64->160") else 2
        print(f"[kernels] K2 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
              f" ms, F.conv2d bf16 {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}); {100 * bound / ms:.1f}% of the bound, "
              f"{ms / lib_ms:.2f}x F.conv2d; {reps} launch(es) per step")
        k2["shapes"].append(dict(shape=name, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=bound,
                                 bound_by=by, ulps=ulps, share=share,
                                 bound_share=bound / ms,
                                 vs_library=ms / lib_ms))
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound)):
            k2[key] += reps * v
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        ops_ms += reps * 1e3 * flops / BF16_PEAK_FLOPS
        bytes_ms += reps * 1e3 * nbytes / HBM_BYTES_PER_S
    # the step's launches each take at least their own bound; the row
    # names the class that bounds most of their sum
    k2["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"[kernels] K2 per step: kernel {k2['ms']:.4f} ms, bound "
          f"{k2['bound_ms']:.4f} ms ({100 * k2['bound_ms'] / k2['ms']:.1f}%),"
          f" F.conv2d {k2['library_ms']:.4f} ms "
          f"({k2['ms'] / k2['library_ms']:.2f}x)")
    return dict(name="conv3x3_fused", route="cuda",
                source="subspace_reg_tpu_torch/csrc/conv3x3_fused.cu",
                replaces="subspace_reg_tpu/ops/pallas/conv_fused.py:168",
                launches=None, **k2)


def k3_bytes(y3) -> int:
    """K3's bytes: y3 and r read once, the four f32 affines, the bf16 pooled
    map and the int8 record written once."""
    n_in, c = y3.numel(), y3.shape[1]
    return 2 * n_in * 2 + 4 * c * 4 + (n_in // 4) * 3


def phase_k3(dev):
    """K3 against its plain version, bit for bit, at the edge shapes and at
    both shapes of the fused step (random and with ties, and a rerun);
    then per step shape: the kernel alone (outputs allocated once, bare
    launches in a CUDA graph; cross-checked with torch.profiler), the
    wrapper call, the plain version, the bytes bound, the share of it and
    the effective GB/s, beside a device-to-device copy of the shape's y3
    as the rate this card reaches.  The row sums each time over one step's
    two launches; its copy is stage 1's."""
    from subspace_reg_tpu_torch.ops import conv_fused as cf
    k3 = dict(ms=0.0, wrapper_ms=0.0, profiler_ms=0.0, plain_ms=0.0,
              bound_ms=0.0, max_abs_err=0.0, shapes=[])
    for name, c, h, w, batch in K3_EDGE_SHAPES:
        for ties in (False, True):
            ops = k3_case(c, h, w, dev, ties=ties, batch=batch)
            _, _, same, err = k3_agreement(ops)
            print(f"[kernels] K3 edge {name}{' ties' if ties else ''}: "
                  f"bit-identical {same}")
            check(same, f"K3 edge {name} (ties={ties}) differs from plain")
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
    nbytes_all = 0
    for name, c, hw in K3_SHAPES:
        for ties in (False, True):
            ops = k3_case(c, hw, hw, dev, ties=ties)
            out, idx, same, err = k3_agreement(ops)
            print(f"[kernels] K3 {name}{' ties' if ties else ''}: "
                  f"bit-identical {same}")
            check(same, f"K3 {name} (ties={ties}) differs from plain")
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
        out2, idx2 = cf.block_tail(*ops)
        same = torch.equal(out.view(torch.int16), out2.view(
            torch.int16)) and torch.equal(idx, idx2)
        print(f"[kernels] K3 {name}: rerun bit-identical {same}")
        check(same, f"K3 {name}: a rerun differs")
        ops = k3_case(c, hw, hw, dev)
        vecs, out, idx = cf._k3_operands(*ops)

        def bare():
            cf._k3_launch(ops[0], ops[1], vecs, out, idx)
        ms = graph_ms(bare)
        prof_ms = profiled_kernel_ms(bare, "block_tail")
        # the graph's time adds the gaps between launches to the kernels'
        check(abs(prof_ms - ms) <= K3_PROFILER_SHARE * ms,
              f"K3 {name}: the profiler's {prof_ms:.4f} ms and the graph's "
              f"{ms:.4f} ms differ by more than "
              f"{100 * K3_PROFILER_SHARE:.0f}%")
        wrapper_ms = cuda_ms(lambda: cf.block_tail(*ops), 20)
        plain_ms = cuda_ms(lambda: cf.block_tail_plain(*ops), 5)
        nbytes = k3_bytes(ops[0])
        nbytes_all += nbytes
        bound, by = roofline_ms(0.0, nbytes)
        gbs = nbytes / ms / 1e6
        print(f"[kernels] K3 {name}: kernel alone {ms:.4f} ms (profiler "
              f"{prof_ms:.4f}), wrapper call {wrapper_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
              f"{nbytes / 1e6:.1f} MB); {100 * bound / ms:.1f}% of the "
              f"bound, {gbs:.0f} GB/s")
        k3["shapes"].append(dict(shape=name, ms=ms, profiler_ms=prof_ms,
                                 wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by,
                                 bound_share=bound / ms, gb_per_s=gbs))
        for key, v in (("ms", ms), ("wrapper_ms", wrapper_ms),
                       ("profiler_ms", prof_ms), ("plain_ms", plain_ms),
                       ("bound_ms", bound)):
            k3[key] += v
        k3["bound_by"] = by
        # the yardstick: a device-to-device copy of this shape's y3
        dst = torch.empty_like(ops[0])
        copy_ms = graph_ms(lambda: dst.copy_(ops[0]))
        moved = 2 * ops[0].numel() * 2
        copy_gbs = moved / copy_ms / 1e6
        print(f"[kernels] K3 {name}: copy of y3 ({moved / 1e6:.1f} MB "
              f"moved) {copy_ms:.4f} ms, {copy_gbs:.0f} GB/s; K3 at "
              f"{100 * gbs / copy_gbs:.1f}% of the copy's rate")
        k3["shapes"][-1].update(copy_ms=copy_ms, copy_gb_per_s=copy_gbs)
    k3.update(bound_share=k3["bound_ms"] / k3["ms"],
              gb_per_s=nbytes_all / k3["ms"] / 1e6,
              copy_ms=k3["shapes"][0]["copy_ms"],
              copy_gb_per_s=k3["shapes"][0]["copy_gb_per_s"])
    print(f"[kernels] K3 per step: kernel alone {k3['ms']:.4f} ms, wrapper "
          f"calls {k3['wrapper_ms']:.4f} ms, bound {k3['bound_ms']:.4f} ms "
          f"({100 * k3['bound_share']:.1f}%), {k3['gb_per_s']:.0f} GB/s; "
          f"the copy of stage 1's y3 {k3['copy_gb_per_s']:.0f} GB/s")
    return dict(name="block_tail", route="cuda",
                source="subspace_reg_tpu_torch/csrc/block_tail.cu",
                replaces="subspace_reg_tpu/ops/pallas/conv_fused.py:278",
                launches=None, library_ms=None, **k3)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
class _Tee(io.TextIOBase):
    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _run_engine(root, opt, backbone, head, device, draws=None,
                verbose=True):
    from subspace_reg_tpu_torch.data.episodes import EpisodeSampler
    from subspace_reg_tpu_torch.data.mini_imagenet import load_mini_imagenet
    from subspace_reg_tpu_torch.engine.incremental import (
        few_shot_finetune_incremental_test)

    def split(**kw):
        return load_mini_imagenet(opt, train_per_class=10, val_per_class=2,
                                  **kw)
    base_test = split(split="train", phase="test")
    base_train = split(split="train", phase="train")
    novel = split(split="val")
    return few_shot_finetune_incremental_test(
        backbone, head, {}, opt,
        meta_sampler=EpisodeSampler(novel, opt, split="val",
                                    disjoint_classes=True),
        base_test_split=base_test,
        base_support_sampler=EpisodeSampler(base_train, opt, split="train",
                                            phase="train"),
        verbose=verbose, device=device, draws=draws)


def _golden_opt(data_root, *extra):
    from subspace_reg_tpu_torch.config import parse_option_eval
    return parse_option_eval(GOLDEN_ARGV + ["--data_root", data_root,
                                            *extra])


def phase_agree(tmp):
    """Engine on the card vs the same engine on the CPU, small size."""
    from subspace_reg_tpu_torch.data import synthetic
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.models.head import init_head
    from subspace_reg_tpu_torch.models.resnet import ResNetRFS
    root = f"{tmp}/small"
    synthetic.make_mini_imagenet(f"{root}/miniImageNet", n_classes=100,
                                 per_class=20, img_size=16, seed=0)
    opt = _golden_opt(root, "--n_queries", "4", "--test_base_batch_size",
                      "200", "--max_novel_epochs", "30",
                      "--min_novel_epochs", "5", "--stable_epochs", "3",
                      "--convergence_epsilon", "1e-2",
                      "--learning_rate", "0.01", "--set_seed", "3")
    torch.manual_seed(1)
    backbone = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.0,
                         no_dropblock=True, widths=(8, 16, 24, 80))
    head = init_head(60, 80, with_bias=False, max_classes=100,
                     generator=torch.Generator().manual_seed(2))
    res = {dev: _run_engine(root, opt, backbone, head, dev,
                            draws=TorchDraws(opt.set_seed, "cpu"),
                            verbose=False)
           for dev in ("cuda", "cpu")}
    g, c = res["cuda"], res["cpu"]
    print(f"[agree] epochs card {g.epochs_per_session} cpu "
          f"{c.epochs_per_session}")
    print(f"[agree] novel card {g.acc_novel_list} cpu {c.acc_novel_list}")
    print(f"[agree] base card {g.acc_base_list} cpu {c.acc_base_list}")
    check(g.epochs_per_session == c.epochs_per_session,
          "engine epochs differ between card and CPU")
    for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
        a, b = np.asarray(getattr(g, name)), np.asarray(getattr(c, name))
        check(np.all(np.abs(a - b) <= 0.5),
              f"{name} differs between card and CPU: {a} vs {b}")


def phase_main(tmp, counters):
    from subspace_reg_tpu_torch.data import synthetic
    from subspace_reg_tpu_torch.models.factory import create_model
    from subspace_reg_tpu_torch.models.head import init_head
    root = f"{tmp}/golden"
    t0 = time.time()
    synthetic.make_mini_imagenet(f"{root}/miniImageNet", n_classes=100,
                                 per_class=40, img_size=84, seed=0)
    opt = _golden_opt(root)
    torch.manual_seed(0)
    backbone = create_model(opt.model, opt, dataset=opt.dataset)
    head = init_head(60, backbone.feature_dim, with_bias=False,
                     max_classes=100,
                     generator=torch.Generator().manual_seed(1))
    print(f"[main] set-up (synthetic data, seeded weights) "
          f"{time.time() - t0:.1f} s")
    tee = _Tee(sys.stdout)
    old = sys.stdout
    for c in counters:
        c.launches = 0
    sys.stdout = tee
    try:
        t0 = time.time()
        res = _run_engine(root, opt, backbone, head, "cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        sys.stdout = old
    launches = {c.__name__: c.launches for c in counters}
    out = tee.buf.getvalue()
    print(f"[main] 8-session run {wall:.2f} s; per-session seconds "
          f"{[round(s, 4) for s in res.session_seconds]}; epochs "
          f"{res.epochs_per_session}; K1 launches {launches}")
    check(launches["finetune_loop"] == N_SESSIONS,
          f"K1 launched {launches['finetune_loop']} times, expected "
          f"{N_SESSIONS}")
    check(all(n == 0 for k, n in launches.items() if k != "finetune_loop"),
          f"the evaluation path launched a pretraining kernel: {launches}")
    check(len(res.acc_novel_list) == N_SESSIONS
          and len(res.weighted_avg_l) == N_SESSIONS + 1, "trace length")
    for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
        check(np.all(np.isfinite(getattr(res, name))), f"{name} not finite")
    check(all(1 <= e <= opt.max_novel_epochs
              for e in res.epochs_per_session), "epoch counts out of range")
    for line in ("**** Iteration 8/8 ****", "Novel session accuracies: ",
                 "Overall continual accuracies: ", "Novel only incremental: ",
                 "Base only incremental: ", "Fine-tuning epochs:"):
        check(out.count(line) >= 1, f"reference line {line!r} not printed")
    check(out.count("Fine-tuning epochs:") == N_SESSIONS,
          "one session block per session")
    return launches, (root, opt, backbone, head)


# kernel-name fragments of cuDNN's convolution kernels (implicit GEMM and
# FFT algorithms) in the profiler's device events
_CONV_MARKS = ("conv", "xmma", "fft", "pointwise_mult_and_sum_complex",
               "region_transform")
# the tracer's own activity records, which it files as device events
_TRACER_OVERHEAD = ("Command Buffer Full", "Buffer Flush",
                    "Activity Buffer Request")


def kernel_breakdown(prof, groups):
    """Device time by kernel class from a torch.profiler run.  ``groups``:
    (label, name fragments) in order of precedence; the rest is "other
    kernels".  Returns (us by group, busy us, us by kernel name); busy time
    is the union of the kernels' intervals (kernel times summed count
    overlapping records twice)."""
    from torch.autograd import DeviceType
    out = {label: 0.0 for label, _ in groups}
    out["other kernels"] = 0.0
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name in _TRACER_OVERHEAD:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us = e.device_time_total
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        label = next((lb for lb, marks in groups
                      if any(m in e.name for m in marks)), "other kernels")
        out[label] += us
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return out, busy, by_name


def print_breakdown(tag, groups, busy, by_name, wall):
    parts = ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in groups.items())
    print(f"[{tag}] wall {1e3 * wall:.3f} ms; kernel time {parts}; device "
          f"busy {busy / 1e3:.3f} ms = {100 * busy / 1e6 / wall:.1f}% of the "
          "wall clock")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}] {us / 1e3:10.3f} ms  {name[:90]}")


def phase_profile(run):
    """One more golden run under torch.profiler, after the counted one:
    device time of K1, of the convolutions and of everything else, against
    the wall clock."""
    from torch.profiler import ProfilerActivity, profile
    root, opt, backbone, head = run
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _run_engine(root, opt, backbone, head, "cuda", verbose=False)
        torch.cuda.synchronize()
        wall = time.time() - t0
    groups, busy, by_name = kernel_breakdown(
        prof, [("K1", ("finetune_loop_kernel",)),
               ("convolution", _CONV_MARKS)])
    check(groups["K1"] > 0, "the profiler saw no K1 launch")
    print_breakdown("profile", groups, busy, by_name, wall)
    print(f"[profile] per 8-session run: K1 device time "
          f"{groups['K1'] / 1e6:.3f} s, convolutions "
          f"{groups['convolution'] / 1e6:.3f} s, wall {wall:.2f} s")


# --------------------------------------------------------------------------
# pretraining: the fused step (K2, K3) at full resnet18 width
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


def pretrain_backbone(widths=None, drop_rate: float = 0.1, seed: int = 0):
    """resnet18-RFS in bf16 (golden flags: --no_dropblock, drop rate 0.1)
    with weights drawn from ``seed``."""
    from subspace_reg_tpu_torch.models.resnet import WIDTHS, ResNetRFS
    torch.manual_seed(seed)
    return ResNetRFS(n_blocks=(1, 1, 2, 2), drop_rate=drop_rate,
                     no_dropblock=True, avg_pool=True,
                     widths=widths or WIDTHS, dtype=torch.bfloat16)


def pretrain_state(backbone, device, n_cls: int = PRETRAIN_CLASSES):
    """A fresh state over a copy of ``backbone``: golden SGD (lr 0.05,
    momentum 0.9, wd 5e-4), no linear bias, the head drawn from seed 1."""
    import copy
    import functools
    from subspace_reg_tpu_torch.engine.pretrain import init_pretrain_state
    from subspace_reg_tpu_torch.utils.optim import sgd_torch
    tx = functools.partial(sgd_torch, learning_rate=0.05, momentum=0.9,
                           weight_decay=5e-4)
    return init_pretrain_state(copy.deepcopy(backbone), n_cls, tx, False,
                               torch.Generator().manual_seed(1), device)


def pretrain_step(state, device, fused: bool, backend: str = "xla"):
    """The device-data step over ``state``'s backbone (golden schedule:
    decay at epochs 60 and 80, 100 steps an epoch)."""
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.engine.pretrain import (
        make_train_step_device_data)
    from subspace_reg_tpu_torch.utils.optim import step_decay_schedule
    spec, _ = transforms_options["A"]
    return make_train_step_device_data(
        state.backbone, step_decay_schedule(0.05, [60, 80], 0.1, 100), spec,
        False, TorchDraws(1, device), fused=fused, fused_backend=backend)


def _named_params(state):
    out = dict(state.backbone.named_parameters())
    out.update({f"head.{k}": v for k, v in state.head.items()})
    return out


def step_agreement(device, backbone, data, labels, idxs,
                   backend: str = "pallas", n_cls: int = PRETRAIN_CLASSES):
    """The fused step against the module step from the same weights and
    batch, inside the chaos-control envelope of
    tests/test_fused_forward.py:55-125: loss within 3%, running statistics
    within 0.05 (rtol and atol), every block counter at 1, and per
    parameter the fused-vs-module update difference at most 3x that of the
    module step from weights perturbed by 0.4% (bf16's half ulp), or 2% of
    the update.  Both steps draw the same augmentation and dropout.
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
    m_ref = pretrain_step(s_ref, device, False)(s_ref, data, labels, idxs)
    pretrain_step(s_ctl, device, False)(s_ctl, data, labels, idxs)
    m_fus = pretrain_step(s_fus, device, True, backend)(s_fus, data, labels,
                                                         idxs)
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


def phase_pretrain_agree(dev):
    """Phase 7: the fused-"pallas" step agrees with the module step on the
    card at full width, 84 px, batch 64."""
    data, labels = pretrain_data(dev)
    idxs = torch.from_numpy(np.random.RandomState(2).randint(
        0, len(labels), BATCH)).to(dev)
    l_ref, l_fus, worst = step_agreement(dev, pretrain_backbone(), data,
                                         labels, idxs)
    print(f"[pretrain-agree] loss module {l_ref:.6f} fused-pallas "
          f"{l_fus:.6f}; worst update difference {worst:.3f} of its "
          "allowance; running stats and counters within the envelope")


def phase_pretrain_main(dev, counters, steps: int = 20):
    """Phase 8, the pretraining main path: ``steps`` device-data steps at
    full resnet18 width, 84 px, batch 64, for the module path, fused
    "xla" and fused "pallas", in two rounds (ABC then CBA), each after 3
    warm-up steps; host clock around work ending in a synchronise.  Every
    launch counter is set to 0 just before each timed run and read just
    after: fused "pallas" must launch K2 6 times and K3 twice per step, the
    others neither."""
    data, labels = pretrain_data(dev)
    bb = pretrain_backbone()
    r = np.random.RandomState(3)
    batches = [torch.from_numpy(r.randint(0, len(labels), BATCH)).to(dev)
               for _ in range(steps + 3)]
    paths = (("module", False, "xla"), ("fused xla", True, "xla"),
             ("fused pallas", True, "pallas"))
    runs = {}
    for label, fused, backend in paths:
        st = pretrain_state(bb, dev)
        runs[label] = (st, pretrain_step(st, dev, fused, backend))
    timings = {label: [] for label, _, _ in paths}
    main_launches = None
    for order in (paths, paths[::-1]):
        for label, fused, backend in order:
            st, step = runs[label]
            for i in range(3):
                step(st, data, labels, batches[i])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            t0 = time.time()
            for i in range(steps):
                m = step(st, data, labels, batches[3 + i])
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {c.__name__: c.launches for c in counters}
            check(math.isfinite(float(m["loss"])), f"{label}: loss not "
                  "finite")
            want = ({"conv3x3_fused": 6 * steps, "block_tail": 2 * steps}
                    if label == "fused pallas" else {})
            for c in counters:
                check(launches[c.__name__] == want.get(c.__name__, 0),
                      f"{label}: {c.__name__} launched "
                      f"{launches[c.__name__]} times in {steps} steps")
            if label == "fused pallas" and main_launches is None:
                main_launches = launches
            ms = 1e3 * wall / steps
            timings[label].append(ms)
            print(f"[pretrain] {label}: {ms:.3f} ms/step, "
                  f"{BATCH * steps / wall:.1f} images/s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                  f"final loss {float(m['loss']):.4f}; launches {launches}")
    return main_launches, runs["fused pallas"], (data, labels, batches)


def phase_pretrain_profile(run, data_batches, steps: int = 5):
    """Phase 9: fused-"pallas" steps under torch.profiler: device time of
    K2, K3, the library convolutions (the conv backward, the 1x1
    downsample, stages 3-4) and the rest."""
    from torch.profiler import ProfilerActivity, profile
    st, step = run
    data, labels, batches = data_batches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for i in range(steps):
            step(st, data, labels, batches[i])
        torch.cuda.synchronize()
        wall = time.time() - t0
    groups, busy, by_name = kernel_breakdown(
        prof, [("K2", ("conv3x3_kernel", "reduce_partials")),
               ("K3", ("block_tail_kernel",)), ("convolution", _CONV_MARKS)])
    check(groups["K2"] > 0 and groups["K3"] > 0,
          "the profiler saw no K2 or K3 launch")
    print_breakdown(f"pretrain-profile {steps} steps", groups, busy, by_name,
                    wall)
    from torch.autograd import DeviceType
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and e.name not in _TRACER_OVERHEAD)
    print(f"[pretrain-profile] {n_kernels / steps:.0f} device kernels per "
          f"step; {1e3 * wall / steps:.3f} ms per step under the profiler")


def phase_pretrain_cli(tmp):
    """Phase 10: ``python -m subspace_reg_tpu_torch.train_supervised`` for
    one epoch at 84 px with the golden model and optimizer flags, on
    category-split synthetic miniImageNet (64 classes x 100 images), to a
    saved ``.pth`` that the port's loader reads back."""
    from subspace_reg_tpu_torch import train_supervised
    from subspace_reg_tpu_torch.data import synthetic
    from subspace_reg_tpu_torch.weights import load_checkpoint
    root = f"{tmp}/pretrain"
    t0 = time.time()
    synthetic.make_mini_imagenet_category_split(
        f"{root}/data/miniImageNet", per_class=100, img_size=84, seed=0)
    print(f"[cli] set-up (synthetic category split) {time.time() - t0:.1f} s")
    argv = ["--trial", "pretrain", "--model_path", f"{root}/save",
            "--tb_path", f"{root}/tb", "--data_root", f"{root}/data",
            "--classifier", "linear", "--model", "resnet18",
            "--save_freq", "100", "--no_dropblock", "--no_linear_bias",
            "--set_seed", "1", "--epochs", "1", "--print_freq", "20",
            "--device", "cuda"]
    tee = _Tee(sys.stdout)
    old = sys.stdout
    sys.stdout = tee
    try:
        t0 = time.time()
        state = train_supervised.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        sys.stdout = old
    out = tee.buf.getvalue()
    for line in ("Epoch: [1][0/100]", "Epoch: [1][80/100]", " * Val Acc@1",
                 "==> Saved resnet18_last.pth"):
        check(line in out, f"the CLI did not print {line!r}")
    check(state.step == 100, f"the CLI took {state.step} steps, not 100")
    sd, head, meta = load_checkpoint(f"{root}/save/resnet18_last.pth")
    check(tuple(head.weight.shape) == (64, 640) and head.bias is None
          and meta["epoch"] == 1, "the saved checkpoint's head or epoch")
    check(all(torch.isfinite(v).all() for v in sd.values()
              if v.is_floating_point()), "the saved weights are not finite")
    print(f"[cli] one epoch (100 steps + validation) {wall:.2f} s; "
          "checkpoint read back")


def sass_count(lib: str, opcode: str) -> int:
    """Instructions of ``opcode`` in a built library's SASS, read with the
    toolkit's ``cuobjdump -sass``."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(tool), "cuobjdump not found")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    import re
    pat = re.compile(r"\b" + opcode + r"\b")
    return sum(1 for line in sass.splitlines() if pat.search(line))


def ptxas_usage(log: str, entry: str):
    """(registers, spill store bytes) of each entry function whose name
    holds ``entry``, from nvcc's ``-Xptxas -v`` report."""
    import re
    usage, cur, spill = [], False, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur, spill = entry in line, None
        elif cur and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif cur and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            usage.append((regs, spill))
            cur = False
    return usage


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-kernels", action="store_true",
                    help="stop after phase 3: print the kernels line and "
                    "not the final ok line")
    only_kernels = ap.parse_args(argv).only_kernels
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1
    # phase 1: device
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from subspace_reg_tpu_torch.utils.device import resolve_device
    dev = resolve_device("cuda")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 still on")
    print(f"[device] {name} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; TF32 off")

    # phase 2: build
    from subspace_reg_tpu_torch.utils.cuda_build import build_all
    for kname, info in build_all().items():
        print(f"[build] {kname}: {info['seconds']:.1f} s -> {info['path']}")
        print(info["ptxas"].strip())
        n_hgmma = sass_count(info["path"], "HGMMA")
        print(f"[build] {kname}: {n_hgmma} HGMMA instructions in its SASS")
        if kname == "conv3x3_fused":
            check(n_hgmma > 0, "K2's library holds no HGMMA instruction")
        if kname == "block_tail" and info["ptxas"]:
            # __launch_bounds__(256, 4): 64 registers a thread at most
            usage = ptxas_usage(info["ptxas"], "block_tail_kernel")
            print(f"[build] block_tail: (registers, spill stores) of its "
                  f"{len(usage)} instances {usage}")
            check(len(usage) == 4 and all(
                regs <= 64 and spill == 0 for regs, spill in usage),
                "K3's instances exceed 64 registers or spill")

    # phase 3: kernels against their plain versions
    rows = phase_kernels(dev)
    rows["conv3x3_fused"] = phase_k2()
    rows["block_tail"] = phase_k3(dev)
    if only_kernels:
        print(smi)
        print(json.dumps({"kernels": list(rows.values())}))
        return 0

    from subspace_reg_tpu_torch.ops.conv_fused import (block_tail,
                                                       conv3x3_fused)
    from subspace_reg_tpu_torch.ops.finetune import finetune_loop
    counters = [finetune_loop, conv3x3_fused, block_tail]
    with tempfile.TemporaryDirectory() as tmp:
        # phase 4: the engine agrees with its CPU run
        phase_agree(tmp)
        # phase 5: the evaluation path, with the launch counters
        launches, run = phase_main(tmp, counters)
        rows["finetune_loop"]["launches"] = launches["finetune_loop"]
        # phase 6: where the evaluation path's device time goes
        phase_profile(run)
        # phase 7: the fused pretraining step agrees with the module step
        phase_pretrain_agree(dev)
        # phase 8: the pretraining path, with the launch counters
        launches, run, data = phase_pretrain_main(dev, counters)
        for kname in ("conv3x3_fused", "block_tail"):
            rows[kname]["launches"] = launches[kname]
        # phase 9: where the fused step's device time goes
        phase_pretrain_profile(run, data)
        # phase 10: the pretraining CLI for one epoch
        phase_pretrain_cli(tmp)

    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
