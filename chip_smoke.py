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
  3. kernels  each kernel checked against its plain version at the shapes
              it is timed at (the support module's measures, as the gpu
              tests hold them), then timed alone beside its plain version,
              its library call where one exists, and its bound
              (operations at the type's
              peak or bytes at the HBM rate, the benchmark's constants
              and K1's operation and byte counts): K1 (the fused head
              fine-tune loop, a cooperative grid of one block per SM) at
              the golden run's 1000 epochs at the last session's shapes
              on miniImageNet (100 classes, 185 support and 175 of 200
              replay rows) and tieredImageNet (391 classes, 476 support
              rows), and seed-batched at S = 10 beside 10 single-seed
              launches; K2 and K3 at every shape of the fused step at
              84 px and at CIFAR's 32 px (K3 alone in a CUDA graph,
              torch.profiler's mean kernel duration within
              ``K3_PROFILER_SHARE``; through its wrapper; beside a
              device-to-device copy); K4 at the forward's 22 convolutions
              at each of the evaluation's batch sizes (``K4_ROWS``)
              beside ``F.conv2d`` f32 with TF32 off, and the cuDNN kernels
              it ran; K5 at the pretraining step's 22 BatchNorms (a CUDA
              graph of its launches and torch's reductions between them,
              and through its wrapper) beside ``F.batch_norm`` +
              ``F.leaky_relu``.  tests/test_torch_kernels_gpu.py adds
              the edge shapes, reruns and refusals.
  4. agree    the port's 8-session engine on the card against the same
              engine on the CPU (plain twin) at a small size with the same
              draws, for the subspace, semantic and mapping pulls: equal
              epoch counts, accuracies within 0.5.
  5. main     the evaluation path: the golden subspace-reg + memory
              evaluation (README quick start flags), then the semantic
              subspace and the mapping configurations, through
              ``few_shot_finetune_incremental_test``:
              8 sessions, full-width resnet18, 84 px synthetic
              miniImageNet made from a seed, random weights from a seed.
              Every kernel launch counter is set to 0 just before and read
              just after each run; K1 must have launched once per session,
              K2/K3 never, K4 22 times in each of the run's 48 backbone
              forwards (``K4_EVAL_LAUNCHES``).
  (6. none: eval-mini84's traced runs profile the golden run.)
  7. pretrain-agree  the fused-"pallas" pretraining step (K2 + K3) against
              the module step at full resnet18 width, 84 px, batch 64, from
              the same weights and batch: loss, running statistics,
              counters and parameter updates inside the chaos-control
              envelope.
  8. pretrain the pretraining path: 20 timed device-data steps each of the
              module path, fused "xla" and fused "pallas" (two rounds),
              with every launch counter set to 0 just before each run and
              read just after (K2 6 and K3 2 launches per fused-"pallas"
              step, none elsewhere), and K5's counter with them (2 + 2
              launches per BatchNorm that runs as a module: 88 a module
              step of resnet18's 22, 56 a fused step, whose stages 3-4
              keep the modules); ms/step, images/s, peak memory.
  9. pretrain-profile  fused-"pallas" steps under torch.profiler: device
              time of K2, K3, the library convolutions and the rest.
  10. cli     ``python -m subspace_reg_tpu_torch.train_supervised`` for one
              epoch (golden model/optimizer flags, 84 px, 64 classes x 100
              synthetic images) to a saved ``.ckpt``, read back.
  11. multiseed  ``python -m subspace_reg_tpu_torch.run_seeds --vmap`` on
              the golden flags for 3 seeds at full width (84 px, 560
              synthetic images a class, a seeded ``.pth`` per seed) beside
              one single-seed run, with the launch counters: K1 8 launches
              of 3 seeds each, one prediction dump a seed
              (``--save_preds_0``; the checkpoints' ``training_classes``
              from the split, every row mapped to an original label);
              then 3 seeds at the small size through the
              multi-seed engine against single-seed runs, all on the card:
              equal epochs.
  12. resume  ``python -m subspace_reg_tpu_torch.train_supervised`` on
              synthetic CIFAR-FS (32 px, resnet12 at full width, batch 64,
              golden flags): 2 epochs straight against 1 epoch and a
              ``--reload_path`` second (cuDNN deterministic): equal steps,
              every weight, statistic and optimizer buffer within
              ``RESUME_ATOL``, the ``.ckpt`` read back leaf for leaf; the
              fused-"pallas" step at 32 px against the module step, and
              ms/step of both with the launch counters.
  13. datasets  ``python -m subspace_reg_tpu_torch.eval_incremental`` with
              the golden flags on tieredImageNet (full-width resnet18,
              84 px, 351 base classes, 175 val classes) and CIFAR-FS
              continual (resnet12, 32 px), each from a seeded ``.ckpt``;
              K1 once per session; then the card-against-CPU epoch check
              of phase 4 on both at small width.
  14. modes   the evaluation's other modes: card against CPU at phase
              4's small width for ``--track_weights`` (epochs exact,
              accuracies within 0.5, the CSV's weights within 1e-4) and
              ``--freeze_backbone_at 3`` with memory and dropout on
              (epochs exact; two deterministic card runs bit-identical;
              every session from one state on both devices: accuracies
              within 0.5, the backbone within ``FREEZE_SHARE`` of the
              session's update); phase 5's golden run
              with ``--save_preds_0`` (epochs and accuracies equal phase
              5's, K1 8 launches, 8 x (125 + 1000) dump rows); the general
              freeze at full width (``--freeze_backbone_at 3``, epochs cut
              to 100: losses finite, the backbone trained by session 0,
              seconds per session, ms per backbone epoch); the tracked
              path (3 sessions of at most 20 epochs) against the K1 run of
              the same flags (ms per tracked epoch, CSV bytes); the vis
              frames (PNG headers) and ``make_predict_fn`` on the base
              batch's 1000 images (labels equal the engine's argmax, ms).
  15. pretrain-rest  the rest of pretraining, golden flags, full-width
              resnet18 at 84 px, batch 64, cuDNN deterministic for every
              comparison: (a) ``PrefetchLoader`` over a 635 MB host store
              (60 x 500 images): an epoch byte for byte, then 50 streamed
              against 50 device-data steps in turns, bit-identical losses,
              ms/step and the consumer's wait, a batch's parts timed
              alone, and an epoch of a 2.54 GB store (above the 2 GiB
              device-data limit) byte for byte; (b) the CLI one epoch
              streamed (``DEVICE_DATA_MAX_BYTES=0``) against staged, the
              ``.ckpt``s within ``RESUME_ATOL``; (c) ``run_seeds
              --pretrain --vmap`` for 3 seeds (continual split cut to
              30/5 images a base class), 2 epochs against 1 + a
              ``--resume`` second and lane 1 against the single-seed CLI,
              within ``RESUME_ATOL``, aggregate images/s against the
              single seed's, peak memory; (d) one CLI epoch under
              ``torchrun --nproc_per_node 1`` (NCCL) against the plain
              run, a (2, 1) mesh of two gloo ranks on the card against
              the single-process step (tests/torch_support.py), and the
              CLI on two gloo ranks on the card, one step on random and
              on class-coloured pixels: in f32 against the single
              process at the CPU test's tolerances, in bf16 as accurate
              as the single process against its f32 twin.  K1, K2 and K3
              launch 0 times on these paths.
  16. distill  distillation pretraining and the mapping trainer: (a) KD
              at full width (resnet18, 84 px, batch 64, bf16, a seeded
              64-class resnet18 teacher, T 4, alpha = beta = 1): the
              fused "pallas" KD step against the module KD step inside
              phase 7's envelope, the counters around it (K2 6, K3 2,
              K1 0), then 10 timed steps each of the module step, module
              KD and fused KD in two rounds, the teacher's statistics and
              counters unchanged; (b) NCE/CRD at the RFS geometry over
              15a's 30,000-image store (feat_dim 128, nce_k 16384, T
              0.07, m 0.5): one ``nce_forward`` card against CPU (rtol
              1e-5, updated rows atol 1e-6, untouched rows bit-identical)
              and its time in each contrast form, then 10 timed steps
              each of NCE in the three forms and of CRD; (c) the CLI's
              ``--distill kd|crd|nce`` one epoch each on phase 10's data
              with phase 10's ``.ckpt`` as the teacher, and on a split
              cut to 20 images a class (cuDNN deterministic) ``--distill
              nce`` 2 epochs straight against 1 + a resumed 1,
              bit-identical, and 1 epoch streamed from the host against
              staged, within ``RESUME_ATOL``; (d) ``learn_mapping``
              on the card from phase 11's seed-1 weights (60 base rows,
              300 -> 640, 1000 epochs) against the CPU, then the
              8-session mapping configuration on the mapped ``.ckpt``
              through the eval CLI (K1 8 launches).
  17. mesh    pretraining on a mesh of two ranks, the parity gate, the
              seed layout: (a) the fused step (full-width resnet18, 84 px,
              global batch 64) on two gloo ranks on the one card, bf16
              "pallas" (K2/K3, their epilogue sums all-reduced between
              the launches) as accurate as the single process against the
              f32 twin, f32 "xla" at the CPU test's tolerances, each
              rank's K2/K3 launches (6 and 2 a step) read from the rank;
              (b) KD, NCE and CRD on two ranks against the single process
              (f32, feat_dim 128, nce_k 16384), the banks bit-identical
              across the ranks after two NCE steps, and the CLI with
              ``--distill nce`` for one epoch under ``torchrun
              --nproc_per_node 2`` on phase 10's data; (c) the port's
              parity fixture (``run_parity_gate_fixture``), one seed, the
              four configurations, record then compare on phase 11's data
              and seed-1 weights: PASSED, K1 8 launches a run; (d) the
              multi-seed evaluation with ``shard_over_devices=True``
              against ``False``, 3 seeds at phase 4's size: bit-identical.
  18. orbax  orbax directory checkpoints and event files: (a) phase 5's
              full-width resnet18 state (105 MB) from the card through
              ``save_orbax``/``load_orbax`` and ``save_checkpoint``/
              ``load_checkpoint``, without and with a head bias: every
              leaf, the head, ``n_active``, ``has_bias`` and ``meta``
              bit-identical; seconds, MB/s, both sizes on disk; and
              the committed directory JAX ``save_orbax`` wrote
              (tests/fixtures/orbax_resnet, zstd-compressed by orbax)
              through ``load_orbax``, bit-identical to its ``.ckpt``
              twin, its weights in a narrow resnet12 on the card; (b) the
              8-session golden evaluation from the orbax-loaded weights
              and from the ``.ckpt`` (cuDNN deterministic, the same
              draws): K1 once a session, the printed traces identical;
              (c) one ``MetricWriter``'s event file read back by a
              TFRecord reader here: masked CRCs, file version, tags,
              steps and f32 values.

Each phase's seconds are printed before the JSON lines.  The line before
the last is one JSON object with each kernel's launches on its path, its
time, the plain version's time, its roofline bound and the library call's
time; the last line is ``{"ok": true, "device": ...}``.

``--only-kernels`` stops after phase 3 for quick iteration on a kernel: it
prints the kernels line (launches null) and no ok line.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from benchmark.flops import k1_bytes, k1_epoch_flops  # noqa: E402
from benchmark.harness import (HBM_BYTES_PER_S, PEAK_FLOPS, ROOT,  # noqa: E402
                               TRACER_OVERHEAD, load_module)
from torch_support import (  # noqa: E402
    BATCH, BF16_ACCURACY_MAX, GOLDEN_ARGV, K2_CIFAR_SHAPES, K2_SHAPES,
    K3_CIFAR_SHAPES, K3_SHAPES, K4_ROWS, K4_SHAPES, K4_TOL, K5_SHAPES,
    LOSS_RTOL, N_SESSIONS, PRETRAIN_CLASSES, RANK_SCRIPT, SMALL_ARGS,
    SMALL_WIDTHS, TIERED_BASE, agreement, as_numpy, bf16_readings, check,
    check_k1_matches_plain, ckpt_diff, ckpt_leaves, cli_agreement,
    config_argv, engine_inputs, f32_compute, golden_opt, golden_tx, k1_case,
    k1_seed_case, k2_agreement, k2_case, k3_agreement, k3_case, k4_case,
    k5_agreement, k5_agreement_ok, k5_case, k5_chain, k5_module, launch,
    pretrain_backbone, pretrain_data, pretrain_state, pretrain_step,
    pretrain_teacher, ranks_identical, reference, repo_env, run_engine,
    seeded_ckpt, small_data, small_model, stats_excess, step_agreement,
    tree_items, write_continual_mini, write_one_step_split)

# K3's kernel-alone time from the CUDA graph and torch.profiler's mean
# kernel duration agree within this share of the former; at CIFAR's
# shapes, whose launches last ~5 us, the graph's time per launch may
# instead exceed the profiler's by up to the gap between two graph nodes
K3_PROFILER_SHARE = 0.05
K3_LAUNCH_GAP_MS = 0.001
# K4's launches in a golden 8-session run: resnet18's 22 convolutions in
# each of 48 backbone forwards (eval_base, and per session the epoch-1
# support forward, the four cached forwards and, in sessions 2-8, the
# epoch-1 replay forward)
K4_EVAL_LAUNCHES = 22 * (1 + 5 * N_SESSIONS + N_SESSIONS - 1)


# --------------------------------------------------------------------------
# phase 3: each kernel alone
# --------------------------------------------------------------------------
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


def k4_flops(batch: int, cin: int, cout: int, hw: int, r: int) -> float:
    return 2.0 * batch * hw * hw * cout * cin * r * r


def k5_bytes(numel: int) -> float:
    """K5's bytes at the bound for one BatchNorm, forward and backward: x
    read and y written, then x and dy read and dx written, bf16."""
    return 2.0 * numel * (2 + 3)


def library_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` runs (torch.profiler),
    cut to 60 characters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name[:60] not in names:
            names.append(e.name[:60])
    return names


def k3_bytes(y3) -> int:
    """K3's bytes: y3 and r read once, the four f32 affines, the bf16 pooled
    map and the int8 record written once."""
    n_in, c = y3.numel(), y3.shape[1]
    return 2 * n_in * 2 + 4 * c * 4 + (n_in // 4) * 3


def roofline_ms(flops: float, nbytes: float, dtype: str = "bf16"):
    """The larger of operations at ``dtype``'s dense peak and bytes at the
    HBM rate (the benchmark's constants), in ms, and which of the two it
    is."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def k1_roofline(ops, cfg, epochs: int):
    """K1's bound for one launch of ``epochs`` epochs (the first is the
    engine's, outside the loop), by the benchmark's operation and byte
    counts."""
    d = ops["w"].shape[1]
    flops = (epochs - 1) * k1_epoch_flops(cfg.n_sup, cfg.mem_count,
                                          cfg.n_active, d, cfg.n_ways)
    nbytes = k1_bytes(cfg.n_sup, ops["f_mem"].shape[0], ops["w"].shape[0],
                      d, cfg.trace_rows)
    return roofline_ms(flops, nbytes, "f32")


def phase_k1(dev):
    """K1 at the golden run's 1000 epochs (random weights never meet the
    stable rule), at the last session's shapes on miniImageNet (100
    classes, 185 support and 175 of 200 replay rows) and on
    tieredImageNet (391 classes, 476 and 175 rows): the launch checked
    against the plain version (``check_k1_matches_plain``; the accuracies
    of up to 10 epochs a support row off), its time, the plain version's
    and the bound; then the seed-batched launch at S = 10 (seeds 0..9),
    its seed 0 checked against the plain version too, beside 10
    single-seed launches on all SMs back to back, and the bound."""
    from subspace_reg_tpu_torch.ops import finetune as ft
    p = ft.k1_blocks(dev)
    print(f"[kernels] K1 grid: P = {p} blocks of {ft.K1_THREADS} threads "
          f"(one per SM)")
    row = dict(name="finetune_loop", route="cuda",
               source="subspace_reg_tpu_torch/csrc/finetune_loop.cu",
               replaces="subspace_reg_tpu/ops/pallas/finetune.py:352",
               launches=None, library_ms=None, blocks=p)
    n_seeds = 10
    for tag, orig_base in (("", 60), ("tiered_", TIERED_BASE)):
        ops, cfg = k1_case("sgd", dev, max_epochs=1000,
                           stable_target=10 ** 6, orig_base=orig_base)
        ep = check_k1_matches_plain(ops, cfg, ft.finetune_loop(**ops, cfg=cfg),
                                    acc_flips=10)
        check(ep == 1000, f"K1 at {orig_base} base classes ran {ep} of "
              "1000 epochs")
        ms = cuda_ms(lambda: ft.finetune_loop(**ops, cfg=cfg), 3)
        plain_ms = cuda_ms(lambda: ft.finetune_loop_plain(**ops, cfg=cfg), 1)
        bound_ms, bound_by = k1_roofline(ops, cfg, ep)
        stacked, per, cfg = k1_seed_case("sgd", dev, n_seeds, max_epochs=1000,
                                         stable_target=10 ** 6,
                                         orig_base=orig_base)
        out = ft._launch_seeds(stacked, cfg)
        check_k1_matches_plain(per[0], cfg, tuple(t[0] for t in out),
                               acc_flips=10)
        seeds_ms = cuda_ms(lambda: ft._launch_seeds(stacked, cfg), 2)
        seq_ms = cuda_ms(lambda: [ft._launch(o, cfg) for o in per], 1)
        seeds_bound = sum(k1_roofline(o, cfg, ep)[0] for o in per)
        us_epoch = 1e3 * ms / (ep - 1)
        print(f"[kernels] K1 {cfg.n_active} classes, {cfg.n_sup} + "
              f"{cfg.mem_count} rows, {ep - 1} epochs/launch: kernel "
              f"{ms:.3f} ms ({us_epoch:.2f} us/epoch), plain "
              f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.2f}% of the bound; seed-batched "
              f"S={n_seeds} (G={p // n_seeds}) {seeds_ms:.3f} ms "
              f"({1e3 * seeds_ms / (ep - 1) / n_seeds:.2f} us per "
              f"seed-epoch) against {seq_ms:.3f} ms for {n_seeds} "
              f"single-seed launches ({seq_ms / seeds_ms:.2f}x); bound "
              f"{seeds_bound:.4f} ms, {100 * seeds_bound / seeds_ms:.2f}% "
              "of it")
        row.update({tag + k: v for k, v in dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            us_per_epoch=us_epoch, seeds_ms=seeds_ms,
            seeds_sequential_ms=seq_ms, seeds_bound_ms=seeds_bound).items()})
    row.update(epochs_per_launch=ep - 1, seeds=n_seeds)
    return row


def phase_k2(shapes=K2_SHAPES):
    """K2 at every shape of the fused step (batch 64; ``shapes``: the 84 px
    step's, or CIFAR's at 32 px): each checked against the plain version
    (``k2_agreement``: y within 1 bf16 ulp at no less than 2^-8 of its
    summed |terms|, at most 0.1% of elements differing, the statistics to
    1e-4), then CUDA-event times of the wrapper call,
    the plain version and the one-call yardstick ``F.conv2d`` in bf16
    channels_last (the convolution alone, without prologue or
    statistics), and the bound; its row sums each time over one step's
    launches (conv1 once and conv2/conv3 twice per stage)."""
    from subspace_reg_tpu_torch.ops import conv_fused as cf
    F = torch.nn.functional
    dev = torch.device("cuda")
    k2 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
              shapes=[])
    ops_ms = bytes_ms = 0.0
    for name, cin, cout, hw, pro in shapes:
        x, w, aff = k2_case(cin, cout, hw, pro, dev)
        _, _, ulps, share, st_err, _ = k2_agreement(x, w, aff, pro)
        check(ulps <= 1.0 and share <= 1e-3 and st_err <= 1e-4,
              f"K2 {name}: {ulps} ulps, {share} of the elements differ, "
              f"statistics {st_err} from its plain version")
        wb = w.to(torch.bfloat16)
        ms = cuda_ms(lambda: cf.conv3x3_fused(x, w, aff, relu_in=pro), 20)
        plain_ms = cuda_ms(
            lambda: cf.conv3x3_fused_plain(x, w, aff, relu_in=pro), 5)
        lib_ms = cuda_ms(lambda: F.conv2d(x, wb, padding=1), 20)
        b = x.shape[0]
        flops = 2.0 * b * hw * hw * cout * cin * 9
        nbytes = (x.numel() * 2 + w.numel() * 4 + b * cout * hw * hw * 2
                  + (2 * cin * 4 if pro else 0) + 2 * cout * 4)
        bound, by = roofline_ms(flops, nbytes)
        reps = 1 if cin == 3 or name.endswith("64->160") else 2
        print(f"[kernels] K2 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
              f" ms, F.conv2d bf16 {lib_ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}); {100 * bound / ms:.1f}% of the bound, "
              f"{ms / lib_ms:.2f}x F.conv2d; {reps} launch(es) per step")
        k2["shapes"].append(dict(shape=name, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=bound,
                                 bound_by=by, bound_share=bound / ms,
                                 vs_library=ms / lib_ms))
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound)):
            k2[key] += reps * v
        ops_ms += reps * 1e3 * flops / PEAK_FLOPS["bf16"]
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


def phase_k3(dev, shapes=K3_SHAPES, launch_gap_ms: float = 0.0):
    """K3 at both shapes of the fused step (``shapes``: the 84 px step's,
    or CIFAR's at 32 px, where ``launch_gap_ms`` allows the graph's gaps
    between launches): bit-identical to the plain version
    (``k3_agreement``), then the kernel alone (outputs allocated once, bare
    launches in a CUDA graph; cross-checked with torch.profiler), the
    wrapper call, the plain version, the bytes bound, the share of it and
    the effective GB/s, beside a device-to-device copy of the shape's y3
    as the rate this card reaches.  The row sums each time over one step's
    two launches; its copy is stage 1's."""
    from subspace_reg_tpu_torch.ops import conv_fused as cf
    k3 = dict(ms=0.0, wrapper_ms=0.0, profiler_ms=0.0, plain_ms=0.0,
              bound_ms=0.0, shapes=[])
    nbytes_all = 0
    for name, c, hw in shapes:
        ops = k3_case(c, hw, hw, dev)
        check(k3_agreement(ops)[2],
              f"K3 {name}: not bit-identical to its plain version")
        vecs, out, idx = cf._k3_operands(*ops)

        def bare():
            cf._k3_launch(ops[0], ops[1], vecs, out, idx)
        ms = graph_ms(bare)
        prof_ms = profiled_kernel_ms(bare, "block_tail")
        # the graph's time adds the gaps between launches to the kernels'
        gap_ok = 0.0 <= ms - prof_ms <= launch_gap_ms
        check(abs(prof_ms - ms) <= K3_PROFILER_SHARE * ms or gap_ok,
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


def phase_k4(dev, rows=K4_ROWS):
    """K4 at every convolution of the evaluation's forward at each of its
    batch sizes: CUDA-event times of the kernel, its bound (operations at
    the f32 peak), the plain version (at 1000 rows, where the kernel's
    output is checked against it within ``K4_TOL`` of its largest) and the
    yardstick
    ``F.conv2d`` f32 with TF32 off on the NCHW input the evaluation used
    to hand it, with the kernels cuDNN ran for it (torch.profiler); per
    forward, the sums over its 22 convolutions."""
    from subspace_reg_tpu_torch.ops import conv_f32 as k4
    F = torch.nn.functional
    per_rows = {}
    shapes = []
    plain_ms = 0.0
    for batch in rows:
        tot = dict(ms=0.0, bound_ms=0.0, library_ms=0.0)
        for name, cin, cout, hw, r, count in K4_SHAPES:
            x, wt = k4_case(cin, cout, hw, hw, r, batch, dev)
            plan = k4.conv_f32_plan(batch * hw * hw, cout, -(-cin // 4) * 4,
                                    k4._sm_count(dev), k4._occupancy(dev))
            reps = max(3, min(50, int(2e10 / k4_flops(batch, cin, cout,
                                                       hw, r))))
            ms = cuda_ms(lambda: k4.conv_f32(x, wt), reps)
            xn = x.contiguous()
            lib_ms = cuda_ms(lambda: F.conv2d(xn, wt, padding=r // 2), reps)
            bound, _ = roofline_ms(k4_flops(batch, cin, cout, hw, r), 0.0,
                                   "f32")
            row = dict(rows=batch, shape=name, ms=ms, bound_ms=bound,
                       library_ms=lib_ms, tile=(plan.bm, plan.bn),
                       grid=plan.grid, tiles=plan.tiles)
            if batch == max(rows):
                plain = k4.conv_f32_plain(x, wt)
                gap = float((k4.conv_f32(x, wt) - plain).abs().max()
                            / plain.abs().max())
                check(gap <= K4_TOL, f"K4 {name} at {batch} rows: "
                      f"{gap:.2e} of the largest output from its plain "
                      "version")
                del plain
                row["plain_ms"] = cuda_ms(lambda: k4.conv_f32_plain(x, wt),
                                          2)
                plain_ms += count * row["plain_ms"]
                row["library_kernels"] = library_kernels(
                    lambda: F.conv2d(xn, wt, padding=r // 2))
            shapes.append(row)
            print(f"[kernels] K4 {name} x{count} at {batch} rows: kernel "
                  f"{ms:.4f} ms ({100 * bound / ms:.1f}% of the bound "
                  f"{bound:.4f}), F.conv2d {lib_ms:.4f} ms "
                  f"({lib_ms / ms:.2f}x), tile {plan.bm}x{plan.bn}, grid "
                  f"{plan.grid} over {plan.tiles} tiles"
                  + (f", plain {row['plain_ms']:.3f} ms, cuDNN ran "
                     f"{row['library_kernels']}" if "plain_ms" in row
                     else ""))
            for key in tot:
                tot[key] += count * row[key]
            del x
        per_rows[batch] = tot
        print(f"[kernels] K4 forward at {batch} rows: kernels "
              f"{tot['ms']:.3f} ms ({100 * tot['bound_ms'] / tot['ms']:.1f}%"
              f" of the bound {tot['bound_ms']:.3f}), F.conv2d "
              f"{tot['library_ms']:.3f} ms ({tot['library_ms'] / tot['ms']:.2f}x)")
    big = per_rows[max(rows)]
    return dict(name="conv_f32", route="cuda",
                source="subspace_reg_tpu_torch/csrc/conv_f32.cu",
                replaces=None, launches=None, ms=big["ms"],
                plain_ms=plain_ms, bound_ms=big["bound_ms"],
                bound_by="operations", library_ms=big["library_ms"],
                rows=max(rows), per_rows=per_rows, shapes=shapes)


def phase_k5(dev, reps: int = 20):
    """K5 at the pretraining step's 22 BatchNorm shapes (batch 64, 84 px,
    each with and without the LeakyReLU, in the layout the step hands
    it): per shape the agreement (``k5_agreement``: bit-identical to the
    plain chain under autograd, to the plain backward twin and to a
    rerun), the device time of its four launches with torch's four
    reductions between them (a CUDA graph of the bare calls), the same
    through the wrapper ``bn_train`` under autograd, the plain twin's (the
    layer's chain under autograd, the step's ops before K5) and the
    library's (``F.batch_norm`` + ``F.leaky_relu`` under autograd),
    forward and backward, and the bound (bytes); the sums over the step's
    22."""
    from subspace_reg_tpu_torch.ops import bn_train as k5
    F = torch.nn.functional
    tot = dict(ms=0.0, wrapper_ms=0.0, bound_ms=0.0, plain_ms=0.0,
               library_ms=0.0)
    shapes = []
    for name, c, hw, n_leaky, n_plain, layout in K5_SHAPES:
        for leaky, count in ((True, n_leaky), (False, n_plain)):
            x, w, b, rm, rv, dy = k5_case(c, hw, BATCH, layout, dev)
            r = k5_agreement(x, w, b, rm, rv, dy, leaky)
            check(k5_agreement_ok(r), f"K5 {name} leaky {int(leaky)}: {r}")
            xg = x.detach().requires_grad_()
            wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()

            def bare():
                # the kernels and torch's reductions between them, without
                # the autograd function (a CUDA graph of them)
                y, mean, e2 = k5._k5_forward(x, w, b, rm, rv, 0.1, 1e-5,
                                             leaky)
                k5._k5_backward(x, dy, mean, e2, w, b, 1e-5, leaky)

            def fwd_bwd():
                y = k5.bn_train(xg, wg, bg, rm, rv, 0.1, 1e-5, leaky)
                torch.autograd.grad(y, (xg, wg, bg), dy)

            ms = graph_ms(bare)
            wrapper_ms = cuda_ms(fwd_bwd, reps)
            bn = k5_module(w, b, rm, rv)

            def plain():
                # the twin: the layer's chain under autograd, the step's
                # ops before K5
                torch.autograd.grad(k5_chain(bn, xg, leaky),
                                    (xg, bn.weight, bn.bias), dy)

            plain_ms = cuda_ms(plain, reps)

            def library():
                y = F.batch_norm(xg, rm, rv, wg, bg, True, 0.1, 1e-5)
                if leaky:
                    y = F.leaky_relu(y, 0.1)
                torch.autograd.grad(y, (xg, wg, bg), dy)

            library_ms = cuda_ms(library, reps)
            bound, _ = roofline_ms(0.0, k5_bytes(x.numel()))
            row = dict(shape=name, c=c, hw=hw, layout=layout, leaky=leaky,
                       count=count, ms=ms, wrapper_ms=wrapper_ms,
                       bound_ms=bound, plain_ms=plain_ms,
                       library_ms=library_ms)
            shapes.append(row)
            print(f"[kernels] K5 {name} leaky {int(leaky)} x{count}: "
                  f"kernels {ms:.4f} ms ({100 * bound / ms:.1f}% of the "
                  f"bound {bound:.4f}), through the wrapper "
                  f"{wrapper_ms:.4f}, plain {plain_ms:.4f}, F.batch_norm "
                  f"{library_ms:.4f}")
            for key in tot:
                tot[key] += count * row[key]
            del x, dy, xg, bn
    print(f"[kernels] K5 the step's 22 BatchNorms, forward and backward: "
          f"kernels {tot['ms']:.3f} ms ({100 * tot['bound_ms'] / tot['ms']:.1f}"
          f"% of the bound {tot['bound_ms']:.3f}), through the wrapper "
          f"{tot['wrapper_ms']:.3f}, plain {tot['plain_ms']:.3f}, "
          f"F.batch_norm {tot['library_ms']:.3f}")
    return dict(name="bn_train", route="cuda",
                source="subspace_reg_tpu_torch/csrc/bn_train.cu",
                replaces=None, launches=None, ms=tot["ms"],
                wrapper_ms=tot["wrapper_ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"], bound_by="bytes",
                library_ms=tot["library_ms"], shapes=shapes)


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


# the paper's pulls beside the golden subspace regularizer: the semantic
# subspace regularizer (--label_pull with the override unset: attractors
# from the word embeddings) and the linear label->image mapping (on the
# 300-d GloVe slice)
CONFIGS = ("subspace", "semantic", "mapping")


def config_meta(config: str, feat: int, seed: int = 4):
    """A checkpoint's ``meta`` for ``config``: for the mapping, a seeded
    LinearMap from the 300-d GloVe slice to ``feat`` features."""
    if config != "mapping":
        return {}
    r = np.random.RandomState(seed)
    return {"mapping_linear_label2image": {
        "weight": (0.05 * r.randn(feat, 300)).astype(np.float32),
        "bias": (0.01 * r.randn(feat)).astype(np.float32)}}


def phase_agree(tmp):
    """Engine on the card vs the same engine on the CPU, small size, for
    the subspace, semantic and mapping configurations: epochs exact,
    accuracies within 0.5."""
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    root = small_data(tmp)
    backbone, head = small_model()
    for config in CONFIGS:
        opt = golden_opt(root, *SMALL_ARGS, "--set_seed", "3",
                         config=config)
        meta = config_meta(config, SMALL_WIDTHS[-1])
        res = {dev: run_engine(root, opt, backbone, head, dev,
                               draws=TorchDraws(opt.set_seed, "cpu"),
                               verbose=False, meta=meta)
               for dev in ("cuda", "cpu")}
        g, c = res["cuda"], res["cpu"]
        print(f"[agree] {config}: epochs card {g.epochs_per_session} cpu "
              f"{c.epochs_per_session}")
        print(f"[agree] {config}: novel card {g.acc_novel_list} cpu "
              f"{c.acc_novel_list}")
        print(f"[agree] {config}: base card {g.acc_base_list} cpu "
              f"{c.acc_base_list}")
        check(g.epochs_per_session == c.epochs_per_session,
              f"{config}: engine epochs differ between card and CPU")
        for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
            a, b = np.asarray(getattr(g, name)), np.asarray(getattr(c, name))
            check(np.all(np.abs(a - b) <= 0.5),
                  f"{config}: {name} differs between card and CPU: {a} vs "
                  f"{b}")
    return root


def phase_main(tmp, counters):
    """The evaluation path at full width for each configuration (subspace,
    semantic, mapping), the launch counters set to 0 just before each run
    and read just after: K1 once per session, K2/K3 never."""
    from subspace_reg_tpu_torch.data import synthetic
    from subspace_reg_tpu_torch.models.factory import create_model
    from subspace_reg_tpu_torch.models.head import init_head
    root = f"{tmp}/golden"
    t0 = time.time()
    synthetic.make_mini_imagenet(f"{root}/miniImageNet", n_classes=100,
                                 per_class=40, img_size=84, seed=0)
    synthetic.make_word_embeds(f"{root}/word_embeds")
    opt = golden_opt(root)
    torch.manual_seed(0)
    backbone = create_model(opt.model, opt, dataset=opt.dataset)
    head = init_head(60, backbone.feature_dim, with_bias=False,
                     max_classes=100,
                     generator=torch.Generator().manual_seed(1))
    print(f"[main] set-up (synthetic data, seeded weights) "
          f"{time.time() - t0:.1f} s")
    from subspace_reg_tpu_torch.ops.conv_f32 import conv_f32
    out_launches = None
    for config in CONFIGS:
        opt = golden_opt(root, config=config)
        tee = _Tee(sys.stdout)
        old = sys.stdout
        for c in counters:
            c.launches = 0
        conv_f32.launches = 0
        sys.stdout = tee
        try:
            res = run_engine(root, opt, backbone, head, "cuda",
                             meta=config_meta(config, backbone.feature_dim))
        finally:
            sys.stdout = old
        launches = {c.__name__: c.launches for c in counters}
        out = tee.buf.getvalue()
        print(f"[main] {config}: epochs {res.epochs_per_session}; launches "
              f"{launches}, conv_f32 {conv_f32.launches}")
        check(conv_f32.launches == K4_EVAL_LAUNCHES,
              f"{config}: K4 launched {conv_f32.launches} times, expected "
              f"{K4_EVAL_LAUNCHES}")
        check(launches["finetune_loop"] == N_SESSIONS,
              f"{config}: K1 launched {launches['finetune_loop']} times, "
              f"expected {N_SESSIONS}")
        check(all(n == 0 for k, n in launches.items()
                  if k != "finetune_loop"),
              f"{config}: the evaluation path launched a pretraining "
              f"kernel: {launches}")
        check(len(res.acc_novel_list) == N_SESSIONS
              and len(res.weighted_avg_l) == N_SESSIONS + 1, "trace length")
        for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
            check(np.all(np.isfinite(getattr(res, name))),
                  f"{config}: {name} not finite")
        check(all(1 <= e <= opt.max_novel_epochs
                  for e in res.epochs_per_session),
              f"{config}: epoch counts out of range")
        for line in ("**** Iteration 8/8 ****", "Novel session accuracies: ",
                     "Overall continual accuracies: ",
                     "Novel only incremental: ", "Base only incremental: ",
                     "Fine-tuning epochs:"):
            check(out.count(line) >= 1,
                  f"{config}: reference line {line!r} not printed")
        check(out.count("Fine-tuning epochs:") == N_SESSIONS,
              "one session block per session")
        if config == "subspace":
            out_launches = dict(launches, conv_f32=conv_f32.launches)
            run = (root, opt, backbone, head)
            golden = res
    return out_launches, run, golden


MULTI_SEEDS = (1, 2, 3)


def training_classes(data_root: str, seed: int):
    """Original label -> row of seed ``seed``'s continual base classes,
    as the split draws them: the ``training_classes`` that pretraining on
    them writes."""
    from subspace_reg_tpu_torch.data.mini_imagenet import load_mini_imagenet
    opt = golden_opt(data_root, "--set_seed", str(seed))
    return load_mini_imagenet(opt, split="train", phase="test",
                              lazy=True).basec_map


def _quiet(fn):
    """(fn(), wall seconds up to a synchronise, what it printed)."""
    buf, old = io.StringIO(), sys.stdout
    sys.stdout = buf
    try:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        sys.stdout = old
    return out, wall, buf.getvalue()


def phase_multiseed(tmp, counters, small_root):
    """The multi-seed evaluation: ``python -m
    subspace_reg_tpu_torch.run_seeds --vmap`` on the golden subspace-reg +
    memory flags for 3 seeds at full resnet18 width (84 px, each seed its
    own seeded ``.pth``), beside one single-seed run in the same call; the
    launch counters set to 0 just before each run and read just after (K1
    8 launches of 3 seeds each; one launch a session); the multi-seed run
    with ``--save_preds_0`` writes one dump per seed.  Then at the small
    size, 3 seeds through the multi-seed engine on the card against
    single-seed runs on the card: epochs exact, accuracies within 0.5."""
    import math as _math
    import os
    from subspace_reg_tpu_torch import run_seeds
    from subspace_reg_tpu_torch.engine.multiseed import (
        few_shot_finetune_multiseed)
    from subspace_reg_tpu_torch.models.factory import create_model
    from subspace_reg_tpu_torch.ops.finetune import finetune_loop
    root = f"{tmp}/multi"
    t0 = time.time()
    write_continual_mini(f"{root}/miniImageNet")

    class O:
        no_dropblock = True
    k = 1.0 / _math.sqrt(640)
    for seed in MULTI_SEEDS:
        torch.manual_seed(seed)
        sd = create_model("resnet18", O()).state_dict()
        sd["classifier.weight"] = torch.empty(60, 640).uniform_(-k, k)
        os.makedirs(f"{root}/seed_{seed}")
        torch.save({"model": sd, "training_classes": training_classes(
            root, seed)}, f"{root}/seed_{seed}/resnet18_last.pth")
    print(f"[multiseed] set-up (84 px synthetic set, 560 images a class; "
          f"{len(MULTI_SEEDS)} seeded checkpoints) {time.time() - t0:.1f} s")
    argv = list(GOLDEN_ARGV)
    i = argv.index("--set_seed")
    del argv[i:i + 2]
    common = ["--device", "cuda", "--model_path_pattern",
              f"{root}/seed_{{seed}}/resnet18_last.pth", "--",
              *argv, "--data_root", root]

    def counted(fn):
        for c in counters:
            c.launches = 0
        finetune_loop.seed_loops = 0
        out, wall, log = _quiet(fn)
        launches = {c.__name__: c.launches for c in counters}
        launches["seed_loops"] = finetune_loop.seed_loops
        return out, wall, launches

    one, wall1, l1 = counted(lambda: run_seeds.main(["--seeds", "1",
                                                     *common]))
    # with one prediction dump per seed, written in the working directory
    with in_dir(f"{tmp}/multi_preds") as d:
        many, wall, launches = counted(lambda: run_seeds.main(
            ["--vmap", "--seeds", *map(str, MULTI_SEEDS), *common,
             "--save_preds_0"]))
        dumps, unmapped = {}, {}
        for f in sorted(os.listdir(f"{d}/csv_files_mem")):
            rows = read_rows(f"{d}/csv_files_mem/{f}")[1]
            dumps[f] = len(rows)
            # rows whose labels found no original label (-1)
            unmapped[f] = sum("-1" in r[3:5] for r in rows)
    n = len(MULTI_SEEDS)
    print(f"[multiseed] single seed: {wall1:.2f} s, launches {l1}, epochs "
          f"{one['epochs'][0]}")
    print(f"[multiseed] run_seeds --vmap, {n} seeds: {wall:.2f} s, "
          f"{wall / n:.2f} s per seed ({wall1 / (wall / n):.2f}x the "
          f"single-seed run's rate); launches {launches}; novel "
          f"{many['novel']}, base {many['base']}")
    check(l1["finetune_loop"] == N_SESSIONS and l1["seed_loops"]
          == N_SESSIONS, f"single seed: K1 launches {l1}")
    check(launches["finetune_loop"] == N_SESSIONS
          and launches["seed_loops"] == n * N_SESSIONS,
          f"multi-seed: K1 launches {launches}, expected {N_SESSIONS} of "
          f"{n} seeds")
    check(launches["conv3x3_fused"] == launches["block_tail"] == 0,
          "the multi-seed evaluation launched a pretraining kernel")
    check(many["epochs"][0] == one["epochs"][0],
          "seed 1's epochs differ between the multi- and single-seed runs")
    check(all(np.isfinite(many[k]["mean"]) and np.isfinite(many[k]["ci95"])
              for k in ("novel", "base")), "aggregates not finite")
    print(f"[multiseed] --save_preds_0: rows of each seed's dump {dumps}; "
          f"rows without an original label {unmapped}")
    # 125 session-0 queries and the base batch a session; the CLI's
    # continual split leaves 560 - 500 - 50 = 10 test images a base class,
    # 600 of the 1000 the base batch may take
    check(sorted(dumps) == sorted(
        f"seed_{s}_miniImageNet_5_1.0_distance2subspace_continual_True_mem_1"
        "_predictions.csv" for s in MULTI_SEEDS)
        and set(dumps.values()) == {N_SESSIONS * (125 + 60 * 10)},
        f"multi-seed prediction dumps {dumps}")
    check(set(unmapped.values()) == {0}, "multi-seed prediction dumps: rows "
          f"without an original label {unmapped}")

    seeds = (3, 4, 5)
    opts = [golden_opt(small_root, *SMALL_ARGS, "--set_seed", str(s))
            for s in seeds]
    models = [small_model(10 + i) for i in range(len(seeds))]
    ins = [engine_inputs(o) for o in opts]
    ms = few_shot_finetune_multiseed(
        [m[0] for m in models], [m[1] for m in models], [{}] * len(seeds),
        opts, [x["meta_sampler"] for x in ins],
        [x["base_test_split"] for x in ins],
        [x["base_support_sampler"] for x in ins], device="cuda")
    for s, opt, (bb, head), got in zip(seeds, opts, models, ms.per_seed):
        want = run_engine(small_root, opt, bb, head, "cuda", verbose=False)
        print(f"[multiseed] small, seed {s}: epochs multi "
              f"{got.epochs_per_session} single {want.epochs_per_session}")
        check(got.epochs_per_session == want.epochs_per_session,
              f"small seed {s}: multi-seed epochs differ from single-seed")
        for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
            a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want,
                                                                      name))
            check(np.all(np.abs(a - b) <= 0.5),
                  f"small seed {s}: {name} {a} vs {b}")
    return dict(multiseed_seeds=n, multiseed_s=wall,
                multiseed_s_per_seed=wall / n, single_seed_s=wall1,
                multiseed_launches=launches["finetune_loop"],
                multiseed_seed_loops=launches["seed_loops"])


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
        if e.device_type != DeviceType.CUDA or e.name in TRACER_OVERHEAD:
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
    others neither; K5's with them (``bn_train``, read here as K4's is in
    phase 5): every BatchNorm that runs as a ``TorchBatchNorm`` goes to
    K5, 2 + 2 launches a step: all of the module path's (88 for
    resnet18's 22), and the fused paths' stages 3-4 (56), their stages 1-2
    bypassing ``TorchBatchNorm``.  The module path runs its first warm-up
    step eagerly and every later one as a replay of its CUDA graph
    (``StepRunner.graph_replays``; the fused paths none): its capture
    counts no launch, each replay the graph's (``BODY_COUNTERS``), so the
    warm-up reads 3 x 88 and 2 replays.  The returned launches are fused
    "pallas"'s, with the module path's K5 count under "bn_train"."""
    from subspace_reg_tpu_torch.engine.pretrain import StepRunner
    from subspace_reg_tpu_torch.models.layers import TorchBatchNorm
    from subspace_reg_tpu_torch.ops.bn_train import bn_train
    data, labels = pretrain_data(dev)
    bb = pretrain_backbone()
    # BatchNorm modules a stage; fused_forward runs stages 1-2 outside them
    per_stage = [sum(isinstance(m, TorchBatchNorm) for m in getattr(
        bb, f"layer{i + 1}").modules()) for i in range(bb.n_stages)]
    n_bn = {"module": sum(per_stage), "fused xla": sum(per_stage[2:]),
            "fused pallas": sum(per_stage[2:])}
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
    main_launches, k5_launches = None, None
    for order in (paths, paths[::-1]):
        for label, fused, backend in order:
            st, step = runs[label]
            l0, r0 = bn_train.launches, StepRunner.graph_replays
            for i in range(3):
                step(st, data, labels, batches[i])
            torch.cuda.synchronize()
            if label == "module" and timings[label] == []:
                # the eager first step, the capture and two replays
                n, replays = (bn_train.launches - l0,
                              StepRunner.graph_replays - r0)
                check(n == 3 * 4 * n_bn[label] and replays == 2,
                      f"module: K5 launched {n} times, {replays} graph "
                      "replays in the 3 warm-up steps")
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            bn_train.launches = 0
            k0 = TorchBatchNorm.kernel_forwards
            r0 = StepRunner.graph_replays
            t0 = time.time()
            for i in range(steps):
                m = step(st, data, labels, batches[3 + i])
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {c.__name__: c.launches for c in counters}
            launches["bn_train"] = bn_train.launches
            kf = TorchBatchNorm.kernel_forwards - k0
            replays = StepRunner.graph_replays - r0
            check(math.isfinite(float(m["loss"])), f"{label}: loss not "
                  "finite")
            want = ({"conv3x3_fused": 6 * steps, "block_tail": 2 * steps}
                    if label == "fused pallas" else {})
            want["bn_train"] = 4 * n_bn[label] * steps
            for kname, n in launches.items():
                check(n == want.get(kname, 0), f"{label}: {kname} launched "
                      f"{n} times in {steps} steps")
            check(kf == n_bn[label] * steps, f"{label}: {kf} BatchNorm "
                  f"forwards took K5 in {steps} steps")
            check(replays == steps * (label == "module"), f"{label}: "
                  f"{replays} graph replays in {steps} steps")
            if label == "fused pallas" and main_launches is None:
                main_launches = launches
            if label == "module" and k5_launches is None:
                k5_launches = launches["bn_train"]
            ms = 1e3 * wall / steps
            timings[label].append(ms)
            print(f"[pretrain] {label}: {ms:.3f} ms/step, "
                  f"{BATCH * steps / wall:.1f} images/s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                  f"final loss {float(m['loss']):.4f}; launches {launches}, "
                  f"graph replays {replays}")
    return (dict(main_launches, bn_train=k5_launches), runs["fused pallas"],
            (data, labels, batches))


def phase_pretrain_profile(run, data_batches, steps: int = 5):
    """Phase 9: fused-"pallas" steps under torch.profiler: device time of
    K2, K3, the library convolutions (the conv backward, the 1x1
    downsample, stages 3-4) and the rest."""
    from torch.profiler import ProfilerActivity, profile
    # cuDNN's convolution kernels by the names eval.conv_ms_per_seed reads
    conv_marks = load_module(
        ROOT / "benchmark" / "metrics" / "eval.conv_ms_per_seed.py",
        "eval.conv_ms_per_seed").CONV_MARKS
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
               ("K3", ("block_tail_kernel",)), ("convolution", conv_marks)])
    check(groups["K2"] > 0 and groups["K3"] > 0,
          "the profiler saw no K2 or K3 launch")
    print_breakdown(f"pretrain-profile {steps} steps", groups, busy, by_name,
                    wall)
    from torch.autograd import DeviceType
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and e.name not in TRACER_OVERHEAD)
    print(f"[pretrain-profile] {n_kernels / steps:.0f} device kernels per "
          f"step; {1e3 * wall / steps:.3f} ms per step under the profiler")


def phase_pretrain_cli(tmp):
    """Phase 10: ``python -m subspace_reg_tpu_torch.train_supervised`` for
    one epoch at 84 px with the golden model and optimizer flags, on
    category-split synthetic miniImageNet (64 classes x 100 images), to a
    saved ``.ckpt`` that the port's loader reads back."""
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
                 "==> Saved resnet18_last.ckpt"):
        check(line in out, f"the CLI did not print {line!r}")
    check(state.step == 100, f"the CLI took {state.step} steps, not 100")
    sd, head, meta = load_checkpoint(f"{root}/save/resnet18_last.ckpt")
    check(tuple(head.weight.shape) == (64, 640) and head.bias is None
          and meta["epoch"] == 1, "the saved checkpoint's head or epoch")
    check(all(torch.isfinite(v).all() for v in sd.values()
              if v.is_floating_point()), "the saved weights are not finite")
    print(f"[cli] one epoch (100 steps + validation) {wall:.2f} s; "
          "checkpoint read back")


def trees_bit_equal(a, b) -> bool:
    """Every leaf of two nested dicts equal in path, dtype, shape and
    bytes."""
    la, lb = dict(tree_items(a)), dict(tree_items(b))
    if la.keys() != lb.keys():
        return False
    for k in la:
        x, y = as_numpy(la[k]), as_numpy(lb[k])
        if (x.dtype, x.shape) != (y.dtype, y.shape) or \
                x.tobytes() != y.tobytes():
            return False
    return True


def _run_state(state) -> dict:
    """A pretraining state's backbone entries, head and optimizer
    buffers."""
    out = {k: v.detach() for k, v in state.backbone.state_dict().items()}
    out.update({f"head.{k}": v.detach() for k, v in state.head.items()})
    names = [n for n, _ in state.backbone.named_parameters()]
    names += [f"head.{k}" for k in state.head]
    params = state.optimizer.param_groups[0]["params"]
    for n, p_ in zip(names, params):
        for slot, t in state.optimizer.state.get(p_, {}).items():
            if isinstance(t, torch.Tensor) and t.dim() > 0:
                out[f"opt.{n}.{slot}"] = t.detach()
    return out


# the resumed CIFAR run against the uninterrupted one, cuDNN pinned to
# its deterministic algorithms: every weight, statistic and optimizer
# buffer within this absolute difference
RESUME_ATOL = 1e-5
CIFAR_CLASSES = 30          # make_cifar classes: 10 in each partition
CIFAR_PER_CLASS = 40        # 400 training images, 6 steps of 64 an epoch


def phase_resume(tmp, counters, steps: int = 10):
    """``python -m subspace_reg_tpu_torch.train_supervised`` on synthetic
    CIFAR-FS (the per-partition pickles, 32 px; ``make_cifar``) with
    resnet12 at full width, batch 64 and the golden flags: 2 epochs
    straight, and 1 epoch then ``--reload_path <model>_last.ckpt`` for the
    second, with cuDNN's deterministic algorithms: equal steps, every
    weight, statistic, counter and optimizer buffer within RESUME_ATOL,
    and the ``.ckpt`` the card wrote read back leaf for leaf.  Then the
    fused "pallas" step at 32 px against the module step (phase 7's
    envelope), and ``steps`` timed steps of each with the launch counters
    set to 0 just before and read just after (K2 6 and K3 2 launches per
    fused step)."""
    from subspace_reg_tpu_torch import train_supervised
    from subspace_reg_tpu_torch.data import synthetic
    from subspace_reg_tpu_torch.engine.pretrain import checkpoint_parts
    from subspace_reg_tpu_torch.utils.checkpoint import load_checkpoint
    root = f"{tmp}/resume"
    t0 = time.time()
    synthetic.make_cifar(f"{root}/data/CIFAR-FS", n_classes=CIFAR_CLASSES,
                         per_class=CIFAR_PER_CLASS)
    print(f"[resume] set-up (synthetic CIFAR-FS, 32 px) "
          f"{time.time() - t0:.1f} s")

    def argv(save, epochs, *extra):
        return ["--dataset", "CIFAR-FS", "--model", "resnet12",
                "--classifier", "linear", "--save_freq", "100",
                "--no_dropblock", "--no_linear_bias", "--set_seed", "1",
                "--batch_size", "64", "--epochs", str(epochs),
                "--print_freq", "100", "--data_root", f"{root}/data",
                "--model_path", f"{root}/{save}", "--tb_path",
                f"{root}/tb", "--device", "cuda", *extra]

    cudnn = torch.backends.cudnn
    pinned = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        straight, t_s, _ = _quiet(
            lambda: train_supervised.main(argv("straight", 2)))
        first, t_1, _ = _quiet(
            lambda: train_supervised.main(argv("first", 1)))
        resumed, t_r, log = _quiet(lambda: train_supervised.main(argv(
            "resumed", 2, "--reload_path",
            f"{root}/first/resnet12_last.ckpt")))
    finally:
        cudnn.deterministic, cudnn.benchmark = pinned
    check("==> resumed from" in log and "at epoch 2" in log,
          "the resumed run did not start at epoch 2")
    check(straight.step == resumed.step == 2 * first.step > 0,
          f"steps: straight {straight.step}, first {first.step}, resumed "
          f"{resumed.step}")
    a, b = _run_state(straight), _run_state(resumed)
    check(a.keys() == b.keys(), "the resumed state's entries differ")
    diff = max(float((a[k].double() - b[k].double()).abs().max())
               for k in a)
    same = all(torch.equal(a[k], b[k]) for k in a)
    print(f"[resume] 2 epochs straight {t_s:.2f} s ({straight.step} "
          f"steps); 1 epoch {t_1:.2f} s, resumed epoch 2 {t_r:.2f} s; "
          f"{len(a)} weights, statistics and optimizer buffers: max |diff| "
          f"{diff:.3e} (tolerance {RESUME_ATOL:g}, cuDNN deterministic), "
          f"bit-identical {same}")
    check(diff <= RESUME_ATOL, f"the resumed run drifts by {diff}")
    variables, head, meta = load_checkpoint(
        f"{root}/straight/resnet12_last.ckpt")
    want_vars, want_head, want_extra = checkpoint_parts(straight)
    check(trees_bit_equal(variables, want_vars)
          and trees_bit_equal(meta["extra"], want_extra)
          and np.array_equal(head.weight, as_numpy(want_head.weight))
          and head.n_active == want_head.n_active and meta["epoch"] == 2,
          "the .ckpt the card wrote does not read back leaf for leaf")
    n_leaves = len(dict(tree_items(variables))) + len(
        dict(tree_items(meta["extra"])))
    print(f"[resume] resnet12_last.ckpt read back leaf for leaf "
          f"({n_leaves} leaves, epoch {meta['epoch']}, step "
          f"{int(meta['extra']['step'])})")

    # the fused step at CIFAR's 32 px
    dev = torch.device("cuda")
    data, labels = pretrain_data(dev, per_class=20, img=32)
    bb = pretrain_backbone(n_blocks=(1, 1, 1, 1))
    r = np.random.RandomState(2)
    l_ref, l_fus, worst = step_agreement(
        dev, bb, data, labels,
        torch.from_numpy(r.randint(0, len(labels), BATCH)).to(dev),
        transform="D")
    print(f"[resume] fused-pallas step at 32 px: loss module {l_ref:.6f} "
          f"fused {l_fus:.6f}; worst update difference {worst:.3f} of its "
          "allowance")
    batches = [torch.from_numpy(r.randint(0, len(labels), BATCH)).to(dev)
               for _ in range(steps + 3)]
    out = {}
    for label, fused in (("module", False), ("fused pallas", True)):
        st = pretrain_state(bb, dev)
        step = pretrain_step(st, dev, fused, "pallas", transform="D")
        for i in range(3):
            step(st, data, labels, batches[i])
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.time()
        for i in range(steps):
            m = step(st, data, labels, batches[3 + i])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {c.__name__: c.launches for c in counters}
        want = ({"conv3x3_fused": 6 * steps, "block_tail": 2 * steps}
                if fused else {})
        for c in counters:
            check(launches[c.__name__] == want.get(c.__name__, 0),
                  f"32 px {label}: {c.__name__} launched "
                  f"{launches[c.__name__]} times in {steps} steps")
        check(math.isfinite(float(m["loss"])), f"32 px {label}: loss")
        out[label] = (1e3 * wall / steps, launches)
        print(f"[resume] 32 px {label}: {1e3 * wall / steps:.3f} ms/step, "
              f"{BATCH * steps / wall:.1f} images/s; launches {launches}")
    return dict(resume_max_diff=diff, resume_bit_identical=same,
                cifar_module_ms=out["module"][0],
                cifar_fused_ms=out["fused pallas"][0],
                cifar_launches=out["fused pallas"][1])


def _eval_cli(argv, counters):
    """The port's eval CLI in this process, quiet, the launch counters set
    to 0 just before and read just after: (result, seconds, launches)."""
    from subspace_reg_tpu_torch import eval_incremental
    for c in counters:
        c.launches = 0
    res, wall, _ = _quiet(lambda: eval_incremental.main(argv))
    return res, wall, {c.__name__: c.launches for c in counters}


def _dataset_inputs(opt):
    """Samplers and base-test split of the small tiered / CIFAR sets (the
    continual CIFAR split at 10/2 images a base class)."""
    from subspace_reg_tpu_torch.data.cifar import load_cifar_continual
    from subspace_reg_tpu_torch.data.episodes import EpisodeSampler
    from subspace_reg_tpu_torch.data.tiered_imagenet import (
        load_tiered_imagenet)
    if opt.dataset == "tieredImageNet":
        base_test = load_tiered_imagenet(opt, "train", "test")
        base_train = load_tiered_imagenet(opt, "train", "train")
        novel = load_tiered_imagenet(opt, "val", pretrain=False)
    else:
        kw = dict(train_per_class=10, val_per_class=2)
        base_test = load_cifar_continual(opt, "train", "test", **kw)
        base_train = load_cifar_continual(opt, "train", "train", **kw)
        novel = load_cifar_continual(opt, "val", **kw)
    return dict(meta_sampler=EpisodeSampler(novel, opt, split="val",
                                            disjoint_classes=True),
                base_test_split=base_test,
                base_support_sampler=EpisodeSampler(
                    base_train, opt, split="train", phase="train"))


# (dataset, model, transform, base classes of the small set)
DATASETS = (("tieredImageNet", "resnet18", "A", 80),
            ("CIFAR-FS", "resnet12", "D", 60))


def phase_datasets(tmp, counters):
    """The other datasets through ``python -m
    subspace_reg_tpu_torch.eval_incremental`` with the golden subspace-reg
    + memory flags, each from a seeded random ``.ckpt`` the port's
    ``save_checkpoint`` wrote: tieredImageNet (full-width resnet18, 84 px,
    351 base classes from ``make_tiered``, 175 ``val`` classes, 30 images
    a class, the golden 5 shots + 25 queries) and CIFAR-FS continual
    (resnet12, 32 px, ``make_cifar`` with the 400/50 split's images); the
    launch counters set to 0 just before each run and read just after (K1
    once per session, K2/K3 never).  Then phase 4's card-against-CPU check
    on each at small width (16 px tiered with 80 base classes, 32 px
    CIFAR): equal epoch counts in every session."""
    from subspace_reg_tpu_torch.data import synthetic
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.engine.incremental import (
        few_shot_finetune_incremental_test)
    out = {}
    t0 = time.time()
    synthetic.make_tiered(f"{tmp}/tiered/tieredImageNet",
                          n_classes=TIERED_BASE, per_class=30, img_size=84,
                          with_train_b=False)
    synthetic.make_cifar(f"{tmp}/cifar/CIFAR-FS", n_classes=100,
                         per_class=460)
    seeded_ckpt(f"{tmp}/tiered/resnet18_last.ckpt", "resnet18", TIERED_BASE)
    seeded_ckpt(f"{tmp}/cifar/resnet12_last.ckpt", "resnet12", 60)
    print(f"[datasets] set-up (84 px tiered, 32 px CIFAR, two seeded "
          f".ckpt) {time.time() - t0:.1f} s")
    for dataset, model, _, _ in DATASETS:
        key = "tiered" if dataset == "tieredImageNet" else "cifar"
        argv = list(GOLDEN_ARGV)
        argv[argv.index("--model") + 1] = model
        argv += ["--dataset", dataset, "--data_root", f"{tmp}/{key}",
                 "--model_path", f"{tmp}/{key}/{model}_last.ckpt",
                 "--device", "cuda"]
        res, _, launches = _eval_cli(argv, counters)
        n_base = TIERED_BASE if key == "tiered" else 60
        print(f"[datasets] {dataset} ({model}, {n_base} base classes): "
              f"epochs {res.epochs_per_session}; launches {launches}")
        check(launches["finetune_loop"] == N_SESSIONS,
              f"{dataset}: K1 launched {launches['finetune_loop']} times")
        check(launches["conv3x3_fused"] == launches["block_tail"] == 0,
              f"{dataset}: the evaluation launched a pretraining kernel")
        check(len(res.acc_novel_list) == N_SESSIONS and all(
            np.all(np.isfinite(getattr(res, n))) for n in
            ("acc_novel_list", "acc_base_list", "weighted_avg_l")),
            f"{dataset}: trace length or values")
        out[f"{key}_launches"] = launches["finetune_loop"]

    small = f"{tmp}/small_sets"
    synthetic.make_tiered(f"{small}/tieredImageNet", n_classes=80,
                          per_class=10, img_size=16, with_train_b=False)
    synthetic.make_cifar(f"{small}/CIFAR-FS", n_classes=100, per_class=20)
    for dataset, _, transform, n_base in DATASETS:
        # the engine runs neval_episodes sessions off miniImageNet (the
        # CLI's load_eval_splits sets 8)
        opt = golden_opt(small, *SMALL_ARGS, "--set_seed", "3",
                         "--dataset", dataset, "--transform", transform,
                         "--neval_episodes", str(N_SESSIONS))
        backbone, head = small_model(n_base=n_base)
        res = {d: few_shot_finetune_incremental_test(
            backbone, head, {}, opt, **_dataset_inputs(opt), verbose=False,
            device=d, draws=TorchDraws(opt.set_seed, "cpu"))
            for d in ("cuda", "cpu")}
        g, c = res["cuda"], res["cpu"]
        print(f"[datasets] {dataset} small: epochs card "
              f"{g.epochs_per_session} cpu {c.epochs_per_session}; novel "
              f"card {g.acc_novel_list} cpu {c.acc_novel_list}")
        check(g.epochs_per_session == c.epochs_per_session,
              f"{dataset}: engine epochs differ between card and CPU")
    return out


# --------------------------------------------------------------------------
# the engine's other modes and the predict API
# --------------------------------------------------------------------------
@contextlib.contextmanager
def in_dir(path: str):
    """Run the body in ``path`` (made if missing): the engines write their
    CSVs into the working directory, as the JAX engine does."""
    import os
    os.makedirs(path, exist_ok=True)
    old = os.getcwd()
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(old)


def read_rows(path: str):
    import csv
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _launches(counters):
    return {c.__name__: c.launches for c in counters}


def _reset(counters):
    for c in counters:
        c.launches = 0


# the general freeze, card against CPU, each session from one state on
# both devices: the backbone within FREEZE_SHARE of each tensor's largest
# update in the session, the running statistics within FREEZE_STATS
# (relative).  The card read at most 0.285% and 1.9e-5 in 8 sessions.
FREEZE_SHARE = 0.01
FREEZE_STATS = 1e-4


def _host_draws(set_seed: int):
    """``TorchDraws`` whose dropout uniforms are drawn on the CPU and moved
    to the forward's device, so that a card run and a CPU run drop the same
    units (a CUDA generator draws other numbers than a CPU one)."""
    from subspace_reg_tpu_torch.engine.draws import TorchDraws, dropout_seed

    def uniforms(seed):
        g = torch.Generator().manual_seed(seed)
        return lambda shape, device: torch.rand(shape, generator=g).to(
            device)

    class HostDraws(TorchDraws):
        def dropout(self, idx):
            return uniforms(dropout_seed(self.set_seed, idx))

        def dropout_full(self, idx):
            seed = dropout_seed(self.set_seed, idx)
            return uniforms(seed), uniforms(seed)

    return HostDraws(set_seed, "cpu")


def _freeze_run(opt, backbone, head, dev):
    """The general-freeze engine's sessions on ``dev``, driven as the
    entry point drives them: (result, the backbone's state after each
    session, on the host)."""
    from subspace_reg_tpu_torch.engine.incremental import SeedRun
    run = SeedRun(backbone, head, {}, opt, **engine_inputs(opt),
                  base_split_for_vocab=None, dev=torch.device(dev),
                  draws=_host_draws(opt.set_seed), prt=lambda *a, **k: None)
    states = []
    for idx in range(run.geo.max_sessions):
        run.run_session(idx)
        states.append({k: v.detach().cpu().clone() for k, v in
                       run.program.backbone.state_dict().items()})
    return run.result(), states


def _host_state(module):
    return {k: v.detach().cpu().clone() for k, v in
            module.state_dict().items()}


def _freeze_lockstep(opt, backbone, head):
    """The general freeze on the card and the CPU in lockstep: before each
    session the card run takes the CPU run's carried state (the trained
    backbone and the head), so that both devices start every session from
    one state and no difference compounds.  Per session: the card's
    backbone share and running-statistics difference (``_session_share``)
    and its novel and weighted-average gaps to the CPU's."""
    from subspace_reg_tpu_torch.engine.incremental import SeedRun
    card, cpu = (SeedRun(backbone, head, {}, opt, **engine_inputs(opt),
                         base_split_for_vocab=None, dev=torch.device(dev),
                         draws=_host_draws(opt.set_seed),
                         prt=lambda *a, **k: None)
                 for dev in ("cuda", "cpu"))
    params = dict(backbone.named_parameters())
    rows = []
    for idx in range(cpu.geo.max_sessions):
        before = _host_state(cpu.program.backbone)
        if idx:
            card.program.backbone.load_state_dict(before)
            card.head_w = cpu.head_w.to(card.dev, copy=True)
            if cpu.head_b is not None:
                card.head_b = cpu.head_b.to(card.dev, copy=True)
        card.run_session(idx)
        cpu.run_session(idx)
        share, stats = _session_share(_host_state(card.program.backbone),
                                      _host_state(cpu.program.backbone),
                                      before, params)
        rows.append(dict(
            share=share, stats=stats,
            novel=abs(card.acc_novel_list[-1] - cpu.acc_novel_list[-1]),
            weighted=abs(card.weighted_avg_l[-1] - cpu.weighted_avg_l[-1]),
            epochs=(card.epochs_l[-1], cpu.epochs_l[-1])))
    return rows


def _session_share(got, want, before, params):
    """The largest |got - want| over the backbone's parameters, as a share
    of each tensor's largest update |want - before| in the session, and
    the largest relative difference of the running statistics."""
    share = stats = 0.0
    for k, v in want.items():
        if k in params:
            step = max(float((v - before[k]).abs().max()), 1e-12)
            share = max(share, float((got[k] - v).abs().max()) / step)
        elif v.is_floating_point():
            stats = max(stats, float(((got[k] - v).abs()
                                      / (v.abs() + 1e-3)).max()))
        else:
            check(torch.equal(got[k], v), f"freeze: counter {k} differs")
    return share, stats


def modes_agree(tmp, small_root):
    """Phase 4's small width, card against CPU.  The tracked path
    (``--track_weights``): epoch counts exact, accuracies within 0.5, the
    tracking CSV's keys equal and its weights within 1e-4.  The general
    freeze (``--freeze_backbone_at 3``, memory on, dropout 0.1 drawn on
    the host for both devices), run free twice on the card with cuDNN's
    default algorithms, twice with ``cudnn.deterministic`` (the two
    bit-identical), and on the CPU with all its threads and with one:
    epoch counts exact; the accuracy gaps and each session's backbone
    share are printed (a difference compounds across sessions, on the CPU
    between thread counts as on the card).  Then in lockstep
    (``_freeze_lockstep``), every session from one state on both devices:
    epochs exact, accuracies within 0.5, the backbone within
    ``FREEZE_SHARE`` of the session's update and the running statistics
    within ``FREEZE_STATS``."""
    import os
    backbone, head = small_model()
    opt = golden_opt(small_root, *SMALL_ARGS, "--set_seed", "3",
                     "--track_weights")
    res, csvs = {}, {}
    for dev in ("cuda", "cpu"):
        with in_dir(f"{tmp}/modes_tracked_{dev}") as d:
            res[dev] = run_engine(small_root, opt, backbone, head, dev,
                                  draws=_host_draws(opt.set_seed),
                                  verbose=False)
            csvs[dev] = {f: read_rows(os.path.join(d, f))
                         for f in os.listdir(d)}
    g, c = res["cuda"], res["cpu"]
    print(f"[modes] agree tracked: epochs card {g.epochs_per_session} cpu "
          f"{c.epochs_per_session}; novel card {g.acc_novel_list} cpu "
          f"{c.acc_novel_list}")
    check(g.epochs_per_session == c.epochs_per_session,
          "tracked: epochs differ between card and CPU")
    for n in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
        a, b = np.asarray(getattr(g, n)), np.asarray(getattr(c, n))
        check(np.all(np.abs(a - b) <= 0.5),
              f"tracked: {n} differs between card and CPU: {a} vs {b}")
    check(len(csvs["cuda"]) == 1 and set(csvs["cuda"]) == set(csvs["cpu"]),
          f"tracked: CSVs {set(csvs['cuda'])} vs {set(csvs['cpu'])}")
    (f, (head_g, rows_g)), = csvs["cuda"].items()
    head_c, rows_c = csvs["cpu"][f]
    check(head_g == head_c and [r[:5] for r in rows_g]
          == [r[:5] for r in rows_c], "tracked: the CSV's keys differ")
    worst = max(float(np.abs(np.array(rg[5].split(), np.float64)
                             - np.array(rc[5].split(), np.float64)).max())
                for rg, rc in zip(rows_g, rows_c))
    print(f"[modes] agree tracked: {len(rows_g)} CSV rows, max |dW| card "
          f"vs CPU {worst:.3g}")
    check(worst <= 1e-4, f"tracked: weights differ by {worst}")

    backbone, head = small_model(drop_rate=0.1)
    opt = golden_opt(small_root, *SMALL_ARGS, "--set_seed", "3",
                     "--freeze_backbone_at", "3")
    cudnn = torch.backends.cudnn
    pinned = (cudnn.deterministic, cudnn.benchmark, torch.get_num_threads())
    runs = {}
    try:
        for name, det, dev, threads in (
                ("card", False, "cuda", None),
                ("card again", False, "cuda", None),
                ("card det", True, "cuda", None),
                ("card det again", True, "cuda", None),
                ("cpu", False, "cpu", None),
                ("cpu 1 thread", False, "cpu", 1)):
            cudnn.deterministic, cudnn.benchmark = det, False
            torch.set_num_threads(threads or pinned[2])
            runs[name] = _freeze_run(opt, backbone, head, dev)
    finally:
        cudnn.deterministic, cudnn.benchmark = pinned[:2]
        torch.set_num_threads(pinned[2])
    names = ("acc_novel_list", "acc_base_list", "weighted_avg_l")

    def gaps(a, b, n):
        x, y = getattr(runs[a][0], n), getattr(runs[b][0], n)
        return [round(abs(u - v), 2) for u, v in zip(x, y)]

    for name, (r, _) in runs.items():
        print(f"[modes] agree freeze, {name}: epochs "
              f"{r.epochs_per_session}; novel {r.acc_novel_list}; "
              f"weighted {r.weighted_avg_l}")
    for a, b in (("card", "card again"), ("card det", "card det again"),
                 ("card", "cpu"), ("card det", "cpu"),
                 ("cpu", "cpu 1 thread")):
        print(f"[modes] agree freeze, {a} vs {b}: gaps novel "
              f"{gaps(a, b, names[0])} weighted {gaps(a, b, names[2])}")
    cpu, cpu_states = runs["cpu"]
    start = _host_state(backbone)
    params = dict(backbone.named_parameters())
    for name in ("card", "card det", "cpu 1 thread"):
        shares = [_session_share(st, cpu_states[i], start if i == 0 else
                                 cpu_states[i - 1], params)[0]
                  for i, st in enumerate(runs[name][1])]
        print(f"[modes] agree freeze, {name} vs cpu: backbone within "
              f"{[round(100 * x, 3) for x in shares]}% of each session's "
              "update")
    (det, det_states), (again, again_states) = (runs["card det"],
                                                runs["card det again"])
    check(all(getattr(det, n) == getattr(again, n) for n in names)
          and all(torch.equal(x[k], y[k]) for x, y in
                  zip(det_states, again_states) for k in x),
          "freeze: two deterministic card runs differ")
    for name in ("card", "card det"):
        check(runs[name][0].epochs_per_session == cpu.epochs_per_session,
              f"freeze: {name}'s epochs differ from the CPU's")

    rows = _freeze_lockstep(opt, backbone, head)
    for idx, r in enumerate(rows):
        print(f"[modes] agree freeze, lockstep session {idx}: epochs "
              f"{r['epochs']}; backbone within {100 * r['share']:.3f}% of "
              f"the session's update; running statistics within "
              f"{r['stats']:.2e} (relative); gaps novel {r['novel']:.2f} "
              f"weighted {r['weighted']:.2f}")
    for idx, r in enumerate(rows):
        check(r["epochs"][0] == r["epochs"][1],
              f"freeze, lockstep session {idx}: epochs {r['epochs']}")
        check(r["share"] <= FREEZE_SHARE, f"freeze, lockstep session {idx}: "
              f"the backbone differs by {100 * r['share']:.3f}% of its "
              "update")
        check(r["stats"] <= FREEZE_STATS, f"freeze, lockstep session {idx}: "
              f"running statistics differ by {r['stats']:.2e}")
        check(r["novel"] <= 0.5 and r["weighted"] <= 0.5,
              f"freeze, lockstep session {idx}: accuracy gaps {r}")
    return dict(freeze_agree_gaps=gaps("card det", "cpu", names[0]),
                freeze_lockstep=rows)


def modes_save_preds(tmp, counters, run, golden):
    """Phase 5's golden run again with ``--save_preds_0``: the same epochs
    and accuracies (the mode adds bookkeeping only), K1 once a session,
    and the dump's 8 x (session-0 queries + base batch) rows."""
    import os
    root, _, backbone, head = run
    opt = golden_opt(root, "--save_preds_0")
    _reset(counters)
    with in_dir(f"{tmp}/modes_preds") as d:
        res, wall, _ = _quiet(lambda: run_engine(root, opt, backbone, head,
                                                 "cuda", verbose=False))
        launches = _launches(counters)
        files = os.listdir(f"{d}/csv_files_mem")
        header, rows = read_rows(f"{d}/csv_files_mem/{files[0]}")
    want_rows = N_SESSIONS * (opt.n_ways * opt.n_queries
                              + opt.test_base_batch_size // 2)
    print(f"[modes] save_preds: 8-session run {wall:.2f} s; launches "
          f"{launches}; {files[0]}: {len(rows)} rows")
    check(launches["finetune_loop"] == N_SESSIONS,
          f"save_preds: K1 launched {launches['finetune_loop']} times")
    check(res.epochs_per_session == golden.epochs_per_session
          and res.acc_novel_list == golden.acc_novel_list
          and res.acc_base_list == golden.acc_base_list,
          "save_preds: the run differs from phase 5's")
    check(len(files) == 1 and len(rows) == want_rows and header == [
        "Episode", "Gold", "Prediction", "Original_Gold",
        "Original_Prediction"], f"save_preds: {files}, {len(rows)} rows")
    return dict(save_preds_s=wall, save_preds_launches=launches[
        "finetune_loop"])


def modes_freeze(tmp, counters, run):
    """The golden flags with ``--freeze_backbone_at 3`` at full width, 8
    sessions, ``--max_novel_epochs`` cut to 100: every session's printed
    loss finite, the backbone trained by session 0, seconds per session
    and ms per backbone epoch (epoch 1 in train mode, epoch 2 in eval mode,
    each a forward and backward of the whole backbone)."""
    from subspace_reg_tpu_torch.engine.incremental import SeedRun
    root, _, backbone, head = run
    opt = golden_opt(root, "--freeze_backbone_at", "3",
                     "--max_novel_epochs", "100", "--verbose")
    lines = []
    seed_run = SeedRun(backbone, head, {}, opt, **engine_inputs(opt),
                       base_split_for_vocab=None, dev=torch.device("cuda"),
                       draws=None, prt=lambda *a, **k: lines.append(
                           " ".join(str(x) for x in a)))
    prog = seed_run.program
    epoch_s = []

    def clocked(fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t0)
            return out
        return call

    prog.prepare_full = clocked(prog.prepare_full)
    prog.full_epoch = clocked(prog.full_epoch)
    _reset(counters)
    secs = []
    for idx in range(seed_run.geo.max_sessions):
        t0 = time.time()
        seed_run.run_session(idx)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        if idx == 0:
            moved = sum(not torch.equal(p.detach().cpu(), q.detach())
                        for p, q in zip(prog.backbone.parameters(),
                                        backbone.parameters()))
            check(moved > 0, "freeze: session 0 left the backbone as loaded")
    res = seed_run.result()
    launches = _launches(counters)
    losses = [float(l.split("Train Loss")[1].split()[0]) for l in lines
              if l.startswith("Novel Epoch")]
    print(f"[modes] freeze_backbone_at 3: per-session seconds "
          f"{[round(x, 3) for x in secs]}; epochs {res.epochs_per_session}; "
          f"{len(epoch_s)} backbone epochs, {1e3 * np.mean(epoch_s):.2f} ms "
          f"each ({1e3 * np.mean(epoch_s[0::2]):.2f} train-mode epoch 1, "
          f"{1e3 * np.mean(epoch_s[1::2]):.2f} eval-mode epoch 2); "
          f"{moved} parameter tensors moved in session 0; launches "
          f"{launches}; novel {res.acc_novel_list}")
    check(len(losses) == sum(e // 10 for e in res.epochs_per_session)
          and all(np.isfinite(losses)), f"freeze: losses {losses}")
    check(len(epoch_s) == 2 * N_SESSIONS, "freeze: backbone epochs")
    check(all(np.all(np.isfinite(getattr(res, n))) for n in (
        "acc_novel_list", "acc_base_list", "weighted_avg_l")),
        "freeze: accuracies not finite")
    # the head epochs are per-epoch steps, as in the JAX package
    check(launches["finetune_loop"] == 0, f"freeze: launches {launches}")
    return dict(freeze_session_s=secs, freeze_epoch_ms=1e3 * np.mean(
        epoch_s))


def _three_session_head(head, sessions: int):
    from subspace_reg_tpu_torch.models.head import Head
    return Head(weight=head.weight[:60 + 5 * sessions], bias=None,
                n_active=60)


def modes_tracked(tmp, counters, run, k1):
    """The golden flags with ``--track_weights
    --track_label_inspired_weights``, cut to 3 sessions of at most 20
    epochs (at 1000 epochs the CSV would take hundreds of MB), against the
    untracked K1 run of the same flags: epochs exact, accuracies within
    0.5 (K1's near-ties, ROADMAP.md section C); ms per tracked epoch beside
    K1's us per epoch, and the CSVs' bytes."""
    import os
    from subspace_reg_tpu_torch.engine import incremental as inc
    root, _, backbone, head = run
    head3 = _three_session_head(head, 3)
    flags = ("--neval_episodes", "3", "--max_novel_epochs", "20")
    _reset(counters)
    ref, wall_u, _ = _quiet(lambda: run_engine(
        root, golden_opt(root, *flags), backbone, head3, "cuda",
        verbose=False))
    k1_launches = _launches(counters)["finetune_loop"]
    spent = []
    orig = inc.SeedRun._live_epochs

    def live(self, st, *a, **k):
        e0 = st.epoch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, st, *a, **k)
        spent.append((time.perf_counter() - t0, out.epoch - e0))
        return out

    opt = golden_opt(root, *flags, "--track_weights",
                     "--track_label_inspired_weights")
    _reset(counters)
    inc.SeedRun._live_epochs = live
    try:
        with in_dir(f"{tmp}/modes_tracked") as d:
            got, wall_t, _ = _quiet(lambda: run_engine(
                root, opt, backbone, head3, "cuda", verbose=False))
            sizes = {f: os.path.getsize(f"{d}/{f}") for f in os.listdir(d)}
    finally:
        inc.SeedRun._live_epochs = orig
    launches = _launches(counters)
    ms_epoch = 1e3 * sum(s for s, _ in spent) / sum(e for _, e in spent)
    print(f"[modes] tracked: epochs {got.epochs_per_session} (K1 run "
          f"{ref.epochs_per_session}); run {wall_t:.2f} s vs {wall_u:.2f} s "
          f"with K1; {ms_epoch:.3f} ms per tracked epoch (K1, phase 3: "
          f"{k1['us_per_epoch']:.2f} us/epoch); CSV bytes {sizes}; "
          f"launches {launches}")
    check(k1_launches == 3 and launches["finetune_loop"] == 0,
          f"tracked: K1 launches {k1_launches}, {launches}")
    check(got.epochs_per_session == ref.epochs_per_session,
          "tracked: epochs differ from the K1 run")
    for n in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
        a, b = np.asarray(getattr(got, n)), np.asarray(getattr(ref, n))
        check(np.all(np.abs(a - b) <= 0.5),
              f"tracked: {n} {a} vs the K1 run's {b}")
    check(len(sizes) == 2 and all(v > 0 for v in sizes.values()),
          f"tracked: CSVs {sizes}")
    return dict(tracked_ms_per_epoch=ms_epoch, tracked_csv_bytes=sizes,
                tracked_epochs=got.epochs_per_session)


def _png_ok(tag: str, size: int) -> bool:
    """A base64 PNG ``<img>`` tag: the signature, an IHDR of ``size`` x
    ``size`` 8-bit RGB with its CRC, and an IEND."""
    import base64
    import struct
    import zlib
    prefix = '<img src="data:image/jpeg;base64,'
    if not (tag.startswith(prefix) and tag.endswith('">')):
        return False
    raw = base64.b64decode(tag[len(prefix):-2])
    n, kind = struct.unpack(">I4s", raw[8:16])
    w, h, depth, color = struct.unpack(">IIBB", raw[16:26])
    crc = struct.unpack(">I", raw[16 + n:20 + n])[0]
    return (raw[:8] == b"\x89PNG\r\n\x1a\n" and kind == b"IHDR" and n == 13
            and (w, h, depth, color) == (size, size, 8, 2)
            and crc == zlib.crc32(raw[12:16 + n]) & 0xFFFFFFFF
            and raw[-8:-4] == b"IEND")


def modes_vis_predict(tmp, run, tracked):
    """``vis=True``: session 0's frames, one per query and epoch (the
    tracked run's session 0 has the same epochs), each ``img`` a PNG of the
    query's size.  Then ``make_predict_fn`` on phase 5's backbone and head
    over the base batch's uint8 images (1000 at 84 px): labels equal the
    engine's argmax on the same weights; ms per batch."""
    import copy
    from subspace_reg_tpu_torch.data.transforms import (
        transforms_test_options)
    from subspace_reg_tpu_torch.engine import incremental as inc
    from subspace_reg_tpu_torch.engine.predict import make_predict_fn
    from subspace_reg_tpu_torch.ops.augment import normalize_batch
    root, _, backbone, head = run
    opt = golden_opt(root, "--neval_episodes", "1", "--max_novel_epochs",
                     "20")
    t0 = time.time()
    frames = inc.few_shot_finetune_incremental_test(
        backbone, _three_session_head(head, 1), {}, opt,
        **engine_inputs(opt), verbose=False, device="cuda", vis=True)
    vis_s = time.time() - t0
    nq = opt.n_ways * opt.n_queries
    size = engine_inputs(opt)["base_test_split"].imgs.shape[1]
    n = len(frames["img"])
    print(f"[modes] vis: {n} frames ({n // nq} epochs x {nq} queries) in "
          f"{vis_s:.2f} s; columns {list(frames)}")
    check(n == nq * tracked["tracked_epochs"][0]
          and set(frames["idx"]) == {0}
          and all(len(v) == n for v in frames.values()),
          f"vis: {n} frames, session 0 ran {tracked['tracked_epochs'][0]} "
          "epochs")
    check(all(_png_ok(t, size) for t in set(frames["img"])),
          "vis: an img is not a PNG of the query's size")

    base = engine_inputs(golden_opt(root))["base_test_split"]
    imgs = np.ascontiguousarray(base.imgs[:opt.test_base_batch_size // 2])
    bb = copy.deepcopy(backbone).to("cuda")
    predict = make_predict_fn(backbone, head)
    labels, probs = predict(imgs)
    _, spec = transforms_test_options[opt.transform]
    x = normalize_batch(torch.from_numpy(imgs).cuda(), spec)
    with torch.no_grad():
        want = inc.head_logits({"w": head.weight.cuda()},
                               bb.eval()(inc._nchw(x)), head.n_active)
    want = want.argmax(1)
    dev_imgs = torch.from_numpy(imgs).cuda()
    ms_dev = cuda_ms(lambda: predict(dev_imgs), 5)
    ms_host = cuda_ms(lambda: predict(imgs), 5)
    print(f"[modes] predict: {len(imgs)} images at {size} px: {ms_dev:.2f} "
          f"ms from device memory, {ms_host:.2f} ms from host memory; labels "
          f"equal the engine's argmax: {bool(torch.equal(labels, want))}")
    check(torch.equal(labels, want), "predict: labels differ from the "
          "engine's argmax")
    check(torch.allclose(probs.sum(1), torch.ones(len(imgs), device="cuda")),
          "predict: probabilities do not sum to 1")
    return dict(predict_ms_per_1000=ms_dev, predict_host_ms_per_1000=ms_host,
                vis_s=vis_s)


def phase_modes(tmp, counters, small_root, run, golden, k1):
    """Phase 14: the engine's other modes (card against CPU at small
    width; the prediction dump, the general freeze and the tracked path at
    full width) and the vis frames and predict API, each part timed."""
    out = timed("14a modes agree", modes_agree, tmp, small_root)
    out.update(timed("14b save_preds", modes_save_preds, tmp, counters, run,
                     golden))
    out.update(timed("14c freeze", modes_freeze, tmp, counters, run))
    tracked = timed("14d tracked", modes_tracked, tmp, counters, run, k1)
    out.update(tracked)
    out.update(timed("14e vis+predict", modes_vis_predict, tmp, run,
                     tracked))
    return out


# --------------------------------------------------------------------------
# phase 15: the rest of pretraining (streamed loader, multi-seed, mesh)
# --------------------------------------------------------------------------
# 15a's host store: the continual miniImageNet pretraining split's size
# (60 classes x 500 images at 84 px, 635 MB of uint8)
REST_CLASSES, REST_PER_CLASS = 60, 500
REST_STEPS = 50
# 15c's continual split, cut from 500/50 images a base class for the
# phase's time (the loaders' per-class counts); 60 written a class
MS_TRAIN_PER_CLASS, MS_VAL_PER_CLASS, MS_WRITTEN = 30, 5, 40


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN pinned to its deterministic algorithms inside the block."""
    cudnn = torch.backends.cudnn
    pinned = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = pinned


@contextlib.contextmanager
def device_data_limit(limit):
    """``DEVICE_DATA_MAX_BYTES`` set to ``limit`` (None: unset, the CLI's
    default) inside the block."""
    import os
    old = os.environ.pop("DEVICE_DATA_MAX_BYTES", None)
    if limit is not None:
        os.environ["DEVICE_DATA_MAX_BYTES"] = limit
    try:
        yield
    finally:
        os.environ.pop("DEVICE_DATA_MAX_BYTES", None)
        if old is not None:
            os.environ["DEVICE_DATA_MAX_BYTES"] = old


def host_store(n_cls: int, per_class: int, img: int = 84, seed: int = 0):
    """(uint8 images, int64 labels) in host memory: seeded random bytes
    (every row distinct), ``per_class`` rows a class."""
    r = np.random.RandomState(seed)
    n = n_cls * per_class
    imgs = np.frombuffer(bytearray(r.bytes(n * img * img * 3)),
                         np.uint8).reshape(n, img, img, 3)
    return imgs, np.repeat(np.arange(n_cls, dtype=np.int64), per_class)


def _loader_threads() -> int:
    import threading
    return sum(1 for t in threading.enumerate()
               if t.name == "PrefetchLoader" and t.is_alive())


def rest_loader(dev):
    """15a: ``PrefetchLoader`` over a host store of the continual
    pretraining split's size: a full epoch checked byte for byte against
    ``imgs[order[i:i + 64]]``, an epoch consumed alone, then REST_STEPS
    timed streamed steps against as many device-data steps on the same
    batches from the same state, in turns (streamed, device, device,
    streamed), with cuDNN deterministic: bit-identical losses."""
    from subspace_reg_tpu_torch.data.pipeline import PrefetchLoader
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.utils.optim import step_decay_schedule
    t0 = time.time()
    imgs, labels = host_store(REST_CLASSES, REST_PER_CLASS)
    n = len(labels)
    print(f"[rest-loader] set-up: host store of {n} images at 84 px, "
          f"{imgs.nbytes / 1e6:.0f} MB, {time.time() - t0:.1f} s")
    loader = PrefetchLoader(imgs, labels, BATCH, np.random.RandomState(1),
                            device=dev)
    order = np.random.RandomState(1).permutation(n)
    t0 = time.time()
    k = -1
    for k, (x, y) in enumerate(loader.epoch()):
        idx = order[k * BATCH:(k + 1) * BATCH]
        check(torch.equal(x, torch.from_numpy(imgs[idx]).to(dev))
              and torch.equal(y, torch.from_numpy(labels[idx]).to(dev)),
              f"streamed batch {k} differs from imgs[order[...]]")
    torch.cuda.synchronize()
    check(k + 1 == n // BATCH, f"the epoch gave {k + 1} batches")
    checked_s = time.time() - t0
    t0 = time.time()
    n_b = sum(1 for _ in loader.epoch())
    torch.cuda.synchronize()
    alone_s = time.time() - t0
    print(f"[rest-loader] an epoch of {k + 1} batches checked byte for "
          f"byte {checked_s:.2f} s; consumed alone {alone_s:.3f} s "
          f"({n_b * BATCH / alone_s:.0f} images/s, "
          f"{n_b * BATCH * imgs[0].nbytes / alone_s / 1e9:.2f} GB/s)")

    spec, _ = transforms_options["A"]
    sched = step_decay_schedule(0.05, [60, 80], 0.1, n // BATCH)
    bb = pretrain_backbone()
    losses = {"streamed": [], "device": []}
    times = {"streamed": [], "device": []}
    waits = []
    with deterministic_cudnn():
        st_s = pretrain_state(bb, dev, REST_CLASSES)
        st_d = pretrain_state(bb, dev, REST_CLASSES)
        step_s = pt.make_train_step(st_s.backbone, sched, spec, False,
                                    TorchDraws(1, dev))
        step_d = pt.make_train_step_device_data(st_d.backbone, sched, spec,
                                                False, TorchDraws(1, dev))
        data_dev = torch.from_numpy(imgs).to(dev)
        labels_dev = torch.from_numpy(labels).to(dev)
        loader = PrefetchLoader(imgs, labels, BATCH,
                                np.random.RandomState(2), device=dev)
        streamed = loader.epoch()
        indexed = pt.epoch_batches(np.random.RandomState(2), n, BATCH)

        def run(label, k, timed_run=True):
            torch.cuda.synchronize()
            w0, b0 = loader.wait_s, loader.n_batches
            t0 = time.time()
            for _ in range(k):
                if label == "streamed":
                    x, y = next(streamed)
                    m = step_s(st_s, x, y)
                else:
                    idx = torch.from_numpy(next(indexed)).to(dev)
                    m = step_d(st_d, data_dev, labels_dev, idx)
                losses[label].append(m["loss"])
            torch.cuda.synchronize()
            if timed_run:
                times[label].append(1e3 * (time.time() - t0) / k)
                if label == "streamed":
                    waits.append(1e3 * (loader.wait_s - w0)
                                 / (loader.n_batches - b0))

        run("streamed", 3, False)        # warm-up, compared all the same
        run("device", 3, False)
        for label in ("streamed", "device", "device", "streamed"):
            run(label, REST_STEPS // 2)
        streamed.close()
    check(_loader_threads() == 0, "a loader thread outlived its epoch")
    ls = torch.stack(losses["streamed"]).cpu()
    ld = torch.stack(losses["device"]).cpu()
    check(ls.shape == ld.shape and torch.equal(ls, ld),
          f"streamed and device-data losses differ by up to "
          f"{float((ls - ld).abs().max())}")
    del data_dev, labels_dev
    torch.cuda.empty_cache()
    fmt = lambda v: "/".join(f"{t:.3f}" for t in v)  # noqa: E731
    out = dict(streamed_ms=sum(times["streamed"]) / 2,
               device_ms=sum(times["device"]) / 2,
               wait_ms=sum(waits) / len(waits))
    print(f"[rest-loader] {REST_STEPS} timed steps each (S D D S): "
          f"streamed {fmt(times['streamed'])} ms/step, device-data "
          f"{fmt(times['device'])} ms/step (means {out['streamed_ms']:.3f} "
          f"/ {out['device_ms']:.3f}, ratio "
          f"{out['streamed_ms'] / out['device_ms']:.4f}); consumer wait "
          f"{fmt(waits)} ms a batch; {len(ls)} losses bit-identical "
          f"(last {float(ls[-1]):.6f})")
    out.update(loader_breakdown(dev, imgs, labels))
    del imgs, labels
    out.update(loader_above_limit(dev))
    return out


def loader_breakdown(dev, imgs, labels):
    """Where a streamed batch's host time goes, each part timed alone over
    an epoch's batches: ``gather_u8`` into a pinned buffer (the loader's
    default threads, 1 and 8), numpy's gather, a pinned host-to-device copy
    of one batch (synchronized), and the loader's epoch consumed alone."""
    from subspace_reg_tpu_torch.data import native
    from subspace_reg_tpu_torch.data.pipeline import PrefetchLoader
    n = len(labels)
    order = np.random.RandomState(3).permutation(n)
    k = n // BATCH
    hx = torch.empty((BATCH,) + imgs.shape[1:], dtype=torch.uint8,
                     pin_memory=True)
    buf = hx.numpy()
    xd = torch.empty(hx.shape, dtype=torch.uint8, device=dev)

    def per_batch(fn):
        t0 = time.perf_counter()
        for b in range(k):
            fn(order[b * BATCH:(b + 1) * BATCH])
        return 1e3 * (time.perf_counter() - t0) / k

    def copy(_):
        xd.copy_(hx, non_blocking=True)
        torch.cuda.synchronize()

    threads = native._threads(0, buf.nbytes)
    parts = dict(
        gather_ms=per_batch(lambda i: native.gather_u8(imgs, i, out=buf)),
        gather1_ms=per_batch(lambda i: native.gather_u8(
            imgs, i, out=buf, n_threads=1)),
        gather8_ms=per_batch(lambda i: native.gather_u8(
            imgs, i, out=buf, n_threads=8)),
        numpy_ms=per_batch(lambda i: native.gather_u8(
            imgs, i, out=buf, backend="numpy")),
        copy_ms=per_batch(copy))
    loader = PrefetchLoader(imgs, labels, BATCH, np.random.RandomState(3),
                            device=dev)
    t0 = time.perf_counter()
    n_b = sum(1 for _ in loader.epoch())
    torch.cuda.synchronize()
    parts["alone_ms"] = 1e3 * (time.perf_counter() - t0) / n_b
    print(f"[rest-loader] a batch ({BATCH} x {imgs[0].nbytes} B), each part "
          f"alone over {k} batches: gather_u8 {parts['gather_ms']:.3f} ms "
          f"(the default, {threads} thread(s)) / {parts['gather1_ms']:.3f} "
          f"ms (1 thread) / {parts['gather8_ms']:.3f} ms (8 threads), "
          f"numpy {parts['numpy_ms']:.3f} ms, pinned copy to the card "
          f"{parts['copy_ms']:.3f} ms; the loader's epoch alone "
          f"{parts['alone_ms']:.3f} ms a batch")
    return {f"loader_{k}": v for k, v in parts.items()}


def loader_above_limit(dev):
    """An epoch of ``PrefetchLoader`` over a store above the device-data
    limit (``device_data_max_bytes()``, 2 GiB by default): 120,000 seeded
    images at 84 px (60 classes x 2000, 2.54 GB), byte for byte against
    ``imgs[order[i:i + 64]]``, then an epoch consumed alone."""
    from subspace_reg_tpu_torch.data.pipeline import PrefetchLoader
    from subspace_reg_tpu_torch.train_supervised import device_data_max_bytes
    t0 = time.time()
    imgs, labels = host_store(REST_CLASSES, 4 * REST_PER_CLASS, seed=1)
    limit = device_data_max_bytes()
    print(f"[rest-loader] set-up: host store of {len(labels)} images, "
          f"{imgs.nbytes / 1e9:.3f} GB (device-data limit "
          f"{limit / 1e9:.3f} GB), {time.time() - t0:.1f} s")
    check(imgs.nbytes > limit, "the store is not above the device-data "
          "limit")
    loader = PrefetchLoader(imgs, labels, BATCH, np.random.RandomState(5),
                            device=dev)
    order = np.random.RandomState(5).permutation(len(labels))
    t0 = time.time()
    k = -1
    for k, (x, y) in enumerate(loader.epoch()):
        idx = order[k * BATCH:(k + 1) * BATCH]
        check(torch.equal(x, torch.from_numpy(imgs[idx]).to(dev))
              and torch.equal(y, torch.from_numpy(labels[idx]).to(dev)),
              f"streamed batch {k} of the large store differs")
    torch.cuda.synchronize()
    check(k + 1 == len(labels) // BATCH, f"the epoch gave {k + 1} batches")
    checked_s = time.time() - t0
    t0 = time.perf_counter()
    n_b = sum(1 for _ in loader.epoch())
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    gbs = n_b * BATCH * imgs[0].nbytes / alone_s / 1e9
    print(f"[rest-loader] above the limit: an epoch of {k + 1} batches "
          f"checked byte for byte {checked_s:.2f} s; consumed alone "
          f"{alone_s:.3f} s ({1e3 * alone_s / n_b:.3f} ms a batch, "
          f"{gbs:.2f} GB/s)")
    return dict(loader_large_gb=imgs.nbytes / 1e9,
                loader_large_alone_ms=1e3 * alone_s / n_b)


def _pretrain_cli_argv(root: str, save: str):
    """Phase 10's CLI flags (golden model and optimizer, 84 px, one
    epoch) writing to ``<root>/<save>``."""
    return ["--trial", "pretrain", "--model_path", f"{root}/{save}",
            "--tb_path", f"{root}/tb", "--data_root", f"{root}/data",
            "--classifier", "linear", "--model", "resnet18",
            "--save_freq", "100", "--no_dropblock", "--no_linear_bias",
            "--set_seed", "1", "--epochs", "1", "--print_freq", "100",
            "--device", "cuda"]


def _phase10_data(tmp):
    import os
    from subspace_reg_tpu_torch.data import synthetic
    root = f"{tmp}/pretrain"
    if not os.path.exists(f"{root}/data/miniImageNet"):
        synthetic.make_mini_imagenet_category_split(
            f"{root}/data/miniImageNet", per_class=100, img_size=84, seed=0)
    return root


def _images_per_sec(log: str, epoch: int) -> float:
    import re
    m = re.search(rf"epoch {epoch}, total time [\d.]+, images/sec "
                  r"([\d.]+)", log)
    check(m is not None, f"no images/sec for epoch {epoch} in the log")
    return float(m.group(1))


def rest_cli(tmp):
    """15b: the pretraining CLI for one epoch on phase 10's data, streamed
    (``DEVICE_DATA_MAX_BYTES=0``) and staged (the default), cuDNN
    deterministic: the two ``.ckpt`` files within RESUME_ATOL."""
    from subspace_reg_tpu_torch import train_supervised
    root = _phase10_data(tmp)
    out = {}
    with deterministic_cudnn():
        for label, limit, line in (
                ("streamed", "0", "==> streaming dataset from the host"),
                ("device", None, "==> staging dataset on")):
            with device_data_limit(limit):
                state, wall, log = _quiet(lambda: train_supervised.main(
                    _pretrain_cli_argv(root, f"rest_{label}")))
            check(line in log, f"the {label} CLI run did not print {line!r}")
            check(state.step == 100, f"{label}: {state.step} steps")
            out[label] = (wall, _images_per_sec(log, 1))
    diff, same = ckpt_diff(f"{root}/rest_streamed/resnet18_last.ckpt",
                           f"{root}/rest_device/resnet18_last.ckpt")
    print(f"[rest-cli] one epoch streamed {out['streamed'][0]:.2f} s "
          f"({out['streamed'][1]:.1f} images/s), staged "
          f"{out['device'][0]:.2f} s ({out['device'][1]:.1f} images/s); "
          f".ckpt max |diff| {diff:.3e} (tolerance {RESUME_ATOL:g}), "
          f"bit-identical {same}")
    check(diff <= RESUME_ATOL, f"the streamed CLI run drifts by {diff}")
    return dict(cli_streamed_ips=out["streamed"][1],
                cli_device_ips=out["device"][1])


@contextlib.contextmanager
def cut_continual_split(train_per_class: int, val_per_class: int):
    """The pretraining CLI's continual loaders (which run_seeds shares) at
    ``train_per_class`` / ``val_per_class`` images a base class."""
    import functools
    from subspace_reg_tpu_torch import train_supervised
    from subspace_reg_tpu_torch.data import mini_imagenet
    kept = train_supervised.load_mini_imagenet
    train_supervised.load_mini_imagenet = functools.partial(
        mini_imagenet.load_mini_imagenet, train_per_class=train_per_class,
        val_per_class=val_per_class)
    try:
        yield
    finally:
        train_supervised.load_mini_imagenet = kept


def rest_multiseed(tmp, counters):
    """15c: ``run_seeds --pretrain --vmap`` for 3 seeds on synthetic
    continual miniImageNet (84 px, full-width resnet18, golden flags; the
    split cut to MS_TRAIN_PER_CLASS / MS_VAL_PER_CLASS images a base
    class), 2 epochs straight and 1 epoch + a ``--resume`` second, and
    the single-seed CLI for seed 1, cuDNN deterministic: resumed equals
    straight and lane 1 equals the CLI, within RESUME_ATOL; aggregate
    images/s against the single-seed run's, peak memory, and the launch
    counters (no kernel of K1-K3 on this path)."""
    import re
    from subspace_reg_tpu_torch import run_seeds, train_supervised
    root = f"{tmp}/rest_ms"
    t0 = time.time()
    write_continual_mini(f"{root}/miniImageNet", per_class=MS_WRITTEN)
    print(f"[rest-multiseed] set-up (100 classes x {MS_WRITTEN} images at "
          f"84 px; split cut to {MS_TRAIN_PER_CLASS}/{MS_VAL_PER_CLASS} a "
          f"base class: {60 * MS_TRAIN_PER_CLASS} training images, "
          f"{60 * MS_TRAIN_PER_CLASS // BATCH} steps an epoch) "
          f"{time.time() - t0:.1f} s")
    seeds = [str(s) for s in MULTI_SEEDS]
    flags = ["--model", "resnet18", "--no_dropblock", "--no_linear_bias",
             "--classifier", "linear", "--continual", "--data_root", root,
             "--tb_path", f"{root}/tb", "--batch_size", str(BATCH),
             "--save_freq", "100", "--print_freq", "100"]

    def fanout(save, epochs, *own):
        return _quiet(lambda: run_seeds.main(
            [*own, "--pretrain", "--vmap", "--seeds", *seeds, "--device",
             "cuda", "--", *flags, "--epochs", str(epochs), "--model_path",
             f"{root}/{save}"]))

    with deterministic_cudnn(), cut_continual_split(MS_TRAIN_PER_CLASS,
                                                    MS_VAL_PER_CLASS):
        _reset(counters)
        torch.cuda.reset_peak_memory_stats()
        res, wall, log = fanout("straight", 2)
        launches = _launches(counters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(not any(launches.values()),
              f"the multi-seed pretraining launched {launches}")
        agg = [float(v) for v in re.findall(
            r"epoch \d+ \[[\d.]+s, ([\d.]+) img/s aggregate\]", log)]
        check(len(agg) == 2, "no per-epoch aggregate images/s printed")
        check(sorted(res["val_acc1"]) == list(MULTI_SEEDS),
              f"the fan-out's JSON {res}")
        _, wall_1, _ = fanout("resumed", 1)
        _, wall_r, log_r = fanout("resumed", 2, "--resume")
        check(f"==> resuming {len(seeds)} seeds at epoch 2" in log_r,
              "the resumed fan-out did not start at epoch 2")
        _reset(counters)
        single, wall_s, log_s = _quiet(lambda: train_supervised.main(
            flags + ["--epochs", "2", "--set_seed", "1", "--device", "cuda",
                     "--model_path", f"{root}/single"]))
        single_launches = _launches(counters)
        check(not any(single_launches.values()),
              f"the single-seed CLI launched {single_launches}")
    torch.cuda.empty_cache()
    single_ips = _images_per_sec(log_s, 2)
    worst = 0.0
    for s in MULTI_SEEDS:
        d, _ = ckpt_diff(f"{root}/straight/seed_{s}/resnet18_last.ckpt",
                         f"{root}/resumed/seed_{s}/resnet18_last.ckpt")
        worst = max(worst, d)
    lane, lane_same = ckpt_diff(f"{root}/straight/seed_1/resnet18_last.ckpt",
                                f"{root}/single/resnet18_last.ckpt")
    print(f"[rest-multiseed] {len(seeds)} seeds x 2 epochs {wall:.2f} s: "
          f"aggregate {agg[0]:.1f} / {agg[1]:.1f} images/s (epochs 1/2) "
          f"against the single-seed CLI's {single_ips:.1f} (epoch 2; "
          f"{wall_s:.2f} s for 2 epochs), ratio {agg[1] / single_ips:.3f}; "
          f"peak {peak:.2f} GiB; launches {launches} (single-seed "
          f"{single_launches})")
    print(f"[rest-multiseed] 1 epoch {wall_1:.2f} s + resumed epoch 2 "
          f"{wall_r:.2f} s: resumed vs straight max |diff| {worst:.3e}; "
          f"lane 1 vs the single-seed CLI max |diff| {lane:.3e}, "
          f"bit-identical {lane_same} (tolerance {RESUME_ATOL:g})")
    check(worst <= RESUME_ATOL, f"the resumed fan-out drifts by {worst}")
    check(lane <= RESUME_ATOL, f"lane 1 drifts from the CLI by {lane}")
    return dict(ms_agg_ips=agg[1], ms_single_ips=single_ips,
                ms_peak_gib=peak, ms_launches=launches)


def rest_mesh(tmp):
    """15d: one CLI epoch (phase 10's flags and data) under ``torchrun
    --nproc_per_node 1`` (NCCL, a mesh of one rank) against the same run
    without torchrun, both with cuDNN deterministic: within RESUME_ATOL.
    Then a (2, 1) mesh of two gloo ranks on the one card, one f32 step at
    phase 7's shapes (full-width resnet18, 84 px, global batch 64, drop
    rate 0.1), against the single-process step on the global batch, at
    the CPU test's tolerances (tests/torch_support.py).  Then the CLI
    (phase 10's flags) in bf16 and f32 under ``torchrun --nproc_per_node
    2`` on the card, one step of 64 images at 84 px
    (``rest_mesh_bf16``)."""
    from subspace_reg_tpu_torch.models.resnet import WIDTHS
    root = _phase10_data(tmp)
    launcher = f"{tmp}/deterministic_train.py"
    with open(launcher, "w") as f:
        f.write("import runpy\nimport torch\n"
                "torch.backends.cudnn.deterministic = True\n"
                "torch.backends.cudnn.benchmark = False\n"
                "runpy.run_module('subspace_reg_tpu_torch.train_supervised',"
                " run_name='__main__', alter_sys=True)\n")
    env = repo_env()
    runs = {}
    for label, head in (
            ("plain", [sys.executable, launcher]),
            ("torchrun", [sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc_per_node", "1",
                          launcher])):
        t0 = time.time()
        p = subprocess.run(head + _pretrain_cli_argv(root, f"mesh_{label}"),
                           env=env, capture_output=True, text=True,
                           timeout=600)
        check(p.returncode == 0, f"the {label} CLI run exited "
              f"{p.returncode}:\n{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
        runs[label] = (time.time() - t0, _images_per_sec(p.stdout, 1),
                       p.stdout)
    check("==> mesh 1x1 over 1 ranks (nccl)" in runs["torchrun"][2],
          "the torchrun run built no NCCL mesh")
    diff, same = ckpt_diff(f"{root}/mesh_plain/resnet18_last.ckpt",
                           f"{root}/mesh_torchrun/resnet18_last.ckpt")
    ms = {k: 1e3 * BATCH / v[1] for k, v in runs.items()}
    print(f"[rest-mesh] one CLI epoch: without torchrun {ms['plain']:.3f} "
          f"ms/step ({runs['plain'][0]:.1f} s with the process), under "
          f"torchrun --nproc_per_node 1 (NCCL) {ms['torchrun']:.3f} ms/step "
          f"({runs['torchrun'][0]:.1f} s); .ckpt max |diff| {diff:.3e}, "
          f"bit-identical {same}")
    check(diff <= RESUME_ATOL, f"the torchrun run drifts by {diff}")

    cfg = dict(widths=list(WIDTHS), n_blocks=[1, 1, 2, 2], img=84,
               batch=BATCH, n_cls=PRETRAIN_CLASSES, n_store=256,
               device="cuda", timeout_s=300.0,
               scenarios=[dict(name="data", n_data=2, n_model=1, steps=1,
                               mode="device_data")])
    t0 = time.time()
    ranks = launch(cfg, 2, f"{tmp}/mesh2")
    wall = time.time() - t0
    ref = reference(cfg)
    reps = [agreement(ref["data"], r["data"]) for r in ranks]
    same = ranks_identical(ranks, "data")
    print(f"[rest-mesh] (2, 1) mesh, two gloo ranks with CUDA tensors on "
          f"the one card, one f32 step at 84 px, global batch {BATCH} "
          f"({wall:.1f} s with the processes): loss rel "
          f"{reps[0]['loss_rel']:.2e} (tolerance {LOSS_RTOL:g}),"
          f" running statistics at {reps[0]['stats_excess']:.3f} of their "
          f"tolerance, update cosine >= {reps[0]['cos_min']:.6f}, norms "
          f"within {reps[0]['norm_rel_max']:.2e}; ranks bit-identical "
          f"{same}")
    check(all(r["ok"] for r in reps) and same,
          f"the two-rank step departs from the single-process step: {reps}")
    out = dict(mesh_plain_ms=ms["plain"], mesh_torchrun_ms=ms["torchrun"],
               mesh_f32_cos=reps[0]["cos_min"])
    out.update(rest_mesh_bf16(tmp))
    return out


def conv_rows_by_batch(dev):
    """Whether each bf16 convolution of the backbone's forward (full-width
    resnet18, 84 px, cuDNN deterministic, eval mode so rows are
    independent) gives a rank's 32 rows as it gives rows 0-31 of the
    64-row batch, and the weight gradient of the 64 rows beside the sum of
    the two halves' (each rounded to bf16, as each rank's is before the
    ranks' sum); printed, not held: it explains the bf16 readings
    below."""
    import torch.nn.functional as F
    bb = pretrain_backbone().to(dev).eval()
    x = torch.randn(64, 3, 84, 84, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    conv, calls = F.conv2d, []

    def record(inp, w, *args, **kwargs):
        y = conv(inp, w, *args, **kwargs)
        calls.append((inp, w, args, kwargs, y))
        return y

    F.conv2d = record
    try:
        with torch.no_grad(), deterministic_cudnn():
            bb(x)
    finally:
        F.conv2d = conv
    rows, grads = [], []
    with deterministic_cudnn():
        for inp, w, args, kwargs, y in calls:
            d = (conv(inp[:32], w, *args, **kwargs) - y[:32]).float().abs()
            layout = ("channels-last" if inp.is_contiguous(
                memory_format=torch.channels_last) and inp.shape[1] > 1
                else "NCHW")
            name = (f"{inp.shape[1]}->{w.shape[0]} {w.shape[2]}x"
                    f"{w.shape[3]} at {inp.shape[2]} px {layout}")
            rows.append((name, float((d > 0).float().mean())))
            wg = w.detach().requires_grad_(True)

            def grad(part):
                out = conv(part, wg, *args, **kwargs).float().sum()
                return torch.autograd.grad(out, wg)[0].float()

            g = grad(inp)
            grads.append(float((g - grad(inp[:32]) - grad(inp[32:]))
                               .abs().max() / g.abs().max()))
    differ = [f"{n} ({100 * v:.2f}%)" for n, v in rows if v > 0]
    print(f"[rest-mesh] bf16: {len(calls)} convolutions of the backbone's "
          f"forward; rows of 32 differ from the same rows of 64 in "
          f"{len(differ)}: {', '.join(differ) or 'none'} (equal: "
          f"{', '.join(sorted({n for n, v in rows if v == 0}))}); weight "
          f"gradient of 64 rows vs the two halves' sum: max relative "
          f"{max(grads):.2e}")


def rest_mesh_bf16(tmp):
    """The CLI data-parallel on the card: ``torchrun --nproc_per_node 2``
    with both ranks on the one card (gloo, CUDA tensors;
    tests/torch_support.py::cli_rank), one step of the global batch (64
    images at 84 px, one a class; phase 10's flags), on random pixels and
    on class-coloured images, in bf16 as the CLI computes and in f32
    (``f32_compute``), each against the single-process CLI of its dtype.
    The f32 step is held to the CPU test's tolerances (running statistics
    within rtol 1e-4 / atol 1e-5, each update's cosine >= 0.999 and norm
    within 1%).  The bf16 step's readings against the single process are
    printed, and it is held to be as accurate as the single process
    against the f32 twin, within ``BF16_ACCURACY_MAX``
    (``bf16_readings``): on the card the ranks' bf16 steps round otherwise
    than the single process's (``conv_rows_by_batch``)."""
    import os
    from subspace_reg_tpu_torch import train_supervised
    conv_rows_by_batch(torch.device("cuda"))
    roots = {px: f"{tmp}/mesh_bf16_{px}" for px in ("random", "coloured")}
    for px, root in roots.items():
        write_one_step_split(f"{root}/data/miniImageNet", 84, px)

    def argv(root, save, epochs=1):
        a = _pretrain_cli_argv(root, save)
        a[a.index("--epochs") + 1] = str(epochs)
        return a

    runs = [(argv(root, f"mesh_{dt}"), dt) for root in roots.values()
            for dt in ("bf16", "f32")]
    t0 = time.time()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", RANK_SCRIPT,
         "--cli", json.dumps(runs)],
        env=repo_env(), capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    check(p.returncode == 0, f"the two-rank CLI exited "
          f"{p.returncode}:\n{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
    check(p.stdout.count("==> mesh 2x1 over 2 ranks (gloo)") == len(runs),
          "the two-rank CLI built no 2x1 gloo mesh")
    with deterministic_cudnn():
        for root in roots.values():
            _quiet(lambda: train_supervised.main(argv(root, "plain_bf16")))
            with f32_compute():
                _quiet(lambda: train_supervised.main(
                    argv(root, "plain_f32")))
            _quiet(lambda: train_supervised.main(argv(root, "init", 0)))
    out = {}
    for px, root in roots.items():
        a = argv(root, "")
        model = a[a.index("--model") + 1]
        ck = {k: f"{root}/{k}/{model}_last.ckpt" for k in (
            "mesh_bf16", "mesh_f32", "plain_bf16", "plain_f32", "init")}
        for dt in ("f32", "bf16"):
            r = cli_agreement(ck[f"plain_{dt}"], ck[f"mesh_{dt}"],
                                 ck["init"])
            check(r["step"] == 1, f"{px} {dt}: not one step")
            print(f"[rest-mesh] {dt} CLI, two gloo ranks on the card, {px} "
                  f"pixels, against the single process: running "
                  f"statistics at {r['stats_excess']:.3f} of their "
                  f"tolerance, update cosine >= {r['cos_min']:.6f}, norms "
                  f"within {r['norm_rel_max']:.2e}")
            out[f"mesh_{dt}_{px}_cos"] = r["cos_min"]
            out[f"mesh_{dt}_{px}_stats"] = r["stats_excess"]
            if dt == "f32":
                check(r["ok"], f"the two-rank f32 CLI step departs "
                      f"({px}): {r}")
        d = bf16_readings(ck["plain_bf16"], ck["mesh_bf16"],
                             ck["plain_f32"], ck["init"])
        print(f"[rest-mesh] bf16, {px} pixels, against the f32 twin: the "
              f"two-rank step's error over the single process's, updates "
              f"<= {d['accuracy_update']:.4f}, running statistics <= "
              f"{d['accuracy_stats']:.4f} (at most "
              f"{BF16_ACCURACY_MAX:g}); its distance from the single "
              f"process over that process's error, updates <= "
              f"{d['departure_update']:.4f}, statistics <= "
              f"{d['departure_stats']:.4f}; update cosine against the f32 "
              f"twin >= {d['cos_plain_f32']:.6f} (single process), "
              f"{d['cos_got_f32']:.6f} (two ranks)")
        check(d["ok"], f"the two-rank bf16 CLI step is less accurate than "
              f"the single process ({px}): {d}")
        out.update({f"mesh_bf16_{px}_{k}": v for k, v in d.items()
                    if k != "ok"})
    print(f"[rest-mesh] the two-rank CLI runs took {wall:.1f} s with the "
          f"processes")
    return out


def phase_pretrain_rest(tmp, counters, dev):
    """Phase 15: the streamed loader, the streamed CLI, multi-seed
    pretraining with resume and the mesh, each part timed, the launch
    counters set to 0 before each part and read after it: no launch of
    K1, K2 or K3 on these paths (15d's CLI runs are processes of their
    own, where the counters cannot be read)."""
    out, total = {}, {c.__name__: 0 for c in counters}
    for name, fn, args in (("15a rest loader", rest_loader, (dev,)),
                           ("15b rest cli", rest_cli, (tmp,)),
                           ("15c rest multiseed", rest_multiseed,
                            (tmp, counters)),
                           ("15d rest mesh", rest_mesh, (tmp,))):
        _reset(counters)
        out.update(timed(name, fn, *args))
        for k, v in _launches(counters).items():
            total[k] += v
    print(f"[rest] launches on phase 15's paths: {total}")
    check(not any(total.values()), f"phase 15 launched {total}")
    out["rest_launches"] = total
    return out


# --------------------------------------------------------------------------
# phase 16: distillation pretraining and the mapping trainer
# --------------------------------------------------------------------------
DISTILL_STEPS = 10
# the RFS contrastive geometry (the CLI's defaults, JAX config.py:199-202)
NCE_FEAT, NCE_K, NCE_T, NCE_M = 128, 16384, 0.07, 0.5
KD_LAUNCHES = {"conv3x3_fused": 6, "block_tail": 2}     # per fused step


def _timed_rounds(tag, runs, counters, want, steps: int = DISTILL_STEPS):
    """``steps`` timed calls of each ``runs[label](i)`` (i = 3.. after
    3 warm-up calls), in two rounds (in order, then reversed); host clock
    around work ending in a synchronise; every launch counter set to 0
    just before each timed run and read just after, checked against
    ``want[label]`` per step (0 where absent).  Returns ({label: [ms per
    step of each round]}, {label: the first round's launches})."""
    labels = list(runs)
    ms, first = {k: [] for k in labels}, {}
    for order in (labels, labels[::-1]):
        for label in order:
            for i in range(3):
                runs[label](i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset(counters)
            t0 = time.time()
            for i in range(steps):
                m = runs[label](3 + i)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = _launches(counters)
            check(math.isfinite(float(m["loss"])), f"{label}: loss not "
                  "finite")
            for k, n in launches.items():
                check(n == steps * want.get(label, {}).get(k, 0),
                      f"{label}: {k} launched {n} times in {steps} steps")
            first.setdefault(label, launches)
            ms[label].append(1e3 * wall / steps)
            print(f"[{tag}] {label}: {ms[label][-1]:.3f} ms/step, "
                  f"{BATCH * steps / wall:.1f} images/s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                  f"final loss {float(m['loss']):.4f}; launches "
                  f"{launches}")
    return ms, first


def distill_kd(dev, counters, widths=None, img: int = 84,
               steps: int = DISTILL_STEPS):
    """16a: KD at full width (resnet18-RFS 64/160/320/640, 84 px, batch
    64, bf16, golden flags; a seeded resnet18 teacher over the same 64
    classes, T 4, alpha = beta = 1).  The fused "pallas" KD step against
    the module KD step inside phase 7's envelope, the counters set to 0
    just before and read just after (K2 6, K3 2, K1 0: the one fused
    step); then ``steps`` timed device-data steps each of the plain
    module step, module KD and fused KD in two rounds.  The teacher's
    weights, statistics and counters must not move."""
    data, labels = pretrain_data(dev, img=img)
    teacher = pretrain_teacher(dev, widths)
    bufs = {k: v.clone() for k, v in teacher[0].state_dict().items()}
    idxs = torch.from_numpy(np.random.RandomState(2).randint(
        0, len(labels), BATCH)).to(dev)
    _reset(counters)
    l_ref, l_fus, worst = step_agreement(dev, pretrain_backbone(widths),
                                         data, labels, idxs,
                                         teacher=teacher)
    launches = _launches(counters)
    print(f"[distill-kd] loss module KD {l_ref:.6f} fused-pallas KD "
          f"{l_fus:.6f}; worst update difference {worst:.3f} of its "
          f"allowance; launches around the three steps {launches}")
    check(launches == dict(finetune_loop=0, **KD_LAUNCHES),
          f"the KD agreement's launches {launches}")
    bb = pretrain_backbone(widths)
    r = np.random.RandomState(3)
    batches = [torch.from_numpy(r.randint(0, len(labels), BATCH)).to(dev)
               for _ in range(steps + 3)]
    runs = {}
    for label, fused, t in (("module", False, None),
                            ("module KD", False, teacher),
                            ("fused KD", True, teacher)):
        st = pretrain_state(bb, dev)
        step = pretrain_step(st, dev, fused, "pallas", teacher=t)
        runs[label] = (lambda i, st=st, step=step:
                       step(st, data, labels, batches[i]))
    ms, first = _timed_rounds("distill-kd", runs, counters,
                              {"fused KD": KD_LAUNCHES}, steps)
    check(all(torch.equal(v, bufs[k]) for k, v in
              teacher[0].state_dict().items()),
          "the KD steps moved the teacher's statistics or counters")
    return dict(kd_launches=first["fused KD"],
                kd_agree_worst=worst,
                **{f"kd_{k.replace(' ', '_').lower()}_ms": v
                   for k, v in ms.items()})


def _unit(r, n, d, dev):
    v = torch.from_numpy(r.standard_normal((n, d)).astype(np.float32))
    return (v / v.norm(dim=1, keepdim=True)).to(dev)


def distill_nce(dev, counters, n_cls: int = REST_CLASSES,
                per_class: int = REST_PER_CLASS, widths=None,
                img: int = 84, nce_k: int = NCE_K,
                steps: int = DISTILL_STEPS):
    """16b: NCE and CRD at the RFS geometry over 15a's store (60 x 500
    images at 84 px, so N = 30,000 and each bank 15.4 MB; feat_dim 128,
    nce_k 16384, T 0.07, m 0.5, batch 64).  One ``nce_forward`` from one
    state on the card against the same call on the CPU (out_l/out_ab and
    Z within rtol 1e-5, updated rows within atol 1e-6, untouched rows
    bit-identical; every form against ``auto`` on the card), its time in
    each form; then ``steps`` timed steps of NCE in each form and of CRD
    (``auto``), in two rounds, no kernel launch."""
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.distill.nce import (
        CONTRAST_AUTO, NCEAverageState, init_nce_average, nce_forward)
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.utils.optim import step_decay_schedule
    imgs, labels = host_store(n_cls, per_class, img)
    n = len(labels)
    r = np.random.RandomState(4)
    state = init_nce_average(torch.Generator().manual_seed(0), n, NCE_FEAT,
                             nce_k, NCE_T, NCE_M, device="cpu")
    l, ab = _unit(r, BATCH, NCE_FEAT, "cpu"), _unit(r, BATCH, NCE_FEAT,
                                                    "cpu")
    y = torch.from_numpy(r.choice(n, BATCH, replace=False))
    idx = torch.from_numpy(r.randint(0, n, (BATCH, nce_k + 1)))
    idx[:, 0] = y
    t0 = time.time()
    ref = nce_forward(state, l, ab, y, idx=idx)
    cpu_s = time.time() - t0
    on_card = NCEAverageState(**{k: getattr(state, k).to(dev) for k in (
        "memory_l", "memory_ab", "z_l", "z_ab", "params")})
    args = (l.to(dev), ab.to(dev), y.to(dev))
    got = nce_forward(on_card, *args, idx=idx.to(dev))
    rows = torch.zeros(n, dtype=torch.bool)
    rows[y] = True
    err = {}
    # each side's similarities against f64 ones name the side at fault
    t = float(state.params[1])
    for i, (name, bank, v) in enumerate((("out_l", "memory_ab", l),
                                         ("out_ab", "memory_l", ab))):
        g, w = got[i].cpu(), ref[i]
        err[name] = float(((g - w).abs() / w.abs()).max())
        s64 = torch.einsum("bkd,bd->bk", getattr(state, bank).double()[idx],
                           v.double())
        z = (getattr(got[2], "z" + name[3:]).cpu(),
             getattr(ref[2], "z" + name[3:]))
        side = {k: float((torch.log(o.double() * zz.double()) * t
                          - s64).abs().max())
                for k, o, zz in (("card", g, z[0]), ("CPU", w, z[1]))}
        check(torch.allclose(g, w, rtol=1e-5, atol=0),
              f"nce_forward {name}: card and CPU differ by {err[name]:.3e}; "
              f"each side's similarities against f64: {side}")
    for z in ("z_l", "z_ab"):
        g, w = getattr(got[2], z).cpu(), getattr(ref[2], z)
        check(torch.allclose(g, w, rtol=1e-5, atol=0), f"{z}: {g} vs {w}")
    for bank in ("memory_l", "memory_ab"):
        g, w = getattr(got[2], bank).cpu(), getattr(ref[2], bank)
        err[bank] = float((g[rows] - w[rows]).abs().max())
        check(err[bank] <= 1e-6, f"{bank}: updated rows differ by "
              f"{err[bank]:.3e}")
        check(torch.equal(g[~rows], getattr(state, bank)[~rows]),
              f"{bank}: an untouched row moved")
    for mode in ("paired", "gather", "matmul"):
        other = nce_forward(on_card, *args, idx=idx.to(dev), mode=mode)
        for i in range(2):
            check(torch.allclose(other[i], got[i], rtol=1e-5, atol=0),
                  f"nce_forward {mode} differs from {CONTRAST_AUTO} (auto) "
                  "on the card")
    fwd_ms = {mode: cuda_ms(lambda m=mode: nce_forward(
        on_card, *args, idx=idx.to(dev), mode=m), 10)
        for mode in ("paired", "gather", "matmul")}
    print(f"[distill-nce] nce_forward (N {n}, K {nce_k}, D {NCE_FEAT}, B "
          f"{BATCH}): card against CPU, out_l {err['out_l']:.3e}, out_ab "
          f"{err['out_ab']:.3e} (rtol 1e-5); updated rows "
          f"{err['memory_l']:.3e} / {err['memory_ab']:.3e} (atol 1e-6); "
          f"untouched rows bit-identical; ms per call on the card "
          f"{ {k: round(v, 4) for k, v in fwd_ms.items()} }, on the CPU "
          f"{1e3 * cpu_s:.1f}")

    data = torch.from_numpy(imgs).to(dev)
    labels_dev = torch.from_numpy(labels).to(dev)
    table = tuple(torch.from_numpy(a).to(dev).long()
                  for a in pt.build_negative_table(labels, n_cls))
    teacher = pretrain_teacher(dev, widths, n_cls)
    bb = pretrain_backbone(widths)
    batches = [torch.from_numpy(r.choice(n, BATCH, replace=False)).to(dev)
               for _ in range(steps + 3)]
    spec, _ = transforms_options["A"]
    runs = {}
    for mode, form in (("nce", "paired"), ("nce", "gather"),
                       ("nce", "matmul"), ("crd", "auto")):
        st = pretrain_state(bb, dev, n_cls)
        st, es, et, banks = pt.init_nce_training(
            torch.Generator().manual_seed(1), st, golden_tx(),
            teacher[0].feature_dim, bb.feature_dim, NCE_FEAT, n, nce_k,
            NCE_T, NCE_M, device=dev)
        step = pt.make_train_step_nce(
            st.backbone, step_decay_schedule(0.05, [60, 80], 0.1, 100),
            spec, False, TorchDraws(1, dev), teacher, es, et, n, nce_k,
            mode=mode, contrast_mode=form)
        held = {"banks": banks}

        def run(i, st=st, step=step, held=held):
            held["banks"], m = step.device_data(st, held["banks"], data,
                                                labels_dev, table,
                                                batches[i])
            return m
        runs[f"{mode.upper()} {form}"] = run
    ms, _ = _timed_rounds("distill-nce", runs, counters, {}, steps)
    forms = {k.split()[1]: float(np.mean(v)) for k, v in ms.items()
             if k.startswith("NCE")}
    print(f"[distill-nce] NCE step by contrast form, mean of the two "
          f"rounds: { {k: round(v, 3) for k, v in forms.items()} } ms; "
          f"fastest {min(forms, key=forms.get)}; 'auto' is "
          f"{CONTRAST_AUTO}")
    return dict(nce_forward_ms=fwd_ms, nce_card_cpu_err=err,
                **{f"{k.lower().replace(' ', '_')}_ms": v
                   for k, v in ms.items()})


# 16c's resume pair runs on a category split cut from phase 10's 100 to
# 20 images a class (20 steps an epoch)
DISTILL_RESUME_PER_CLASS = 20


def distill_cli(tmp):
    """16c: ``python -m subspace_reg_tpu_torch.train_supervised
    --distill kd|crd|nce`` for one epoch each on phase 10's data with
    phase 10's ``.ckpt`` as the teacher (the CLI's contrastive defaults:
    feat_dim 128, nce_k 16384 over N = 6400); then ``--distill nce`` 2
    epochs straight against 1 epoch and a ``--reload_path`` second on the
    cut split (``DISTILL_RESUME_PER_CLASS``), cuDNN deterministic: every
    leaf of the two final ``.ckpt``s (weights, statistics, counters,
    optimizer state, embed heads, banks, Z) bit-identical; and the 1-epoch
    run streamed from the host (``DEVICE_DATA_MAX_BYTES=0``: the loader
    with each batch's items) against the staged one, within RESUME_ATOL
    as 15b holds the plain CLI."""
    from subspace_reg_tpu_torch import train_supervised
    from subspace_reg_tpu_torch.data import synthetic
    root = _phase10_data(tmp)
    teacher = f"{root}/save/resnet18_last.ckpt"
    cut = f"{tmp}/distill_cut"
    synthetic.make_mini_imagenet_category_split(
        f"{cut}/data/miniImageNet", per_class=DISTILL_RESUME_PER_CLASS,
        img_size=84, seed=0)

    def cli(data, save, distill, *extra):
        return _quiet(lambda: train_supervised.main(
            _pretrain_cli_argv(data, save) + [
                "--distill", distill, "--teacher_path", teacher, *extra]))
    out = {}
    for distill, line in (("kd", "==> KD teacher: resnet18 (64 classes)"),
                          ("crd", "==> CRD teacher: resnet18, feat_dim=128 "
                                  "K=16384"),
                          ("nce", "==> NCE teacher: resnet18")):
        state, wall, log = cli(root, f"distill_{distill}", distill)
        check(line in log, f"--distill {distill} did not print {line!r}")
        check(state.step == 100, f"--distill {distill}: {state.step} steps")
        out[f"cli_{distill}"] = (wall, _images_per_sec(log, 1))
    steps = 64 * DISTILL_RESUME_PER_CLASS // BATCH
    with deterministic_cudnn():
        cli(cut, "nce1", "nce")
        with device_data_limit("0"):
            _, host_wall, host_log = cli(cut, "nce1_host", "nce")
        cli(cut, "nce2", "nce", "--epochs", "2")
        state, _, log = cli(cut, "nce_r", "nce", "--epochs", "2",
                            "--reload_path", f"{cut}/nce1/resnet18_last.ckpt")
    check("==> streaming dataset from the host" in host_log,
          "the contrastive run with DEVICE_DATA_MAX_BYTES=0 did not stream")
    host_diff, host_same = ckpt_diff(f"{cut}/nce1/resnet18_last.ckpt",
                                     f"{cut}/nce1_host/resnet18_last.ckpt")
    check("==> resumed contrastive state" in log, "the resumed run did not "
          "restore its contrastive state")
    check(state.step == 2 * steps, f"the resumed run ended at step "
          f"{state.step}, not {2 * steps}")
    diff, same = ckpt_diff(f"{cut}/nce2/resnet18_last.ckpt",
                           f"{cut}/nce_r/resnet18_last.ckpt")
    leaves = ckpt_leaves(f"{cut}/nce_r/resnet18_last.ckpt")
    check("extra/nce/memory_l" in leaves and "extra/embed_s/linear/kernel"
          in leaves, "the contrastive .ckpt lacks its banks or heads")
    print(f"[distill-cli] one epoch (100 steps + validation): "
          + ", ".join(f"{k[4:]} {w:.2f} s ({ips:.1f} images/s)"
                      for k, (w, ips) in out.items())
          + f"; --distill nce on the cut split ({steps} steps an epoch) 2 "
          f"epochs straight vs 1 + resumed 1: max |diff| {diff:.3e} over "
          f"{len(leaves)} leaves, bit-identical {same}; 1 epoch streamed "
          f"from the host {host_wall:.2f} s "
          f"({_images_per_sec(host_log, 1):.1f} images/s) against staged: max |diff| {host_diff:.3e} "
          f"(tolerance {RESUME_ATOL:g}), bit-identical {host_same}")
    check(same, "the resumed contrastive run is not bit-identical")
    check(host_diff <= RESUME_ATOL, f"the streamed contrastive run drifts "
          f"by {host_diff}")
    return {f"{k}_images_per_s": ips for k, (_, ips) in out.items()}


def distill_mapping(tmp, counters, dev):
    """16d: ``python -m subspace_reg_tpu_torch.learn_mapping`` on the
    card from a continual ``.ckpt`` (phase 11's seed-1 weights, its 60
    base classes and their names) and a synthetic embedding pickle (60
    base rows, 300 -> 640, 1000 epochs), its map against
    ``train_linear_map`` on the CPU (rtol 1e-4, atol 1e-6, as the CPU
    test holds it against the JAX tool), its seconds; then one 8-session
    run of the mapping configuration through the eval CLI on the mapped
    ``.ckpt`` and phase 11's data (K1 8 launches, K2/K3 none)."""
    import os
    from subspace_reg_tpu_torch import learn_mapping
    from subspace_reg_tpu_torch.data import synthetic
    from subspace_reg_tpu_torch.data.mini_imagenet import load_mini_imagenet
    from subspace_reg_tpu_torch.models.embeds import get_embeds
    from subspace_reg_tpu_torch.utils.checkpoint import (load_any,
                                                         load_checkpoint,
                                                         save_checkpoint)
    from subspace_reg_tpu_torch.weights import to_jax_variables
    root = f"{tmp}/multi"
    synthetic.make_word_embeds(f"{root}/word_embeds")
    sd, head, _ = load_any(f"{root}/seed_1/resnet18_last.pth")
    base = load_mini_imagenet(golden_opt(root), split="train",
                              phase="train", lazy=True)
    n_base = int(head.n_active)
    os.makedirs(f"{tmp}/mapping", exist_ok=True)
    src, out = f"{tmp}/mapping/src.ckpt", f"{tmp}/mapping/mapped.ckpt"
    save_checkpoint(src, to_jax_variables(sd), head,
                    {"epoch": 100, "training_classes": base.basec_map,
                     "label2human": base.label2human})
    t0 = time.time()
    _, wall, log = _quiet(lambda: learn_mapping.main([
        "--model_path", src, "--save_path", out, "--word_embed_path",
        f"{root}/word_embeds", "--device", dev.type]))
    check("final MSE: " in log, "learn_mapping printed no MSE")
    mapping = load_checkpoint(out)[2]["mapping_linear_label2image"]
    vocab = [n for n in base.label2human if n != ""]
    check(len(vocab) == n_base, f"{len(vocab)} base names, {n_base} rows")
    e = np.asarray(get_embeds(f"{root}/word_embeds/miniImageNet_dim500"
                              ".pickle", vocab, 500), np.float32)[:, :300]
    w_t = np.asarray(head.weight[:n_base].cpu(), np.float32)
    t0 = time.time()
    w_cpu, b_cpu = learn_mapping.train_linear_map(e, w_t, device="cpu")
    cpu_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    learn_mapping.train_linear_map(e, w_t, device=dev)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    err = max(float(np.abs(mapping["weight"] - w_cpu).max()),
              float(np.abs(mapping["bias"] - b_cpu).max()))
    check(np.allclose(mapping["weight"], w_cpu, rtol=1e-4, atol=1e-6)
          and np.allclose(mapping["bias"], b_cpu, rtol=1e-4, atol=1e-6),
          f"the card's map departs from the CPU's by {err:.3e}")
    mse = float(np.mean((e @ mapping["weight"].T + mapping["bias"] - w_t)
                        ** 2))
    print(f"[distill-mapping] learn_mapping on the card {wall:.2f} s (the "
          f"1000 epochs alone {card_s:.3f} s; CPU {cpu_s:.3f} s); final "
          f"MSE {mse:.6e}; card against CPU max |diff| {err:.3e} (rtol "
          f"1e-4, atol 1e-6)")
    argv = config_argv("mapping", root) + ["--model_path", out, "--device",
                                           dev.type]
    res, wall_run, launches = _eval_cli(argv, counters)
    print(f"[distill-mapping] mapping configuration on the mapped .ckpt: "
          f"8-session run {wall_run:.2f} s; epochs "
          f"{res.epochs_per_session}; novel {res.acc_novel_list}; "
          f"launches {launches}")
    check(launches["finetune_loop"] == N_SESSIONS
          and launches["conv3x3_fused"] == launches["block_tail"] == 0,
          f"the mapping run's launches {launches}")
    check(len(res.acc_novel_list) == N_SESSIONS and all(
        np.all(np.isfinite(getattr(res, k))) for k in
        ("acc_novel_list", "acc_base_list", "weighted_avg_l")),
        "the mapping run's trace")
    return dict(learn_mapping_s=wall, learn_mapping_epochs_s=card_s,
                mapping_run_s=wall_run)


def phase_distill(tmp, counters, dev):
    """Phase 16: distillation pretraining (KD at full width on the module
    and fused paths, NCE/CRD at the RFS geometry, the CLI with resume)
    and the mapping trainer, each part timed."""
    out = timed("16a distill kd", distill_kd, dev, counters)
    out.update(timed("16b distill nce", distill_nce, dev, counters))
    out.update(timed("16c distill cli", distill_cli, tmp))
    out.update(timed("16d mapping", distill_mapping, tmp, counters, dev))
    return out


def state_readings(plain, got, f32, init):
    """``bf16_readings`` (tests/torch_support.py) on the harness's
    host states instead of ``.ckpt`` files: the momentum buffers left
    out, ``head.w`` as the head."""
    import types
    from unittest import mock
    import subspace_reg_tpu_torch.utils.checkpoint as ck
    states = dict(plain=plain, got=got, f32=f32, init=init)

    def load(name):
        sd = {k: v for k, v in states[name].items()
              if not k.startswith("momentum.")}
        return sd, types.SimpleNamespace(weight=sd.pop("head.w")), {}

    with mock.patch.object(ck, "load_any", load):
        return bf16_readings("plain", "got", "f32", "init")


def _mesh_cfg(scenarios, n_store: int = 256):
    from subspace_reg_tpu_torch.models.resnet import WIDTHS
    return dict(widths=list(WIDTHS), n_blocks=[1, 1, 2, 2], img=84,
                batch=BATCH, n_cls=PRETRAIN_CLASSES, n_store=n_store,
                device="cuda", timeout_s=300.0, scenarios=scenarios)


MESH_FUSED = [dict(name="bf16", kind="fused", backend="pallas",
                   dtype="bf16", n_data=2, n_model=1, steps=1,
                   mode="device_data"),
              dict(name="f32", kind="fused", backend="xla", dtype="f32",
                   n_data=2, n_model=1, steps=1, mode="device_data")]
_NCE_GEO = dict(feat_dim=NCE_FEAT, nce_k=NCE_K)
MESH_DISTILL = [dict(name="kd", kind="kd", n_data=2, n_model=1, steps=1,
                     mode="device_data"),
                dict(name="nce", kind="nce", n_data=2, n_model=1, steps=1,
                     mode="device_data", **_NCE_GEO),
                dict(name="crd", kind="crd", n_data=2, n_model=1, steps=1,
                     mode="streamed", **_NCE_GEO),
                dict(name="nce_two", kind="nce", n_data=2, n_model=1,
                     steps=2, mode="device_data", **_NCE_GEO)]


def mesh_steps(tmp):
    """17a and 17b's steps: one launch of two gloo ranks on the one card
    (tests/torch_support.py's mesh harness; full-width resnet18, 84 px,
    global batch 64) for every scenario of ``MESH_FUSED`` and
    ``MESH_DISTILL``, and the single-process reference of each;
    ``mesh_fused`` and ``mesh_distill`` check them."""
    cfg = _mesh_cfg(MESH_FUSED + MESH_DISTILL)
    t0 = time.time()
    ranks = launch(cfg, 2, f"{tmp}/mesh_steps")
    wall = time.time() - t0
    ref = reference(cfg)
    print(f"[mesh] two gloo ranks on the one card, {len(cfg['scenarios'])} "
          f"scenarios: {wall:.1f} s with the processes")
    out = mesh_fused(ranks, ref)
    out.update(mesh_distill(ranks, ref))
    return out


def mesh_fused(ranks, ref):
    """17a: the fused step on a (2, 1) mesh of two ranks, one device-data
    step each of the bf16 fused "pallas" step (K2/K3, their epilogue sums
    all-reduced between the launches) and of the f32 fused "xla" step,
    against the single-process step of each on the global batch.  The
    f32 step at the CPU test's tolerances; the bf16 step as accurate as
    the single process against the f32 twin (``BF16_ACCURACY_MAX``, as
    15d holds the CLI); both ranks bit-identical.  Each rank's K2/K3
    launches, as the rank counted them, printed as a JSON line: 6 K2 and
    2 K3 a step for "pallas", none for "xla"."""
    launches = []
    for r, res in enumerate(ranks):
        for s in MESH_FUSED:
            line = {"rank": r, "scenario": s["name"],
                    "launches": res[s["name"]]["launches"]}
            print(json.dumps(line))
            launches.append(line)
    for line in launches:
        want = (KD_LAUNCHES if line["scenario"] == "bf16"
                else {k: 0 for k in KD_LAUNCHES})
        check(line["launches"] == want, f"17a: rank {line['rank']} "
              f"{line['scenario']} launched {line['launches']}, want {want}")
    rep = [agreement(ref["f32"], r["f32"]) for r in ranks]
    blocks = max(stats_excess(a, b) for a, b in zip(
        ref["f32"]["block_stats"], ranks[0]["f32"]["block_stats"]))
    print(f"[mesh-fused] f32 fused \"xla\" step on two gloo ranks on the "
          f"card against the single process: loss rel "
          f"{rep[0]['loss_rel']:.2e}, running statistics at "
          f"{rep[0]['stats_excess']:.3f} of their tolerance, update cosine "
          f">= {rep[0]['cos_min']:.6f}, norms within "
          f"{rep[0]['norm_rel_max']:.2e}; block statistics at "
          f"{blocks:.3f} of their tolerance")
    check(all(x["ok"] for x in rep) and blocks <= 1.0, f"17a: the f32 "
          f"two-rank fused step departs from the single process: {rep}")
    d = state_readings(ref["bf16"]["final"], ranks[0]["bf16"]["final"],
                       ref["f32"]["final"], ref["bf16"]["init"])
    print(f"[mesh-fused] bf16 fused \"pallas\" step on two ranks against the "
          f"f32 twin: error over the single process's, updates <= "
          f"{d['accuracy_update']:.4f}, running statistics <= "
          f"{d['accuracy_stats']:.4f} (at most {BF16_ACCURACY_MAX:g}); "
          f"update cosine against the f32 twin >= {d['cos_plain_f32']:.6f} "
          f"(single process), {d['cos_got_f32']:.6f} (two ranks)")
    check(d["ok"], f"17a: the two-rank bf16 fused step is less accurate "
          f"than the single process: {d}")
    for s in MESH_FUSED:
        check(ranks_identical(ranks, s["name"]), f"17a: the ranks' "
              f"{s['name']} states differ")
    sec = {s["name"]: ranks[0][s["name"]]["seconds"] for s in MESH_FUSED}
    print(f"[mesh-fused] a first step on two ranks of one card (warm-up "
          f"included; not a multi-card figure): {1e3 * sec['bf16']:.1f} ms "
          f"bf16 \"pallas\", {1e3 * sec['f32']:.1f} ms f32 \"xla\"")
    return dict(mesh_fused_launches=launches[0]["launches"],
                mesh_fused_f32_cos=rep[0]["cos_min"],
                mesh_fused_bf16_accuracy=d["accuracy_update"])


def mesh_distill(ranks, ref):
    """17b's steps: KD, NCE and CRD on a (2, 1) mesh of two ranks (f32, a
    seeded teacher of the student's geometry, the RFS feat_dim 128 and
    nce_k 16384 over a 256-item store), one step each against the single
    process at the CPU test's tolerances (the banks and Z at the
    statistics'), and two NCE steps: every rank's state and banks
    bit-identical."""
    for name in ("kd", "nce", "crd"):
        rep = [agreement(ref[name], r[name]) for r in ranks]
        print(f"[mesh-distill] {name} on two gloo ranks on the card against "
              f"the single process: loss rel {rep[0]['loss_rel']:.2e}, "
              f"running statistics at {rep[0]['stats_excess']:.3f} of their "
              f"tolerance, update cosine >= {rep[0]['cos_min']:.6f}, norms "
              f"within {rep[0]['norm_rel_max']:.2e}")
        check(all(x["ok"] for x in rep), f"17b: {name} departs: {rep}")
    banks = ("nce.memory_l", "nce.memory_ab", "nce.z_l", "nce.z_ab")
    excess = {n: stats_excess([ref[n]["final"][k] for k in banks],
                                     [ranks[0][n]["final"][k]
                                      for k in banks])
              for n in ("nce", "nce_two")}
    same = [ranks_identical(ranks, s["name"]) for s in MESH_DISTILL]
    print(f"[mesh-distill] banks and Z against the single process, at the "
          f"statistics' tolerance: one NCE step {excess['nce']:.3f}, two "
          f"steps {excess['nce_two']:.3f} (not held: the second step's "
          f"embeddings come from the first step's updates, which agree "
          f"only to the update cosine above); ranks bit-identical (kd, "
          f"nce, crd, two nce steps) {same}")
    check(excess["nce"] <= 1.0 and all(same),
          "17b: the banks or states differ")
    return dict(mesh_nce_banks_excess=excess["nce"])


def mesh_nce_cli(tmp):
    """17b's CLI: ``--distill nce`` for one epoch under ``torchrun
    --nproc_per_node 2`` (gloo, both ranks on the card;
    tests/torch_support.py's ``cli_rank``) on phase 10's data with
    phase 10's ``.ckpt`` as the teacher: one mesh, rank 0 alone prints
    and saves, 100 steps, the contrastive state in the ``.ckpt``."""
    import os
    root = _phase10_data(tmp)
    teacher = f"{tmp}/pretrain/save/resnet18_last.ckpt"
    check(os.path.exists(teacher), "17b needs phase 10's .ckpt")
    argv = _pretrain_cli_argv(root, "mesh_nce") + [
        "--distill", "nce", "--teacher_path", teacher]
    t0 = time.time()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", RANK_SCRIPT,
         "--cli", json.dumps([(argv, "bf16")])],
        env=repo_env(), capture_output=True, text=True, timeout=600)
    cli_wall = time.time() - t0
    check(p.returncode == 0, f"17b: the two-rank NCE CLI exited "
          f"{p.returncode}:\n{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
    for line in ("==> mesh 2x1 over 2 ranks (gloo)", "==> NCE teacher",
                 "==> Saved resnet18_last.ckpt"):
        check(p.stdout.count(line) == 1, f"17b: the CLI printed {line!r} "
              f"{p.stdout.count(line)} times")
    from subspace_reg_tpu_torch.utils.checkpoint import load_checkpoint
    _, _, meta = load_checkpoint(f"{root}/mesh_nce/resnet18_last.ckpt")
    extra = meta["extra"]
    check(int(extra["step"]) == 100 and {"embed_s", "embed_t", "nce"}
          <= set(extra), "17b: the CLI's .ckpt lacks its contrastive state")
    check(all(np.all(np.isfinite(np.asarray(v))) for _, v in
              tree_items(extra["nce"])), "17b: the banks are not finite")
    ips = _images_per_sec(p.stdout, 1)
    print(f"[mesh-distill] --distill nce, one epoch (100 steps of 64) under "
          f"torchrun --nproc_per_node 2 on the one card: {cli_wall:.1f} s "
          f"with the processes, {ips:.1f} images/s "
          f"({1e3 * BATCH / ips:.1f} ms a global step)")
    return dict(mesh_nce_cli_s=cli_wall, mesh_nce_cli_ips=ips)


def mesh_parity(tmp, counters):
    """17c: ``python -m subspace_reg_tpu_torch.run_parity_gate_fixture`` on
    the card, one seed, the four golden configurations, record then
    compare: phase 11's data (560 images a class, 84 px) and its seed-1
    weights as 16d saved them with their class names (exported to the
    fixture's ``.pth``, so the fixture trains none), the mapping
    configuration's mapping trained by the gate.  The gate must pass; K1
    launches 8 times a run (8 runs), K2/K3 never."""
    import os
    from subspace_reg_tpu_torch import (export_pth, parity_gate,
                                        run_parity_gate_fixture)
    work = f"{tmp}/parity"
    os.makedirs(f"{work}/data", exist_ok=True)
    if not os.path.exists(f"{work}/data/miniImageNet"):
        os.symlink(f"{tmp}/multi/miniImageNet", f"{work}/data/miniImageNet")
    pth = f"{work}/backbones/continual/resnet18/1/resnet18_last.pth"
    os.makedirs(os.path.dirname(pth), exist_ok=True)
    _quiet(lambda: export_pth.main(["--ckpt", f"{tmp}/mapping/src.ckpt",
                                    "--out", pth]))
    runs = []
    run_config = parity_gate.run_config

    def counted(config, seed, *args):
        _reset(counters)
        t0 = time.time()
        out = run_config(config, seed, *args)
        torch.cuda.synchronize()
        runs.append((config, time.time() - t0, _launches(counters)))
        return out

    from unittest import mock
    with mock.patch.object(parity_gate, "run_config", counted):
        rc, wall, log = _quiet(lambda: run_parity_gate_fixture.main([
            "--work_dir", work, "--seeds", "1", "--device", "cuda",
            "--out", f"{work}/report.json"]))
    check(rc == 0 and "PARITY GATE PASSED" in log,
          f"17c: the parity gate failed (rc {rc}):\n{log[-3000:]}")
    with open(f"{work}/report.json") as f:
        report = json.load(f)
    check(report["all_within"] and len(report["runs"]) == 4,
          "17c: the report")
    for config, sec, launches in runs:
        print(f"[parity] {config}: {sec:.2f} s, launches {launches}")
        check(launches["finetune_loop"] == N_SESSIONS
              and launches["conv3x3_fused"] == launches["block_tail"] == 0,
              f"17c: {config} launched {launches}")
    check(len(runs) == 8, f"17c: {len(runs)} runs, not 8")
    worst = max(r["max_abs_dev"] for run in report["runs"]
                for r in run["comparison"])
    per_run = [sec for _, sec, _ in runs]
    print(f"[parity] the fixture on the card: {wall:.1f} s, 8 runs of 8 "
          f"sessions (4 configurations, record and compare), "
          f"{np.mean(per_run):.2f} s a run ({min(per_run):.2f}-"
          f"{max(per_run):.2f}); worst deviation {worst:.4f} (tolerance "
          f"{report['tolerance']}); PASSED")
    return dict(parity_s=wall, parity_s_per_run=float(np.mean(per_run)),
                parity_launches=sum(r[2]["finetune_loop"] for r in runs))


def mesh_seed_layout(tmp, counters, small_root):
    """17d: ``few_shot_finetune_multiseed(..., shard_over_devices=True)``
    against ``False`` on the card (one visible device: the seed layout's
    largest divisor is 1), 3 seeds at phase 4's small width: bit-identical
    results, K1 8 launches (of 3 seeds) each."""
    from subspace_reg_tpu_torch.engine.multiseed import (
        few_shot_finetune_multiseed)
    from subspace_reg_tpu_torch.ops.finetune import finetune_loop
    seeds = (3, 4, 5)
    out = {}
    for shard in (False, True):
        opts = [golden_opt(small_root, *SMALL_ARGS, "--set_seed", str(s))
                for s in seeds]
        models = [small_model(10 + i) for i in range(len(seeds))]
        ins = [engine_inputs(o) for o in opts]
        _reset(counters)
        finetune_loop.seed_loops = 0
        t0 = time.time()
        ms = few_shot_finetune_multiseed(
            [m[0] for m in models], [m[1] for m in models],
            [{}] * len(seeds), opts, [x["meta_sampler"] for x in ins],
            [x["base_test_split"] for x in ins],
            [x["base_support_sampler"] for x in ins], device="cuda",
            shard_over_devices=shard)
        torch.cuda.synchronize()
        out[shard] = (ms, time.time() - t0, _launches(counters),
                      finetune_loop.seed_loops)
    fields = ("acc_novel_avg", "acc_base_avg", "weighted_avg_l",
              "acc_novel_list", "acc_base_list", "novel_session_traces",
              "epochs_per_session")
    same = all(getattr(a, f) == getattr(b, f) for a, b in zip(
        out[False][0].per_seed, out[True][0].per_seed) for f in fields)
    for shard, (_, sec, launches, loops) in out.items():
        print(f"[seed-layout] shard_over_devices={shard}: {sec:.2f} s, "
              f"launches {launches}, seed loops {loops}")
        check(launches["finetune_loop"] == N_SESSIONS
              and loops == len(seeds) * N_SESSIONS,
              f"17d: shard={shard} launched {launches}, {loops} loops")
    print(f"[seed-layout] {torch.cuda.device_count()} visible device(s): "
          f"sharded and unsharded results bit-identical {same}")
    check(same, "17d: shard_over_devices=True departs from False")
    return dict(seed_layout_identical=same)


def phase_mesh(tmp, counters, small_root):
    """Phase 17: the fused step and distillation on two ranks, the parity
    fixture, the seed layout; each part timed, the launch counters of
    this process set to 0 before each part and read after it (17a's and
    17b's steps run in rank processes, which count their own)."""
    out = {}
    for name, fn, args in (("17a-b mesh steps", mesh_steps, (tmp,)),
                           ("17b mesh cli", mesh_nce_cli, (tmp,)),
                           ("17c parity", mesh_parity, (tmp, counters)),
                           ("17d seed layout", mesh_seed_layout,
                            (tmp, counters, small_root))):
        _reset(counters)
        out.update(timed(name, fn, *args))
    return out


# the reference's pretraining scalars (train_supervised.py:172-178)
EVENT_SCALARS = ("train_acc", "train_loss", "test_acc", "test_acc_top5",
                 "test_loss")


def _dir_bytes(path: str) -> int:
    import os
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _proto_fields(buf: bytes) -> dict:
    """{field number: [values]} of a protobuf message: varints as ints,
    fixed64 as doubles, fixed32 as floats, length-delimited as bytes."""
    import struct
    out, i = {}, 0

    def varint():
        nonlocal i
        v = shift = 0
        while True:
            b = buf[i]
            i += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
    while i < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            v = varint()
        elif wire == 1:
            (v,) = struct.unpack_from("<d", buf, i)
            i += 8
        elif wire == 5:
            (v,) = struct.unpack_from("<f", buf, i)
            i += 4
        elif wire == 2:
            n = varint()
            v = buf[i:i + n]
            i += n
        else:
            raise ValueError(f"wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def read_event_file(path: str):
    """(file_version, [(tag, step, value)]) of a TensorBoard event file, each
    TFRecord's masked CRC-32C checked."""
    import struct
    from subspace_reg_tpu_torch.utils.crc32c import masked
    with open(path, "rb") as f:
        buf = f.read()
    records, i = [], 0
    while i < len(buf):
        head = buf[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        data = buf[i + 12:i + 12 + n]
        check(struct.unpack("<I", buf[i + 8:i + 12])[0] == masked(head)
              and struct.unpack("<I", buf[i + 12 + n:i + 16 + n])[0]
              == masked(data), f"{path}: bad masked CRC at byte {i}")
        records.append(_proto_fields(data))
        i += 16 + n
    version = records[0][3][0].decode()
    scalars = []
    for ev in records[1:]:
        for value in _proto_fields(ev[5][0])[1]:
            v = _proto_fields(value)
            step = ev.get(2, [0])[0]
            scalars.append((v[1][0].decode(), step - (1 << 64)
                            if step >> 63 else step, v[2][0]))
    return version, scalars


def orbax_round_trip(tmp, backbone, head):
    """The state on the card through ``save_orbax``/``load_orbax`` and
    ``save_checkpoint``/``load_checkpoint``: every leaf, the head,
    ``n_active``, ``has_bias`` and ``meta`` bit-identical; seconds, MB/s and
    on-disk sizes."""
    from subspace_reg_tpu_torch.models.head import Head
    from subspace_reg_tpu_torch.utils import checkpoint as ck
    from subspace_reg_tpu_torch.utils import zstd
    from subspace_reg_tpu_torch.weights import to_jax_variables
    # the decoder's g++ build (first use) outside the timed loads
    t0 = time.time()
    zstd.get_lib()
    print(f"[orbax] zstd decoder library ready in {time.time() - t0:.2f} s "
          f"(g++ at first use)")
    sd = {k: v.to("cuda") for k, v in backbone.state_dict().items()}
    meta = {"epoch": 3, "training_classes": {4: 0, 9: 1}}
    out = {}
    r = np.random.RandomState(0)
    for bias in (False, True):
        b = (torch.from_numpy(r.randn(head.weight.shape[0]).astype(
            np.float32)).cuda() if bias else None)
        state = Head(weight=head.weight.to("cuda"), bias=b,
                     n_active=head.n_active)
        variables = to_jax_variables(sd)
        n_bytes = sum(as_numpy(v).nbytes for _, v in tree_items(variables))
        orbax, path = f"{tmp}/orbax/state_{bias}", f"{tmp}/orbax/{bias}.ckpt"
        t0 = time.time()
        ck.save_orbax(orbax, variables, state, meta)
        t1 = time.time()
        ck.save_checkpoint(path, variables, state, meta)
        t2 = time.time()
        ov, oh, om = ck.load_orbax(orbax)
        t3 = time.time()
        cv, chd, cm = ck.load_checkpoint(path)
        t4 = time.time()
        check(trees_bit_equal(ov, cv) and trees_bit_equal(ov, variables),
              f"orbax (bias {bias}): leaves differ from the .ckpt's")
        check(as_numpy(oh.weight).tobytes() == as_numpy(chd.weight)
              .tobytes() and oh.n_active == chd.n_active == head.n_active
              and type(oh.n_active) is int
              and (oh.bias is None) is (chd.bias is None) is (not bias)
              and (not bias or as_numpy(oh.bias).tobytes()
                   == as_numpy(chd.bias).tobytes()),
              f"orbax (bias {bias}): the head differs from the .ckpt's")
        check(om == cm == meta, f"orbax (bias {bias}): meta differs")
        mb = n_bytes / 1e6
        print(f"[orbax] bias {bias}: {mb:.1f} MB of variables; save_orbax "
              f"{t1 - t0:.2f} s ({mb / (t1 - t0):.0f} MB/s), load_orbax "
              f"{t3 - t2:.2f} s ({mb / (t3 - t2):.0f} MB/s); save_checkpoint "
              f"{t2 - t1:.2f} s, load_checkpoint {t4 - t3:.2f} s; on disk: "
              f"orbax {_dir_bytes(orbax) / 1e6:.1f} MB, .ckpt "
              f"{_dir_bytes(path) / 1e6:.1f} MB; bit-identical")
        if not bias:
            out = dict(orbax_dir=orbax, ckpt=path, save_s=t1 - t0,
                       load_s=t3 - t2, mb=mb)
    return out


ORBAX_FIXTURE = "tests/fixtures/orbax_resnet"


def orbax_fixture():
    """The committed orbax directory that JAX ``save_orbax`` wrote (orbax
    0.11.32: zstd-compressed chunks and b-tree nodes, so the decoder's
    Huffman literals, FSE tables and repeat offsets) read with
    ``load_orbax``: every leaf, the head, ``n_active``, ``has_bias`` and
    ``meta`` bit-identical to its ``.ckpt`` twin's; the weights loaded
    into a narrow resnet12 on the card give finite features."""
    import os
    from subspace_reg_tpu_torch.models.resnet import ResNetRFS
    from subspace_reg_tpu_torch.utils import checkpoint as ck
    from subspace_reg_tpu_torch.utils import ocdbt
    from subspace_reg_tpu_torch.weights import from_jax_variables
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ORBAX_FIXTURE)
    t0 = time.time()
    ov, oh, om = ck.load_orbax(f"{root}/orbax")
    t1 = time.time()
    cv, chd, cm = ck.load_checkpoint(f"{root}/state.ckpt")
    check(trees_bit_equal(ov, cv),
          "fixture: load_orbax's leaves differ from the .ckpt's")
    check(all(as_numpy(x).tobytes() == as_numpy(y).tobytes()
              for x, y in ((oh.weight, chd.weight), (oh.bias, chd.bias)))
          and type(oh.n_active) is int and oh.n_active == chd.n_active
          and om == cm, "fixture: the head or meta differs from the .ckpt's")
    chunks = {k: v for k, v in ocdbt.read_store(f"{root}/orbax").items()
              if not k.endswith(b".zarray")}
    n_bytes = sum(as_numpy(v).nbytes for _, v in tree_items(ov))
    framed = sum(len(v) for v in chunks.values())
    check(framed < n_bytes, "fixture: its chunks are not compressed")
    widths = tuple(ov["params"][f"layer{i}_0"]["conv1"]["kernel"]
                   .shape[-1] for i in range(1, 5))
    model = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.0,
                      no_dropblock=True, avg_pool=True, widths=widths)
    model.load_state_dict(from_jax_variables(ov))
    model = model.cuda().eval()
    with torch.no_grad():
        feat = model(torch.randn(4, 3, 84, 84, device="cuda",
                                 generator=torch.Generator("cuda")
                                 .manual_seed(0)))
    check(bool(torch.isfinite(feat).all()), "fixture: features not finite")
    print(f"[orbax] fixture {ORBAX_FIXTURE} (JAX save_orbax, orbax "
          f"0.11.32): {len(chunks)} chunks, {framed} bytes of zstd frames "
          f"for {n_bytes} bytes of leaves; load_orbax {t1 - t0:.3f} s; "
          f"bit-identical to its .ckpt twin; resnet12 {widths} on the card: "
          f"features {tuple(feat.shape)} finite")


def orbax_eval(root, opt, template, trip, counters):
    """The 8-session evaluation from the orbax-loaded weights and from the
    ``.ckpt`` of the same state (loaded into copies of ``template``), cuDNN
    deterministic, the same draws: K1 once a session from the orbax
    weights, the printed traces identical."""
    import copy
    from subspace_reg_tpu_torch.models.head import Head
    from subspace_reg_tpu_torch.utils import checkpoint as ck
    from subspace_reg_tpu_torch.weights import from_jax_variables
    runs = {}
    for kind, load in (("orbax", lambda: ck.load_orbax(trip["orbax_dir"])),
                       ("ckpt", lambda: ck.load_checkpoint(trip["ckpt"]))):
        variables, h, _ = load()
        backbone = copy.deepcopy(template)
        backbone.load_state_dict(from_jax_variables(variables))
        head = Head(weight=torch.from_numpy(np.array(h.weight)).cuda(),
                    bias=None, n_active=h.n_active)
        _reset(counters)
        with deterministic_cudnn():
            res, wall, out = _quiet(lambda: run_engine(
                root, opt, backbone.cuda(), head, "cuda"))
        runs[kind] = (res, wall, out, _launches(counters))
    (res, wall, out, launches), (ref, ref_wall, ref_out, _) = (
        runs["orbax"], runs["ckpt"])
    print(f"[orbax] 8-session run from orbax weights {wall:.2f} s "
          f"(from the .ckpt {ref_wall:.2f} s); launches {launches}; epochs "
          f"{res.epochs_per_session}; novel {res.acc_novel_list}")
    check(launches["finetune_loop"] == N_SESSIONS,
          f"orbax: K1 launched {launches['finetune_loop']} times, expected "
          f"{N_SESSIONS}")
    check(all(n == 0 for k, n in launches.items() if k != "finetune_loop"),
          f"orbax: the evaluation launched a pretraining kernel: {launches}")
    check(out.count("Fine-tuning epochs:") == N_SESSIONS and out == ref_out,
          "orbax: the printed trace differs from the .ckpt run's")
    check(res.epochs_per_session == ref.epochs_per_session
          and res.acc_novel_list == ref.acc_novel_list
          and res.acc_base_list == ref.acc_base_list,
          "orbax: the run differs from the .ckpt run")
    return launches["finetune_loop"]


def orbax_events(tmp):
    """One ``MetricWriter`` with the reference's scalars over 4 steps, its
    event file read back: file version, masked CRCs, tags, steps, f32
    values; ``metrics.jsonl`` beside it."""
    import glob
    import json
    from subspace_reg_tpu_torch.utils.logging import MetricWriter
    r = np.random.RandomState(0)
    want = [(name, float(100 * r.rand()), step) for step in range(4)
            for name in EVENT_SCALARS]
    d = f"{tmp}/orbax/tb"
    w = MetricWriter(d)
    for name, value, step in want:
        w.log_value(name, value, step)
    w.close()
    (path,) = glob.glob(f"{d}/events.out.tfevents.*")
    version, got = read_event_file(path)
    check(version == "brain.Event:2", f"event file version {version!r}")
    check(got == [(n, s, float(np.float32(v))) for n, v, s in want],
          f"event file scalars differ: {got[:3]} ...")
    with open(f"{d}/metrics.jsonl") as f:
        rows = [(x["name"], x["value"], x["step"]) for x in map(json.loads, f)]
    check(rows == want, "metrics.jsonl differs")
    print(f"[orbax] event file {path.rsplit('/', 1)[-1]}: {len(got)} "
          f"scalars, {_dir_bytes(path)} bytes, CRCs and values checked")


def phase_orbax(tmp, counters, run):
    """Phase 18: orbax directory checkpoints and event files."""
    root, opt, backbone, head = run
    trip = timed("18a orbax round trip", orbax_round_trip, tmp, backbone,
                 head)
    timed("18a orbax fixture", orbax_fixture)
    launches = timed("18b orbax eval", orbax_eval, root, opt, backbone, trip,
                     counters)
    timed("18c event files", orbax_events, tmp)
    return dict(orbax_launches=launches, orbax_save_s=trip["save_s"],
                orbax_load_s=trip["load_s"], orbax_mb=trip["mb"])


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


PHASE_SECONDS = []


def timed(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept under ``name``."""
    t0 = time.time()
    out = fn(*args)
    PHASE_SECONDS.append((name, time.time() - t0))
    return out


def print_times():
    for name, sec in PHASE_SECONDS:
        print(f"[time] phase {name}: {sec:.1f} s")
    print(f"[time] phases total: {sum(s for _, s in PHASE_SECONDS):.1f} s")


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
    for kname, info in timed("2 build", build_all).items():
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

    # phase 3: each kernel alone, beside its plain version, its library
    # call and its bound
    rows = {"finetune_loop": timed("3 kernels K1", phase_k1, dev),
            "conv3x3_fused": timed("3 kernels K2", phase_k2),
            "block_tail": timed("3 kernels K3", phase_k3, dev),
            "conv_f32": timed("3 kernels K4", phase_k4, dev),
            "bn_train": timed("3 kernels K5", phase_k5, dev)}
    k1 = rows["finetune_loop"]
    # K2 and K3 at CIFAR's 32 px step (resnet12): their rows keep the
    # 84 px step's numbers and carry these beside them
    cifar = {"conv3x3_fused": timed("3 kernels K2 32px", phase_k2,
                                    K2_CIFAR_SHAPES),
             "block_tail": timed("3 kernels K3 32px", phase_k3, dev,
                                 K3_CIFAR_SHAPES, K3_LAUNCH_GAP_MS)}
    for kname, row in cifar.items():
        rows[kname].update({f"cifar_{k}": row[k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "wrapper_ms",
            "shapes") if row.get(k) is not None})
    if only_kernels:
        print_times()
        print(smi)
        print(json.dumps({"kernels": list(rows.values())}))
        return 0

    from subspace_reg_tpu_torch.ops.conv_fused import (block_tail,
                                                       conv3x3_fused)
    from subspace_reg_tpu_torch.ops.finetune import finetune_loop
    counters = [finetune_loop, conv3x3_fused, block_tail]
    with tempfile.TemporaryDirectory() as tmp:
        # phase 4: the engine agrees with its CPU run
        small_root = timed("4 agree", phase_agree, tmp)
        # phase 5: the evaluation path, with the launch counters
        launches, eval_run, golden = timed("5 main", phase_main, tmp,
                                           counters)
        k1["launches"] = launches["finetune_loop"]
        rows["conv_f32"]["launches"] = launches["conv_f32"]
        # phase 7: the fused pretraining step agrees with the module step
        timed("7 pretrain-agree", phase_pretrain_agree, dev)
        # phase 8: the pretraining path, with the launch counters
        launches, run, data = timed("8 pretrain", phase_pretrain_main, dev,
                                    counters)
        for kname in ("conv3x3_fused", "block_tail", "bn_train"):
            rows[kname]["launches"] = launches[kname]
        # phase 9: where the fused step's device time goes
        timed("9 pretrain-profile", phase_pretrain_profile, run, data)
        # phase 10: the pretraining CLI for one epoch
        timed("10 cli", phase_pretrain_cli, tmp)
        # phase 11: the multi-seed evaluation, with the launch counters
        k1.update(timed("11 multiseed", phase_multiseed, tmp, counters,
                        small_root))
        # phase 12: the .ckpt, --reload_path and the fused step at 32 px
        resume = timed("12 resume", phase_resume, tmp, counters)
        for kname in ("conv3x3_fused", "block_tail"):
            rows[kname]["cifar_launches"] = resume["cifar_launches"][kname]
        rows["conv3x3_fused"].update(
            cifar_step_module_ms=resume["cifar_module_ms"],
            cifar_step_fused_ms=resume["cifar_fused_ms"])
        # phase 13: tieredImageNet and CIFAR-FS through the eval CLI
        sets = timed("13 datasets", phase_datasets, tmp, counters)
        k1.update(tiered_launches=sets["tiered_launches"],
                  cifar_launches=sets["cifar_launches"])
        # phase 14: the engine's other modes and the predict API
        modes = phase_modes(tmp, counters, small_root, eval_run, golden, k1)
        k1["save_preds_launches"] = modes["save_preds_launches"]
        # phase 15: the streamed loader, multi-seed pretraining, the mesh
        rest = phase_pretrain_rest(tmp, counters, dev)
        for kname, n in rest["rest_launches"].items():
            rows[kname]["pretrain_rest_launches"] = n
        # phase 16: distillation pretraining and the mapping trainer
        distill = phase_distill(tmp, counters, dev)
        for kname in KD_LAUNCHES:
            rows[kname]["distill_launches"] = distill["kd_launches"][kname]
        # phase 17: the mesh's fused and distillation steps, the parity
        # gate, the seed layout
        mesh = phase_mesh(tmp, counters, small_root)
        for kname, n in mesh["mesh_fused_launches"].items():
            rows[kname]["mesh_launches_per_rank"] = n
        k1["parity_launches"] = mesh["parity_launches"]
        # phase 18: orbax directory checkpoints and event files
        orbax = phase_orbax(tmp, counters, eval_run)
        k1["orbax_launches"] = orbax["orbax_launches"]

    print_times()
    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
