#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (subspace_reg_tpu_torch) on one
NVIDIA card.  Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

  1. device   the card's name and count, ``nvidia-smi``'s name and power
              limit; TF32 off for matmuls and cuDNN convolutions.
  2. build    every CUDA kernel of the port from csrc/, one nvcc per source,
              all started together; build seconds and ``-Xptxas -v``.
  3. kernels  K1 (the fused head fine-tune loop) against its plain torch
              twin on the card at the main path's shapes (100 classes,
              D=640, 185 support rows, 200 replay rows; the last session's
              counts), for SGD + subspace pull + memory, Adam, and the
              [W | b] bias column; CUDA-event times of both.
  4. agree    the port's 8-session engine on the card against the same
              engine on the CPU (plain twin) at a small size with the same
              draws: equal epoch counts, accuracies within 0.5.
  5. main     the golden subspace-reg + memory evaluation (README quick
              start flags) through ``few_shot_finetune_incremental_test``:
              8 sessions, full-width resnet18, 84 px synthetic
              miniImageNet made from a seed, random weights from a seed.
              Every kernel launch counter is set to 0 just before and read
              just after; K1 must have launched once per session.
  6. profile  the same run again under torch.profiler: device time of K1,
              of the convolutions and of the rest, and the busy share.

The line before the last is one JSON object with each kernel's launches on
the main path, its error against the twin, its time, the twin's time and
its roofline bound; the last line is ``{"ok": true, "device": ...}``.
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
def k1_case(kind: str, device, max_epochs: int = 100, seed: int = 0):
    """Operands of the last session of the golden run: 100 active classes,
    185 support rows (125 novel + 60 base exemplars), 175 of 200 replay
    rows, 35 reserved rows.  ``kind``: 'sgd' (subspace pull + memory),
    'adam', 'bias' (the [W | b] layout, no novel anchor), 'semantic' (the
    semantic pull) or 'plain' (no pull, no memory)."""
    from subspace_reg_tpu_torch.ops.finetune import LoopConfig, pack_scalars
    r = np.random.RandomState(seed)
    cp, feat, ns, nm = 100, 640, 185, 200
    n_active, mem_count, orig_base, n_ways = 100, 175, 60, 5
    bias, adam = kind == "bias", kind == "adam"
    memory_on = kind != "plain"
    pull_mode = {"semantic": "semantic", "plain": "none"}.get(kind,
                                                             "subspace")
    n_reserved = 0 if bias else 35
    d = feat + (1 if bias else 0)
    f32 = np.float32
    f_sup = (0.5 * np.abs(r.randn(ns, d))).astype(f32)
    f_mem = np.zeros((nm, d), f32)
    f_mem[:mem_count] = 0.5 * np.abs(r.randn(mem_count, d))
    if bias:
        f_sup[:, feat] = 1.0
        f_mem[:, feat] = 1.0
    y_sup = np.concatenate([np.repeat(np.arange(95, 100), 25),
                            np.arange(60)]).astype(np.int32)
    y_mem = np.zeros(nm, np.int32)
    y_mem[:mem_count] = np.repeat(np.arange(60, 95), 5)
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
        stable_target=10, adam_b1=0.9, adam_b2=0.999, adam_eps=1e-8,
        prev_loss0=5.0, stable0=0.0)
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


def phase_kernels(dev):
    from subspace_reg_tpu_torch.ops.finetune import (finetune_loop,
                                                     finetune_loop_plain)
    rows = {}
    for kind in ("sgd", "adam", "bias"):
        ops, cfg = k1_case(kind, dev)
        w_k, st_k, tr_k = finetune_loop(**ops, cfg=cfg)
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
        check(torch.allclose(tr_k[2:ep + 1], tr_p[2:ep + 1], rtol=1e-4,
                             atol=1e-5), f"K1 {kind}: trace differs")
        if kind == "sgd":
            ms = cuda_ms(lambda: finetune_loop(**ops, cfg=cfg), 10)
            plain_ms = cuda_ms(lambda: finetune_loop_plain(**ops, cfg=cfg), 3)
            bound_ms, bound_by = k1_bound(ops, cfg, ep - 1)
            print(f"[kernels] K1 sgd: {ep - 1} epochs/launch, kernel "
                  f"{ms:.3f} ms ({1e3 * ms / (ep - 1):.2f} us/epoch), plain "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
            rows["finetune_loop"] = dict(
                name="finetune_loop", route="cuda",
                source="subspace_reg_tpu_torch/csrc/finetune_loop.cu",
                replaces="subspace_reg_tpu/ops/pallas/finetune.py:324",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                epochs_per_launch=ep - 1, us_per_epoch=1e3 * ms / (ep - 1))
    return rows


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


def phase_profile(run):
    """One more golden run under torch.profiler, after the counted one:
    device time of K1, of the convolutions and of everything else, against
    the wall clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    root, opt, backbone, head = run
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _run_engine(root, opt, backbone, head, "cuda", verbose=False)
        torch.cuda.synchronize()
        wall = time.time() - t0
    groups = {"K1": 0.0, "convolution": 0.0, "other kernels": 0.0}
    by_name = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name in _TRACER_OVERHEAD:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us = e.device_time_total
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        if "finetune_loop_kernel" in e.name:
            groups["K1"] += us
        elif any(m in e.name for m in _CONV_MARKS):
            groups["convolution"] += us
        else:
            groups["other kernels"] += us
    # busy time = the union of the kernels' intervals (kernel times summed
    # count overlapping records twice)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    check(groups["K1"] > 0, "the profiler saw no K1 launch")
    print(f"[profile] wall {wall:.3f} s; kernel time K1 "
          f"{groups['K1'] / 1e6:.3f} s, convolution "
          f"{groups['convolution'] / 1e6:.3f} s, other kernels "
          f"{groups['other kernels'] / 1e6:.3f} s; device busy "
          f"{busy / 1e6:.3f} s = {100 * busy / 1e6 / wall:.1f}% of the wall "
          "clock")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile] {us / 1e3:10.1f} ms  {name[:90]}")


def main() -> int:
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

    # phase 3: kernels against their twins
    rows = phase_kernels(dev)

    from subspace_reg_tpu_torch.ops.finetune import finetune_loop
    with tempfile.TemporaryDirectory() as tmp:
        # phase 4: the engine agrees with its CPU run
        phase_agree(tmp)
        # phase 5: the main path, with the launch counters
        launches, run = phase_main(tmp, [finetune_loop])
        # phase 6: where the main path's device time goes
        phase_profile(run)
    for kname, n in launches.items():
        rows[kname]["launches"] = n

    print(smi)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
