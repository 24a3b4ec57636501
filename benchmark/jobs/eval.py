"""Job ``eval``: the 8-session FSCIL evaluation, runs back to back.

Each run is what one ``eval_incremental.main`` call does for one
``--set_seed``: the two episode samplers built over the splits, then
``engine.incremental.few_shot_finetune_incremental_test`` with the
golden flags of the workload.  The splits (class-coloured images from the
seed, in host memory as the loaders hand them over), the backbone's
weights and the 60- or 351-row head are made once in set-up, with one
warm-up run.  Runs then start while the window is open; the window ends
when the last run that started has finished.  Run ``r`` evaluates
``--set_seed`` = ``seed_base + r``: the seeds a user sweeps.

One run of the window, drawn from the seed, is checked: the plain
reference (``reference/fscil.py``) evaluates the same seed from the same
inputs, and its epoch-1 head, cached features, fine-tuned head, epochs,
accuracies and replay memory are compared with the program's, which the
benchmark records at two boundaries of the engine: the session program's
``prepare`` (the head after epoch 1 and the feature caches) and the host
loop's ``finish`` (the fine-tuned head, the metrics, the memory after the
update).  K1's launches in the window are counted against one a session.
"""

from __future__ import annotations

import contextlib
import io
import time
from typing import Dict, List

import numpy as np

from benchmark import compare, flops, synth
from benchmark.draws import ProgramDraws
from benchmark.harness import Check, Outcome, span, traced
from benchmark.program import build_backbone


def run_seed(seed: int, r: int) -> int:
    """``--set_seed`` of run ``r``: a positive int below 2**31."""
    return 1 + (seed * 1009 + r) % (2 ** 31 - 2)


def make_splits(cfg: dict, seed: int, dev):
    """(base_test, base_train, novel) ``SplitData`` as the CLI's loaders
    return them for the configuration, from the seed."""
    from subspace_reg_tpu_torch.data.mini_imagenet import SplitData
    e = cfg["eval"]
    img = int(cfg["img_size"])
    n_base, n_novel = int(e["n_base"]), int(e["n_novel_classes"])
    colours = synth.class_colours(seed, n_base + n_novel, dev)

    def split(index, labels, names):
        imgs = np.empty((len(labels), img, img, 3), np.uint8)
        synth.store(seed, index, labels, colours, img, dev, out=imgs)
        return SplitData(imgs=imgs, labels=labels.tolist(), cat2label={},
                         label2human=names)

    base_names = [f"base class {i}" for i in range(n_base)]
    novel_ids = n_base + np.arange(n_novel)
    novel_names = [""] * n_base + [f"novel class {i}" for i in range(n_novel)]
    base_test = split(
        1, synth.balanced_labels(n_base, int(e["base_test_n"]), seed + 1),
        base_names)
    base_train = split(
        2, synth.balanced_labels(n_base,
                                 n_base * int(e["base_train_per_class"]),
                                 seed + 2), base_names)
    novel_labels = novel_ids[synth.balanced_labels(
        n_novel, n_novel * int(e["novel_per_class"]), seed + 3,
        shuffle=False)]
    novel = split(3, novel_labels, novel_names)
    return base_test, base_train, novel


class Recorder:
    """Records what the engine produced in the run it is armed for."""

    def __init__(self):
        self.armed = False
        self.prepared: List[dict] = []
        self.finished: List[dict] = []

    @classmethod
    def of(cls, run: dict) -> "Recorder":
        """A reference's run recorded as the program's is."""
        import torch
        rec = cls()
        for c in run["sessions"]:
            rec.prepared.append({k: c[k] for k in (
                "w1", "f_sup", "f_mem", "f_query", "f_base")})
            rec.finished.append(dict(
                w=c["w"], epochs=c["epochs"],
                chunk_accs=torch.tensor(c["chunk_accs"]),
                base_acc=c["base_acc"],
                query_preds=c["query_logits"].argmax(1),
                base_preds=c["base_logits"].argmax(1), query_y=c["query_y"],
                base_y=c["base_y"], memory_y=c["memory_y"],
                memory_x=c["memory_x"]))
        return rec

    def install(self):
        from subspace_reg_tpu_torch.engine import incremental as inc
        rec = self
        prepare, finish = inc.SessionProgram.prepare, inc.SeedRun.finish

        def prepare_rec(self, s):
            p = prepare(self, s)
            if rec.armed:
                rec.prepared.append(dict(
                    w1=p.params["w"][:s.n_active], n_active=s.n_active,
                    f_sup=p.f_sup, f_mem=p.f_mem[:s.memory_count],
                    f_query=p.f_query, f_base=p.f_base))
            return p

        def finish_rec(self, idx, params, metrics, seconds, novel_weight):
            finish(self, idx, params, metrics, seconds, novel_weight)
            if rec.armed:
                rec.finished.append(dict(
                    w=params["w"][:self.n_active],
                    epochs=metrics["epochs"], chunk_accs=metrics["chunk_accs"],
                    base_acc=metrics["base_acc"],
                    query_preds=metrics["query_preds"],
                    base_preds=metrics["base_preds"],
                    query_y=self.query_y[:metrics["query_preds"].shape[0]],
                    base_y=self.base_y,
                    memory_y=self.memory_y[:self.memory_count].clone(),
                    memory_x=self.memory_x[:self.memory_count].clone()))

        inc.SessionProgram.prepare = prepare_rec
        inc.SeedRun.finish = finish_rec

        def uninstall():
            inc.SessionProgram.prepare = prepare
            inc.SeedRun.finish = finish
        return uninstall


def session_geometry(cfg: dict, epochs: List[int]) -> List[dict]:
    """Per session the rows the engine really needs (replay rows as
    filled, not padded) and K1's sizes, for flops.py."""
    e = cfg["eval"]
    n_base, ways = int(e["n_base"]), int(e["n_ways"])
    n_sup = ways * int(e["n_shots"]) * int(e["n_aug"]) + n_base
    nq = ways * int(e["n_queries"])
    sessions = int(e["sessions"])
    dim = flops.feature_dim(cfg)
    trace_rows = ((int(e["max_novel_epochs"]) + 2 + 7) // 8) * 8
    return [dict(n_sup=n_sup, mem_count=25 * s, n_mem_rows=25 * sessions,
                 n_active=n_base + ways * (s + 1),
                 max_classes=n_base + ways * sessions, dim=dim,
                 n_ways=ways, n_query=nq * (s + 1), epochs=epochs[s],
                 trace_rows=trace_rows)
            for s in range(sessions)]


def run(ctx) -> Outcome:
    torch = ctx.torch
    from subspace_reg_tpu_torch.config import MAX_SESSIONS, parse_option_eval
    from subspace_reg_tpu_torch.models.head import Head
    from subspace_reg_tpu_torch.utils.device import resolve_device

    cfg = dict(ctx.cell.config, **ctx.overrides.get("config", {}))
    wl = dict(ctx.cell.workload, **ctx.overrides.get("workload", {}))
    e = cfg["eval"]
    seed = ctx.seed
    dev = resolve_device(ctx.device)
    argv = list(wl["argv"]) + ["--model", cfg["model"], "--dataset",
                               e["dataset"]]
    opt0 = parse_option_eval(argv)
    n_base = int(e["n_base"])
    max_classes = n_base + MAX_SESSIONS * opt0.n_ways

    # ---- inputs and weights from the seed ------------------------------
    base_test, base_train, novel = make_splits(cfg, seed, dev)
    backbone = build_backbone(cfg, opt0,
                              sizes=ctx.overrides.get("sizes")).to(dev)
    synth.init_backbone(backbone, seed)
    dim = backbone.feature_dim
    head0 = Head(weight=synth.head_weight(seed, n_base, dim, max_classes,
                                          dev),
                 bias=None, n_active=n_base)
    weights0 = synth.state_of(backbone)
    rec = Recorder()
    uninstall = rec.install()
    try:
        return _run(ctx, cfg, wl, argv, opt0, seed, dev, base_test,
                    base_train, novel, backbone, head0, weights0, rec)
    finally:
        uninstall()


def _run(ctx, cfg, wl, argv, opt0, seed, dev, base_test, base_train, novel,
         backbone, head0, weights0, rec) -> Outcome:
    torch = ctx.torch
    from subspace_reg_tpu_torch.config import MAX_SESSIONS, parse_option_eval
    from subspace_reg_tpu_torch.data.episodes import EpisodeSampler
    from subspace_reg_tpu_torch.engine.incremental import (
        few_shot_finetune_incremental_test)
    from benchmark.reference import fscil
    e = cfg["eval"]
    n_base = int(e["n_base"])
    cuda = dev.type == "cuda"
    meta = {"has_bias": False}
    results = []

    def one_run(r: int, armed: bool = False):
        """One ``eval_incremental.main`` call's work for run ``r``."""
        opt = parse_option_eval(argv + ["--set_seed",
                                        str(run_seed(seed, r))])
        budget = len(set(novel.labels)) // opt.n_ways
        if opt.neval_episodes == 2000:
            opt.neval_episodes = MAX_SESSIONS
        opt.neval_episodes = min(opt.neval_episodes, budget)
        base_sampler = EpisodeSampler(base_train, opt, split="train",
                                      phase="train")
        meta_sampler = EpisodeSampler(novel, opt, split="val",
                                      use_episodes=opt.use_episodes,
                                      disjoint_classes=True)
        opt.linear_bias = False
        opt.split = "val"
        rec.armed = armed
        with contextlib.redirect_stdout(io.StringIO()), span(torch, "run"):
            res = few_shot_finetune_incremental_test(
                backbone, head0, meta, opt, meta_sampler=meta_sampler,
                base_test_split=base_test,
                base_support_sampler=base_sampler, device=dev,
                draws=ProgramDraws(opt.set_seed, dev))
        rec.armed = False
        if cuda:
            torch.cuda.synchronize()
        return res

    # ---- warm-up: one run of the cell's shapes ---------------------------
    from subspace_reg_tpu_torch.utils import cuda_build
    k1_cached = cuda_build.library_path("finetune_loop").exists()
    one_run(-1)
    setup_s = ctx.setup_done()

    # ---- the window -------------------------------------------------------
    from subspace_reg_tpu_torch.ops.finetune import finetune_loop
    checked = seed % 2
    traces: list = []
    finetune_loop.launches = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    with traced(ctx.trace, torch, traces):
        r = 0
        while time.perf_counter() < deadline or r < 2:
            results.append(one_run(r, armed=(r == checked)))
            r += 1
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n_runs = len(results)
    # K1 on the card: one launch a session (the plain twin on the CPU
    # launches nothing)
    k1_launches = finetune_loop.launches
    k1_expected = n_runs * int(e["sessions"]) if cuda else 0

    # ---- the check ----------------------------------------------------------
    prog_res = results[checked]

    def reference(tf32: bool) -> dict:
        return fscil.evaluate(
            cfg=cfg, opt=vars(parse_option_eval(
                argv + ["--set_seed", str(run_seed(seed, checked))])),
            weights=weights0, head0=head0.weight, n_base=n_base,
            base_test=(base_test.imgs, np.asarray(base_test.labels)),
            base_train=(base_train.imgs, np.asarray(base_train.labels)),
            novel=(novel.imgs, np.asarray(novel.labels)),
            seed=run_seed(seed, checked), device=dev, tf32=tf32)

    ref = reference(False)
    values = compare_eval(rec, ref, prog_res, wl["limits"])
    values["k1_launch_gap"] = float(abs(k1_launches - k1_expected))
    checks = [Check(k, float(v), float(wl["limits"][k]))
              for k, v in values.items() if k in wl["limits"]]
    control = None
    if ctx.overrides.get("control"):
        # the control: the reference in TF32 put in the program's place
        control = compare_eval(Recorder.of(reference(True)), ref, None,
                               wl["limits"])

    epochs = [list(res.epochs_per_session) for res in results]
    geo = [session_geometry(cfg, ep) for ep in epochs]
    records = {"runs": n_runs, "sessions": geo,
               "base_eval_n": opt0.test_base_batch_size // 2,
               "config": cfg, "precision": e["precision"]}
    facts = {"runs in window": n_runs, "window seconds": window_s,
             "setup seconds": setup_s,
             "K1 library at start": "cached" if k1_cached else "built",
             "K1 launches in window (expected)": (k1_launches, k1_expected),
             "checked run": checked,
             "epochs per session (checked run)": prog_res.epochs_per_session,
             "reference epochs": ref["epochs"],
             "not compared": {k: v for k, v in values.items()
                              if k not in wl["limits"]}}
    if control is not None:
        facts["control"] = control
    return Outcome(e2e={"eval_s_per_seed": window_s / n_runs,
                        "setup_s": setup_s},
                   records=records, checks=checks, attempted=n_runs,
                   failed=0, memory_peak_bytes=peak, traces=traces,
                   window_facts=facts)


def _prediction_gap(logits, preds) -> float:
    """The widest gap by which the reference's logit of the program's
    predicted class lies below the reference's best, over the largest
    logit's magnitude (0 where the two agree; near-ties flip by
    rounding, a wrong answer by a class's margin)."""
    import torch
    preds = preds.to(logits.device).long()
    if preds.shape[0] != logits.shape[0]:
        return float("inf")
    best = logits.max(1).values
    got = logits.gather(1, preds[:, None])[:, 0]
    scale = float(best.abs().max())
    return float((best - got).max()) / max(scale, 1e-30)


def _accuracy_of(preds, y) -> "torch.Tensor":
    return (preds.long().cpu() == y.long().cpu()).double().mean() * 100.0


def compare_eval(rec: Recorder, ref: dict, prog_res,
                 limits: dict) -> Dict[str, float]:
    """Every gap between the program's run and the reference's, each the
    worst over the run's sessions; the workload's ``limits`` say which are
    compared."""
    import torch
    inf = float("inf")
    n = len(ref["sessions"])
    if len(rec.prepared) != n or len(rec.finished) != n:
        return {k: inf for k in limits}
    feat = head1 = head = pred = acc_rec = 0.0
    epochs_gap = mem = mem_x = 0.0
    for s in range(n):
        pp, pf, rs = rec.prepared[s], rec.finished[s], ref["sessions"][s]
        for k in ("f_sup", "f_mem", "f_query", "f_base"):
            feat = max(feat, compare.rel_max_gap(pp[k], rs[k]))
        head1 = max(head1, compare.rel_max_gap(pp["w1"], rs["w1"]))
        head = max(head, compare.rel_max_gap(pf["w"], rs["w"]))
        epochs_gap = max(epochs_gap, abs(float(pf["epochs"]) - rs["epochs"]))
        pred = max(pred, _prediction_gap(rs["query_logits"],
                                         pf["query_preds"]),
                   _prediction_gap(rs["base_logits"], pf["base_preds"]))
        # the accuracies the program reports are those of its answers
        nq = rs["chunk_size"]
        chunks = pf["chunk_accs"].double().cpu()
        qp, qy = pf["query_preds"], pf["query_y"]
        if chunks.shape[0] * nq != qp.shape[0]:
            acc_rec = inf
        for c in range(chunks.shape[0]):
            acc_rec = max(acc_rec, abs(float(chunks[c]) - float(
                _accuracy_of(qp[c * nq:(c + 1) * nq],
                             qy[c * nq:(c + 1) * nq]))))
        acc_rec = max(acc_rec, abs(float(pf["base_acc"]) - float(
            _accuracy_of(pf["base_preds"], pf["base_y"]))))
        my = pf["memory_y"].cpu()
        mr = torch.as_tensor(rs["memory_y"])
        mem = max(mem, float((my != mr).sum()) if my.shape == mr.shape
                  else inf)
        mem_x = max(mem_x, compare.rel_max_gap(pf["memory_x"],
                                               rs["memory_x"]))
    # the engine's printed record agrees with what it produced
    traces = [round(float(a), 2) for s in rec.finished
              for a in s["chunk_accs"].cpu()]
    printed = (traces if prog_res is None else
               [a for t in prog_res.novel_session_traces for a in t])
    values = {"feature_gap": feat, "epoch1_head_gap": head1,
              "head_gap": head, "epochs_gap": epochs_gap,
              "prediction_gap": pred, "accuracy_record_gap": acc_rec,
              "memory_label_gap": mem, "memory_image_gap": mem_x,
              "record_gap": (0.0 if traces == printed else inf)}
    return values
