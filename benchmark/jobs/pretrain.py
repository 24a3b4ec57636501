"""Job ``pretrain``: the pretraining CLI's step on the cell's store.

Set-up builds what ``train_supervised._train`` builds (the bf16 module
backbone, the linear head, SGD, the step schedule) with weights from the
seed, and the training store from the seed: on the device for the
device-data step (``make_train_step_device_data``), or in host memory
streamed through ``data.pipeline.PrefetchLoader`` (``make_train_step``)
when the workload says ``"streamed": true``.  The first
``check_steps`` steps go through the window's own call and feed, and
the reference follows them from the same state, on batches it draws
itself from the seed's shuffle; more warm-up steps
follow, then the window steps until ``--seconds`` have passed, pulling
the loss and accuracies to the host every ``print_freq`` steps as the
CLI does.  A CUDA event before each step times the steps on the device.
The fused K2/K3 kernels, off the CLI's step, must launch nothing.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np

from benchmark import compare, synth
from benchmark.draws import ProgramDraws
from benchmark.harness import Check, Outcome, span, traced
from benchmark.program import build_backbone


def _argv(config: dict, workload: dict, seed: int) -> List[str]:
    p = config["pretrain"]
    return ["--model", config["model"], "--dataset", p["dataset"],
            "--batch_size", str(p["batch_size"]),
            "--learning_rate", str(p["learning_rate"]),
            "--lr_decay_epochs", ",".join(map(str, p["lr_decay_epochs"])),
            "--lr_decay_rate", str(p["lr_decay_rate"]),
            "--weight_decay", str(p["weight_decay"]),
            "--momentum", str(p["momentum"]), "--epochs", str(p["epochs"]),
            "--print_freq", str(workload["print_freq"]),
            "--transform", p["transform"], "--classifier", "linear",
            "--no_dropblock", "--no_linear_bias", "--continual",
            "--set_seed", str(seed % 2 ** 31)]


def _snapshot(state) -> Dict[str, "object"]:
    out = {k: v.detach().clone() for k, v in
           state.backbone.named_parameters()}
    out["head.w"] = state.head["w"].detach().clone()
    return out


def _buffers(state):
    return {k: v.detach().clone() for k, v in state.backbone.named_buffers()}


def _momentum(state):
    """The optimizer's momentum buffer of each leaf, by leaf name."""
    by_param = {id(p): k for k, p in state.backbone.named_parameters()}
    by_param[id(state.head["w"])] = "head.w"
    out = {}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                out[by_param[id(p)]] = buf.detach().clone()
    return out


def run(ctx) -> Outcome:
    torch = ctx.torch
    from subspace_reg_tpu_torch.config import parse_option_supervised
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.utils.device import resolve_device
    from benchmark.reference import pretrain as ref

    cfg, wl = ctx.cell.config, ctx.cell.workload
    wl = dict(wl, **ctx.overrides.get("workload", {}))
    cfg = dict(cfg, **ctx.overrides.get("config", {}))
    p = cfg["pretrain"]
    seed = ctx.seed
    dev = resolve_device(ctx.device)
    opt = parse_option_supervised(_argv(cfg, wl, seed), make_dirs=False)
    n_train, n_cls, bsz = int(p["n_train"]), int(p["n_cls"]), opt.batch_size
    steps_per_epoch = n_train // bsz

    # ---- the store, from the seed --------------------------------------
    labels = synth.balanced_labels(n_cls, n_train, seed)
    colours = synth.class_colours(seed, n_cls, dev)
    img = int(cfg["img_size"])
    streamed = bool(wl.get("streamed", False))
    if streamed:
        host = np.empty((n_train, img, img, 3), np.uint8)
        synth.store(seed, 0, labels, colours, img, dev, out=host)
    else:
        data_dev = synth.store(seed, 0, labels, colours, img, dev)
        labels_dev = torch.from_numpy(labels).to(dev)

    # ---- the model, as the CLI builds it -------------------------------
    train_spec, _ = transforms_options[opt.transform]
    backbone = build_backbone(cfg, opt, dtype=torch.bfloat16,
                              sizes=ctx.overrides.get("sizes"))
    sched = pt.make_schedule(opt, steps_per_epoch)
    state = pt.init_pretrain_state(backbone, n_cls, pt.make_tx(opt),
                                   with_bias=opt.linear_bias, device=dev)
    synth.init_backbone(state.backbone, seed)
    with torch.no_grad():
        state.head["w"].copy_(synth.head_weight(seed, n_cls,
                                                backbone.feature_dim, n_cls,
                                                dev))
    step_kw = dict(with_bias=opt.linear_bias,
                   draws=ProgramDraws(seed, dev), mesh=None,
                   label_pull=None, pull_embeds=None, teacher=None,
                   kd_temperature=opt.kd_T, kd_alpha=opt.kd_alpha,
                   kd_beta=opt.kd_beta)
    rng_np = np.random.RandomState(opt.set_seed)
    if streamed:
        from subspace_reg_tpu_torch.data.pipeline import PrefetchLoader
        loader = PrefetchLoader(host, labels, bsz, rng_np, device=dev)
        step_fn = pt.make_train_step(backbone, sched, train_spec, **step_kw)

        def epochs():
            while True:
                it = loader.epoch()
                try:
                    for x, y in it:
                        yield x, y
                finally:
                    it.close()
    else:
        loader = None
        step_dd = pt.make_train_step_device_data(backbone, sched,
                                                 train_spec, **step_kw)

        def step_fn(st, idxs_dev):
            return step_dd(st, data_dev, labels_dev, idxs_dev)

        def epochs():
            while True:
                for idxs in pt.epoch_batches(rng_np, n_train, bsz):
                    yield (torch.from_numpy(idxs).to(dev),)

    feed = epochs()
    print_freq = opt.print_freq
    n_step = 0

    def one_step():
        nonlocal n_step
        with span(torch, "batch"):
            args = next(feed)
        with span(torch, "step"):
            m = step_fn(state, *args)
        if (n_step % steps_per_epoch) % print_freq == 0:
            with span(torch, "print_pull"):
                float(m["loss"]), float(m["acc1"]), float(m["acc5"])
        n_step += 1
        return m

    # ---- the checked steps: the window's call and feed -----------------
    from subspace_reg_tpu_torch.ops import conv_fused
    conv_fused.conv3x3_fused.launches = conv_fused.block_tail.launches = 0
    n_check = int(wl["check_steps"])
    p0, b0 = _snapshot(state), _buffers(state)
    checked_losses = []
    mom1 = None
    for t in range(n_check):
        m = one_step()
        checked_losses.append(m["loss"].detach().clone())
        if t == 0:
            mom1 = _momentum(state)
    p_after, b_after = _snapshot(state), _buffers(state)
    for _ in range(int(wl["warmup_steps"])):
        one_step()
    torch.cuda.synchronize() if dev.type == "cuda" else None
    if loader is not None:
        loader.wait_s, loader.n_batches = 0.0, 0
    setup_s = ctx.setup_done()

    # ---- the window -------------------------------------------------------
    traces: list = []
    events = []
    cuda = dev.type == "cuda"
    steps_window = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    n_traced = int(wl["trace_steps"]) if ctx.trace else 0
    while time.perf_counter() < deadline or (ctx.trace and not traces):
        if ctx.trace and steps_window == int(wl["trace_from"]):
            # the device alone over the metrics' steps, then a few steps
            # with the host's operations for the idle gaps' names
            with traced(True, torch, traces, host_ops=False):
                for _ in range(n_traced):
                    one_step()
                    steps_window += 1
            with traced(True, torch, traces):
                for _ in range(int(wl["trace_host_steps"])):
                    one_step()
                    steps_window += 1
            continue
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        one_step()
        steps_window += 1
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    window_s = t1 - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])] \
        if cuda else [1e3 * window_s / max(steps_window, 1)]
    wait = (loader.wait_s, loader.n_batches) if loader is not None else None
    # the CLI's step is the module path: the fused K2/K3 kernels stay off
    fused = conv_fused.conv3x3_fused.launches + conv_fused.block_tail.launches
    feed.close()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    e2e = {"pretrain_images_per_s": steps_window * bsz / window_s,
           "pretrain_step_p95_ms": (statistics.quantiles(step_ms, n=100)[94]
                                    if len(step_ms) >= 2 else step_ms[0]),
           "setup_s": setup_s}

    # ---- the check: the reference follows the first steps ---------------
    # on batches of its own choosing: the shuffle of the first epoch from
    # the seed (DataLoader shuffle=True, drop_last=True)
    del state, backbone
    order = np.random.RandomState(opt.set_seed).permutation(n_train)
    batch_idx = [order[t * bsz:(t + 1) * bsz] for t in range(n_check)]
    if streamed:
        batches = [(torch.from_numpy(host[i]).to(dev),
                    torch.from_numpy(labels[i]).to(dev)) for i in batch_idx]
    else:
        batches = [(data_dev[torch.from_numpy(i).to(dev)],
                    labels_dev[torch.from_numpy(i).to(dev)])
                   for i in batch_idx]
    r = ref.run_steps(cfg, p0, b0, batches, seed, steps_per_epoch)
    losses_p = [float(x) for x in checked_losses]
    wd = p["weight_decay"]
    g_prog = {k: mom1[k] - wd * p0[k] for k in mom1}
    moving = compare.moving_leaves(r["first_grad"])
    delta_r = {k: r["params"][k] - p0[k] for k in p0}
    stats = [k for k in b0 if k.endswith(("running_mean", "running_var"))]
    counters = [k for k in b0 if k.endswith("num_batches_tracked")]
    def gaps(losses, grad, params, buffers):
        delta = {k: params[k] - p0[k] for k in p0}
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(losses, r["losses"])),
            "grad_gap": compare.worst_leaf_norm_gap(grad, r["first_grad"]),
            "update_gap": compare.worst_leaf_norm_gap(delta, delta_r,
                                                      moving),
            "bn_stat_gap": compare.worst_leaf_norm_gap(
                {k: buffers[k] for k in stats},
                {k: r["buffers"][k] for k in stats}),
            "counter_gap": float(max(abs(int(buffers[k])
                                         - int(r["buffers"][k]))
                                     for k in counters)),
        }

    values = dict(gaps(losses_p, g_prog, p_after, b_after),
                  fused_launches=float(fused))
    control = None
    if ctx.overrides.get("control"):
        # the control: the reference with its convolutions' operands in
        # fp8 (e4m3), put in the program's place
        c = ref.run_steps(cfg, p0, b0, batches, seed, steps_per_epoch,
                          operand_round=ref.fp8_round)
        control = gaps(c["losses"], c["first_grad"], c["params"],
                       c["buffers"])
    limits = wl["limits"]
    checks = [Check(k, float(v), float(limits[k]))
              for k, v in values.items() if k in limits]
    records = {"steps_traced": n_traced,
               "train_step_flops_args": (bsz, n_cls),
               "precision": p["precision"]}
    if wait is not None:
        records["loader_wait_s"], records["loader_batches"] = wait
    facts = {"steps in window": steps_window,
             "window seconds": window_s,
             "step ms (device) median/p95/max": (
                 statistics.median(step_ms), e2e["pretrain_step_p95_ms"],
                 max(step_ms)),
             "setup seconds": setup_s,
             "K2/K3 launches": fused,
             "leaves compared (change)": f"{len(moving)} of {len(p0)}",
             "reference losses": r["losses"], "program losses": losses_p,
             "not compared": {k: v for k, v in values.items()
                              if k not in limits}}
    if control is not None:
        facts["control"] = control
    return Outcome(e2e=e2e, records=records, checks=checks,
                   attempted=steps_window + n_check, failed=0,
                   memory_peak_bytes=peak, traces=traces,
                   window_facts=facts)

