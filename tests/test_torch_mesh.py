"""The port's mesh (subspace_reg_tpu_torch/parallel/mesh.py, on
torch.distributed with gloo) against the single-process step, at a narrow
resnet18 (widths 8/16/24/32, 16 px, global batch 8, drop rate 0.1 so the
global batch's dropout masks are checked too), as the JAX package holds
its mesh (tests/test_multichip_equiv.py): a sharded step equals the
single-device step on the same global batch.

The first half of this file is the check itself, which chip_smoke.py's
phase 15d also runs on the card: ``launch`` starts one process a rank
(this file run as a script: torch and the port only, a file store, a
timeout on every init, collective and join), each joins a process group,
builds the same seeded state and runs the configured scenarios;
``reference`` runs the same steps in one process without a mesh.

Tolerances, those of test_multichip_equiv.py (``agreement``): loss rel
2e-5, BN running statistics rtol 1e-4 / atol 1e-5, each parameter
update's cosine >= 0.999 and norm within 1%.  Bit-identical: the ranks to
each other after 3 steps, world size 1 to no mesh, and the sharded
device-data gather to the sharded host batch.
"""

import argparse
import contextlib
import copy
import datetime
import functools
import json
import os
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import pytest
import torch
import torch.distributed as dist

from subspace_reg_tpu_torch.models.layers import (TorchBatchNorm,
                                                  cross_replica)
from subspace_reg_tpu_torch.parallel import mesh as mesh_lib

# --------------------------------------------------------------------------
# the check: a sharded step against the single-process step
# --------------------------------------------------------------------------
# A configuration holds the backbone's ``widths`` and ``n_blocks``, ``img``,
# the global ``batch``, ``n_cls``, ``n_store`` (images to draw batches
# from), ``device`` and ``scenarios``: a list of {"name", "n_data",
# "n_model", "steps", "mode"} with ``mode`` "streamed" or "device_data",
# and optionally ``dtype`` ("f32", the default, or "bf16") and ``pixels``
# ("random", the default, or "coloured": a colour a class plus noise, as
# data/synthetic.py draws its images).  The step has dropout 0.1 and
# DropBlock at the end of its ramp, the golden SGD and transform A; on a
# card cuDNN runs its deterministic algorithms and TF32 is off.
SMALL = dict(widths=(8, 16, 24, 32), n_blocks=(1, 1, 2, 2), img=16,
             batch=8, n_cls=12, n_store=64, timeout_s=120.0)

SEED = 1
DROPBLOCK_RAMP = 40000      # forwards (models/resnet.py::dropblock_gamma)
# each rank's CPU threads; the reference runs at the same count, as CPU
# convolutions sum in an order that depends on it
THREADS = 2


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


def _state(cfg, device, dtype):
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.models.resnet import ResNetRFS
    from subspace_reg_tpu_torch.utils import optim
    torch.manual_seed(SEED)
    bb = ResNetRFS(n_blocks=tuple(cfg["n_blocks"]), drop_rate=0.1,
                   no_dropblock=True, avg_pool=True,
                   widths=tuple(cfg["widths"]),
                   dtype=torch.bfloat16 if dtype == "bf16" else None)
    # the end of DropBlock's ramp: its full rate, and its batch-level
    # normalization, from the first step
    for block in bb.blocks():
        block.num_batches_tracked.fill_(DROPBLOCK_RAMP)
    tx = functools.partial(optim.sgd_torch, learning_rate=0.05,
                           momentum=0.9, weight_decay=5e-4)
    return pt.init_pretrain_state(
        bb, cfg["n_cls"], tx, False,
        generator=torch.Generator().manual_seed(SEED), device=device)


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


def _run(cfg, scenario, device, mesh=None) -> dict:
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
    here = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    procs = []
    for r in range(world):
        cmd = [sys.executable, here, "--config", cfg_path, "--rank", str(r),
               "--world", str(world), "--init", f"file://{init_file}",
               "--out", os.path.join(workdir, f"rank{r}.pt")]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
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


def ranks_identical(results: List[Dict[str, dict]], name: str) -> bool:
    """Every rank's final state of scenario ``name`` bit-identical to rank
    0's."""
    first = results[0][name]["final"]
    return all(first.keys() == r[name]["final"].keys()
               and all(torch.equal(first[k], r[name]["final"][k])
                       for k in first) for r in results[1:])


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of the mesh check")
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


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------
SCENARIOS = [dict(name="data", n_data=2, n_model=1, steps=1,
                  mode="streamed"),
             dict(name="model", n_data=1, n_model=2, steps=1,
                  mode="streamed"),
             dict(name="three", n_data=2, n_model=1, steps=3,
                  mode="streamed"),
             dict(name="device_data", n_data=2, n_model=1, steps=1,
                  mode="device_data")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = dict(SMALL, device="cpu", scenarios=SCENARIOS, timeout_s=90.0)
    ranks = launch(cfg, 2, str(tmp_path_factory.mktemp("mesh2")))
    return ranks, reference(cfg)


@pytest.mark.parametrize("name", ["data", "model"])
def test_sharded_step_equals_single_process(runs, name):
    """(2, 1): the batch split over two ranks, BN statistics and gradients
    reduced; (1, 2): the head's rows split, the logits gathered."""
    ranks, ref = runs
    for r in ranks:
        rep = agreement(ref[name], r[name])
        assert rep["ok"], rep
    assert ranks_identical(ranks, name)


def test_ranks_stay_bit_identical(runs):
    """Three steps: the reduced gradients and statistics keep the two
    replicas equal bit for bit (parameters, statistics, counters,
    momentum), and their losses equal."""
    ranks, ref = runs
    assert ranks_identical(ranks, "three")
    assert ranks[0]["three"]["metrics"] == ranks[1]["three"]["metrics"]
    assert len(ranks[0]["three"]["metrics"]) == 3
    # the first step still agrees with the single process
    assert agreement(ref["three"], ranks[0]["three"])["loss_rel"] \
        <= LOSS_RTOL


def test_sharded_device_data_gather(runs):
    """The device-data step under the mesh (the whole store on every rank,
    each gathering its shard of the global index vector) equals the
    single-process device-data step, and bit for bit the sharded host
    batch's step."""
    ranks, ref = runs
    for r in ranks:
        rep = agreement(ref["device_data"], r["device_data"])
        assert rep["ok"], rep
        a, b = r["device_data"]["final"], r["data"]["final"]
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_world_size_one_is_the_unsharded_step(tmp_path):
    """A mesh of one rank (1, 1) is bit-identical to no mesh, with the
    streamed and the device-data step."""
    scen = [dict(name="one", n_data=1, n_model=1, steps=2,
                 mode="streamed"),
            dict(name="one_dd", n_data=1, n_model=1, steps=2,
                 mode="device_data")]
    cfg = dict(SMALL, device="cpu", scenarios=scen, timeout_s=60.0)
    (got,) = launch(cfg, 1, str(tmp_path))
    ref = reference(cfg)
    for name in ("one", "one_dd"):
        assert got[name]["metrics"] == ref[name]["metrics"]
        a, b = got[name]["final"], ref[name]["final"]
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), name


@pytest.fixture
def group_of_one(tmp_path):
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("masked", [False, True])
def test_synced_statistics_equal_local_ones(group_of_one, masked):
    """The cross-replica path of TorchBatchNorm (sums, sums of squares and
    counts all-reduced, masked rows left out) on a group of one: the same
    output, running statistics and gradients as the local single-pass
    path, within f32 rounding of the two summation orders (rtol 1e-5,
    atol 1e-6)."""
    r = np.random.RandomState(0)
    x0 = torch.from_numpy(r.standard_normal((6, 4, 5, 5)).astype(
        np.float32) * 3 + 1)
    mask = torch.tensor([1, 1, 0, 1, 0, 1]) if masked else None
    outs = []
    for sync in (None, group_of_one):
        bn = TorchBatchNorm(4).train()
        with torch.no_grad():
            bn.weight.copy_(torch.tensor([1.0, 2.0, 0.5, 1.5]))
        x = x0.clone().requires_grad_(True)
        with cross_replica(bn, sync):
            y = bn(x, mask)
        assert bn.sync_group is None
        (y * torch.arange(y.numel()).reshape(y.shape).float()).sum() \
            .backward()
        outs.append((y.detach(), bn.running_mean, bn.running_var, x.grad,
                     bn.weight.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_mesh_helpers(group_of_one):
    """Row ranges of the batch and head shards, and the mesh's refusal of
    a shape that does not cover the ranks."""
    mesh = mesh_lib.create_mesh(device="cpu")
    assert (mesh.n_data, mesh.n_model, mesh.rank) == (1, 1, 0)
    x = np.arange(8)
    np.testing.assert_array_equal(mesh_lib.shard_batch(mesh, x), x)
    assert mesh_lib.head_sharding(mesh, 12) == slice(0, 12)
    t = torch.arange(3.0)
    assert torch.equal(mesh_lib.replicated(mesh, t), torch.arange(3.0))
    with pytest.raises(ValueError, match="does not cover"):
        mesh_lib.create_mesh(n_data=2, device="cpu")
    m2 = mesh_lib.Mesh(n_data=2, n_model=2, rank=3, world_size=4,
                       data_index=1, model_index=1, data_group=None,
                       model_group=None, world_group=None,
                       device=torch.device("cpu"))
    assert mesh_lib.batch_sharding(m2, 8) == slice(4, 8)
    assert mesh_lib.head_sharding(m2, 13) == slice(7, 13)
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.batch_sharding(m2, 7)
    assert "WORLD_SIZE" in os.environ or not mesh_lib.under_torchrun()


# --------------------------------------------------------------------------
# the pretraining CLI under torchrun
# --------------------------------------------------------------------------
class _Shards:
    """A ``TorchBatchNorm.sync_group`` that sums over row shards of the
    batch in this process (``shard_summed_statistics``)."""

    def __init__(self, n: int):
        self.n = n


@contextlib.contextmanager
def shard_summed_statistics(n_shards: int):
    """Inside the block, every train-mode TorchBatchNorm of this process
    takes its statistics' sums (``local_sums``) over ``n_shards`` equal
    row shards of its batch and adds them shard after shard, as the
    all-reduce of a (n_shards, 1) mesh adds its ranks' sums: the
    single-process step with the mesh's summation order.  The rest of the
    layer (single-pass variance, running statistics, the bf16 fold) runs
    as it is."""
    forward = TorchBatchNorm.forward
    global_stats = TorchBatchNorm._global_stats

    def sharded_forward(self, x, sample_mask=None, leaky=False):
        if not self.training or self.sync_group is not None:
            return forward(self, x, sample_mask, leaky)
        self.sync_group = _Shards(n_shards)
        try:
            return forward(self, x, sample_mask, leaky)
        finally:
            self.sync_group = None

    def sharded_stats(self, xs, sample_mask):
        if not isinstance(self.sync_group, _Shards):
            return global_stats(self, xs, sample_mask)
        per = len(xs) // self.sync_group.n
        tot = None
        for k in range(self.sync_group.n):
            rows = slice(k * per, (k + 1) * per)
            part = self.local_sums(
                xs[rows], None if sample_mask is None else sample_mask[rows])
            tot = part if tot is None else tot + part
        return self.stats_of_sums(tot, xs.shape[1])

    TorchBatchNorm.forward = sharded_forward
    TorchBatchNorm._global_stats = sharded_stats
    try:
        yield
    finally:
        TorchBatchNorm.forward = forward
        TorchBatchNorm._global_stats = global_stats


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


def _cli_flags(tmp_path, save, epochs=1):
    return ["--model", "resnet12", "--no_dropblock", "--no_linear_bias",
            "--classifier", "linear", "--data_root", str(tmp_path / "data"),
            "--tb_path", str(tmp_path / "tb"), "--epochs", str(epochs),
            "--batch_size", "64", "--print_freq", "1", "--set_seed", "1",
            "--device", "cpu", "--model_path", str(tmp_path / save)]


def _torchrun(tmp_path, *target):
    """``torchrun --standalone --nproc_per_node 2`` (gloo on CPU ranks, a
    free port) of ``target``; returns its stdout."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS), PYTHONPATH=repo)
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *target],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def _single_process(tmp_path, *runs):
    """The CLI in this process at THREADS threads, for each (save,
    context, epochs) of ``runs``."""
    from subspace_reg_tpu_torch import train_supervised
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        for save, ctx, epochs in runs:
            with ctx:
                train_supervised.main(_cli_flags(tmp_path, save, epochs))
    finally:
        torch.set_num_threads(n)
    return {save: str(tmp_path / save / "resnet12_last.ckpt")
            for save, _, _ in runs}


def test_cli_under_torchrun_two_ranks(tmp_path):
    """``torchrun --nproc_per_node 2 -m ...train_supervised`` trains the
    pretraining CLI data-parallel: rank 0 alone prints and saves, and on
    random pixels one step of the global batch (64 images at 16 px, bf16
    as the CLI computes) updates the seeded initial weights (``--epochs
    0`` saves them) as the single-process CLI does: running statistics
    within rtol 1e-4 / atol 1e-5, each update's cosine >= 0.999 and norm
    within 1%; so does the single process with the mesh's summation order
    of the BN statistics."""
    write_one_step_split(str(tmp_path / "data" / "miniImageNet"), 16,
                         "random")
    out = _torchrun(tmp_path, "-m", "subspace_reg_tpu_torch.train_supervised",
                    *_cli_flags(tmp_path, "mesh"))
    assert "==> mesh 2x1 over 2 ranks (gloo)" in out
    assert out.count("==> Saved resnet12_last.ckpt") == 1
    assert out.count("Epoch: [1][0/1]") == 1
    ckpt = _single_process(
        tmp_path, ("plain", contextlib.nullcontext(), 1),
        ("shard_summed", shard_summed_statistics(2), 1),
        ("init", contextlib.nullcontext(), 0))
    for ref in ("plain", "shard_summed"):
        rep = cli_agreement(ckpt[ref], str(tmp_path / "mesh" /
                                           "resnet12_last.ckpt"),
                            ckpt["init"])
        assert rep["step"] == 1
        assert rep["ok"], (ref, rep)


def test_cli_under_torchrun_two_ranks_class_coloured(tmp_path):
    """On the class-coloured images (a colour a class plus noise, as every
    synthetic split draws them) the bf16 step is ill-conditioned in its
    batch statistics: conv outputs have a mean large against their spread,
    the single-pass variance E[x^2] - E[x]^2 cancels, and a change of the
    order in which the batch is summed moves the bf16-folded BN shift.
    Two ranks (``cli_rank``, the rank of chip_smoke.py's phase 15d), one
    step of 64 images at 16 px:

    * f32 (``f32_compute``): equal to the single-process f32 step at the
      tolerances of random pixels;
    * bf16: against the ordinary single process it reads update cosine
      ~0.973 and statistics ~51x their tolerance; against the single
      process that sums its statistics as the mesh does (two shards,
      added) it is held to the tolerances of random pixels, and against
      the f32 twin it is as accurate as the single process, within
      BF16_ACCURACY_MAX."""
    write_one_step_split(str(tmp_path / "data" / "miniImageNet"), 16,
                         "coloured")
    runs = [(_cli_flags(tmp_path, "mesh_bf16"), "bf16"),
            (_cli_flags(tmp_path, "mesh_f32"), "f32")]
    out = _torchrun(tmp_path, os.path.abspath(__file__), "--cli",
                    json.dumps(runs))
    assert out.count("==> mesh 2x1 over 2 ranks (gloo)") == 2
    ckpt = _single_process(
        tmp_path, ("plain_bf16", contextlib.nullcontext(), 1),
        ("shard_summed", shard_summed_statistics(2), 1),
        ("plain_f32", f32_compute(), 1),
        ("init", contextlib.nullcontext(), 0))
    mesh = {dt: str(tmp_path / f"mesh_{dt}" / "resnet12_last.ckpt")
            for dt in ("bf16", "f32")}
    rep = cli_agreement(ckpt["plain_f32"], mesh["f32"], ckpt["init"])
    assert rep["step"] == 1 and rep["ok"], rep
    rep = cli_agreement(ckpt["shard_summed"], mesh["bf16"], ckpt["init"])
    assert rep["step"] == 1 and rep["ok"], rep
    rep = bf16_readings(ckpt["plain_bf16"], mesh["bf16"], ckpt["plain_f32"],
                        ckpt["init"])
    assert rep["ok"], rep


if __name__ == "__main__":
    sys.exit(main())
