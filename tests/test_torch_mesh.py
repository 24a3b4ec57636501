"""The port's mesh (subspace_reg_tpu_torch/parallel/mesh.py, on
torch.distributed with gloo) against the single-process step, at a narrow
resnet18 (widths 8/16/24/32, 16 px, global batch 8, drop rate 0.1 so the
global batch's dropout masks are checked too), as the JAX package holds
its mesh (tests/test_multichip_equiv.py): a sharded step equals the
single-device step on the same global batch.

The harness is tests/torch_support.py's, which chip_smoke.py's phases 15d
and 17 also run on the card: ``launch`` starts one process a rank (that
file run as a script: torch and the port only, a file store, a timeout on
every init, collective and join), each joins a process group, builds the
same seeded state and runs the configured scenarios; ``reference`` runs
the same steps in one process without a mesh.

Tolerances, those of test_multichip_equiv.py (``agreement``): loss rel
2e-5, BN running statistics rtol 1e-4 / atol 1e-5, each parameter
update's cosine >= 0.999 and norm within 1%.  Bit-identical: the ranks to
each other after 3 steps, world size 1 to no mesh, and the sharded
device-data gather to the sharded host batch.
"""

import contextlib
import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from subspace_reg_tpu_torch.models.layers import (TorchBatchNorm,
                                                  cross_replica)
from subspace_reg_tpu_torch.parallel import mesh as mesh_lib
from torch_support import (LOSS_RTOL, RANK_SCRIPT, REPO, SMALL, THREADS,
                           agreement, bf16_readings, cli_agreement,
                           f32_compute, launch, ranks_identical, reference,
                           write_one_step_split)

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


def _cli_flags(tmp_path, save, epochs=1):
    return ["--model", "resnet12", "--no_dropblock", "--no_linear_bias",
            "--classifier", "linear", "--data_root", str(tmp_path / "data"),
            "--tb_path", str(tmp_path / "tb"), "--epochs", str(epochs),
            "--batch_size", "64", "--print_freq", "1", "--set_seed", "1",
            "--device", "cpu", "--model_path", str(tmp_path / save)]


def _torchrun(tmp_path, *target):
    """``torchrun --standalone --nproc_per_node 2`` (gloo on CPU ranks, a
    free port) of ``target``; returns its stdout."""
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS), PYTHONPATH=REPO)
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
    out = _torchrun(tmp_path, RANK_SCRIPT, "--cli",
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

