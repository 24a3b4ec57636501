"""Distillation pretraining on a data mesh of two gloo ranks against the
single process on the global batch: the KD step (module and fused paths)
and the contrastive steps NCE and CRD (engine/pretrain.py::
make_train_step_nce with distill/nce.py's global-batch bank update), with
the mesh harness of tests/torch_support.py, at its narrow resnet18 (widths
8/16/24/32, 16 px, global batch 8, drop rate 0.1, f32), a seeded teacher
of the same geometry, 8-d embeddings, 16 negatives over 64 items; every
rank and the single process start from the JAX package's initial
student, embed heads and banks, carried as numpy (``NCEAverageState.
from_jax`` for the banks).

Held at the harness's tolerances (loss rtol 2e-5, statistics
rtol 1e-4 / atol 1e-5, update cosine >= 0.999, norm within 1%): one step
of each; after two contrastive steps the memory banks bit-identical
across the ranks (every rank applies the global batch's update, as the
JAX mesh's replicated banks take the global scatter:
tests/test_multichip_equiv.py's sharded NCE step) and within the
statistics' tolerances of the single process; Z set from the global
batch.  Then the pretraining CLI with ``--distill kd`` and ``--distill
nce`` under ``torchrun --nproc_per_node 2`` (gloo) for one step, against
the single-process CLI, and a two-phase ``--reload_path`` resume under
``torchrun`` equal to the straight run."""

import contextlib
import json

import pytest
import torch

import test_torch_mesh as mh
from test_torch_mesh_fused import jax_initial_state
from torch_support import (LOSS_RTOL, RANK_SCRIPT, SMALL, THREADS,
                           agreement, cli_agreement, f32_compute, launch,
                           ranks_identical, reference, stats_excess,
                           write_one_step_split)

SCENARIOS = [
    dict(name="kd", kind="kd", n_data=2, n_model=1, steps=1,
         mode="streamed"),
    dict(name="kd_fused", kind="kd", fused=True, backend="pallas",
         n_data=2, n_model=1, steps=1, mode="device_data"),
    dict(name="nce", kind="nce", n_data=2, n_model=1, steps=1,
         mode="device_data"),
    dict(name="crd", kind="crd", n_data=2, n_model=1, steps=1,
         mode="streamed"),
    dict(name="nce_two", kind="nce", n_data=2, n_model=1, steps=2,
         mode="streamed"),
    dict(name="crd_two", kind="crd", n_data=2, n_model=1, steps=2,
         mode="device_data"),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_distill")
    cfg = dict(SMALL, device="cpu", scenarios=SCENARIOS, timeout_s=90.0)
    cfg["init_state"] = jax_initial_state(cfg, str(work / "init.pickle"),
                                          contrastive=True)
    ranks = launch(cfg, 2, str(work))
    return ranks, reference(cfg)


@pytest.mark.parametrize("name", ["kd", "kd_fused", "nce", "crd"])
def test_distill_step_on_two_ranks_equals_single_process(runs, name):
    """One step on two ranks equals the single-process step on the global
    batch (the teacher on the rank's rows; KD's and the contrast's means
    averaged by the gradient all-reduce), and the ranks stay
    bit-identical (the embed heads and banks included)."""
    ranks, ref = runs
    for r in ranks:
        rep = agreement(ref[name], r[name])
        assert rep["ok"], rep
        for k in ("ce", "contrast", "acc1"):
            if k in ref[name]["metrics"][0]:
                assert r[name]["metrics"][0][k] == pytest.approx(
                    ref[name]["metrics"][0][k], rel=LOSS_RTOL, abs=1e-6)
    assert ranks_identical(ranks, name)


@pytest.mark.parametrize("name", ["nce_two", "crd_two"])
def test_banks_after_two_steps(runs, name):
    """After two steps every rank's banks (and Z) equal the others' bit for
    bit, and the single process's within the statistics' tolerances; the
    rest of the state as the one step's check holds it."""
    ranks, ref = runs
    assert ranks_identical(ranks, name)
    banks = ("nce.memory_l", "nce.memory_ab", "nce.z_l", "nce.z_ab")
    want = [ref[name]["final"][k] for k in banks]
    for r in ranks:
        got = [r[name]["final"][k] for k in banks]
        assert stats_excess(want, got) <= 1.0
        # the banks moved: the items of both steps were written
        assert not torch.equal(r[name]["final"]["nce.memory_l"],
                               r[name]["init"]["nce.memory_l"])
        assert agreement(ref[name], r[name])["loss_rel"] <= LOSS_RTOL


@pytest.mark.parametrize("name", ["nce", "crd"])
def test_z_is_set_from_the_global_batch(runs, name):
    """The first step sets Z from the global batch's mean: both ranks read
    the single process's Z (a rank-local mean differs between the ranks
    by far more), and it stays set on the second step."""
    ranks, ref = runs
    (zl, zab), = ref[name]["z"]
    for r in ranks:
        (gl, gab), = r[name]["z"]
        assert gl == pytest.approx(zl, rel=LOSS_RTOL)
        assert gab == pytest.approx(zab, rel=LOSS_RTOL)
    assert ranks[0][name]["z"] == ranks[1][name]["z"]
    two = ranks[0][name + "_two"]["z"]
    assert two[0] == two[1] and two[0][0] > 0


# --------------------------------------------------------------------------
# the pretraining CLI under torchrun
# --------------------------------------------------------------------------
def _flags(tmp_path, save, *extra, epochs=1):
    return mh._cli_flags(tmp_path, save, epochs) + [
        "--teacher_path", str(tmp_path / "init" / "resnet12_last.ckpt"),
        "--nce_k", "16", "--feat_dim", "8", *extra]


def test_cli_distill_under_torchrun(tmp_path, monkeypatch):
    """``torchrun --nproc_per_node 2`` (gloo) of the CLI in f32
    (``f32_compute``) with ``--distill kd`` and ``--distill nce`` (the
    teacher: the seeded initial weights, ``--epochs 0``) on 64 random
    images at 16 px, one step of the global batch, against the
    single-process CLI at the harness's tolerances; then ``--distill nce``
    for 2 epochs straight, and 1 epoch resumed to 2 through
    ``--reload_path``, both under torchrun: the resumed run equals the
    straight one bit for bit (banks, embed heads and optimizer state
    carried by the ``.ckpt``).  Streamed from the host
    (``DEVICE_DATA_MAX_BYTES=0``: each rank's loader yields its rows and
    their items) the ``--distill nce`` epoch equals the staged one bit for
    bit."""
    from subspace_reg_tpu_torch.utils.checkpoint import load_checkpoint
    write_one_step_split(str(tmp_path / "data" / "miniImageNet"), 16,
                            "random")
    ckpt = mh._single_process(tmp_path,
                              ("init", contextlib.nullcontext(), 0))
    resume = str(tmp_path / "mesh_nce" / "resnet12_last.ckpt")
    runs = [(_flags(tmp_path, "mesh_kd", "--distill", "kd"), "f32"),
            (_flags(tmp_path, "mesh_nce", "--distill", "nce"), "f32"),
            (_flags(tmp_path, "mesh_nce2", "--distill", "nce", epochs=2),
             "f32"),
            (_flags(tmp_path, "mesh_resumed", "--distill", "nce",
                    "--reload_path", resume, epochs=2), "f32")]
    out = mh._torchrun(tmp_path, RANK_SCRIPT, "--cli", json.dumps(runs))
    assert out.count("==> mesh 2x1 over 2 ranks (gloo)") == len(runs)
    assert out.count("==> resumed contrastive state") == 1
    monkeypatch.setenv("DEVICE_DATA_MAX_BYTES", "0")
    streamed = [(_flags(tmp_path, "mesh_streamed", "--distill", "nce"),
                 "f32")]
    out = mh._torchrun(tmp_path, RANK_SCRIPT, "--cli", json.dumps(streamed))
    assert "==> streaming dataset from the host" in out
    monkeypatch.delenv("DEVICE_DATA_MAX_BYTES")
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        from subspace_reg_tpu_torch import train_supervised
        for name in ("kd", "nce"):
            with f32_compute():
                train_supervised.main(_flags(tmp_path, f"plain_{name}",
                                             "--distill", name))
    finally:
        torch.set_num_threads(n)
    path = lambda d: str(tmp_path / d / "resnet12_last.ckpt")  # noqa
    for name in ("kd", "nce"):
        rep = cli_agreement(path(f"plain_{name}"), path(f"mesh_{name}"),
                               ckpt["init"])
        assert rep["step"] == 1 and rep["ok"], (name, rep)
    flat = lambda t, p="": ([(p, t)] if not isinstance(t, dict) else [  # noqa
        kv for k in sorted(t) for kv in flat(t[k], f"{p}/{k}")])
    for one, two in (("mesh_nce2", "mesh_resumed"),
                     ("mesh_nce", "mesh_streamed")):
        a, b = (load_checkpoint(path(d)) for d in (one, two))
        assert set(a[2]["extra"]) >= {"embed_s", "embed_t", "nce",
                                      "opt_state"}
        assert int(a[2]["extra"]["step"]) == int(one.endswith("2")) + 1
        assert (a[1].weight == b[1].weight).all()
        for ta, tb in ((a[0], b[0]), (a[2]["extra"], b[2]["extra"])):
            fa, fb = flat(ta), flat(tb)
            assert [k for k, _ in fa] == [k for k, _ in fb]
            for (k, x), (_, y) in zip(fa, fb):
                assert (x == y).all(), (one, two, k)
