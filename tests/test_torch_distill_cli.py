"""The port's pretraining CLI with distillation (``python -m
subspace_reg_tpu_torch.train_supervised --distill kd|nce|crd``) on the CPU,
on synthetic category-split miniImageNet (64 classes x 4 images, 16 px)
with a seeded full-width resnet18 teacher ``.ckpt``: the JAX CLI's printed
lines, the saved contrastive state, the KD class-count refusal (also
under a two-rank torchrun, which replicates the contrastive state),
2 epochs straight against 1 and a resumed second, and the host-streamed
contrastive run (a split above ``DEVICE_DATA_MAX_BYTES``, through
``PrefetchLoader`` with each batch's items) against the
device-data run, both bit for bit in every leaf of the ``.ckpt``
(weights, statistics, counters, optimizer state, embed heads, banks, Z).
"""

import os
import shutil
import types

import numpy as np
import pytest
import torch

from subspace_reg_tpu_torch import train_supervised
from subspace_reg_tpu_torch.data import synthetic
from torch_support import ckpt_diff, ckpt_leaves, seeded_ckpt

NCE_K, FEAT, N_CLS = 16, 8, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for this module: the tier-1 lane runs six
    test processes at once, and their default thread pools (one thread per
    core each) oversubscribe the host by far more than these small
    operands gain from threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("distill_cli"))
    synthetic.make_mini_imagenet_category_split(
        os.path.join(root, "data", "miniImageNet"), per_class=4,
        img_size=16, seed=0)
    seeded_ckpt(os.path.join(root, "teacher.ckpt"), "resnet18", 64)
    seeded_ckpt(os.path.join(root, "teacher10.ckpt"), "resnet18", 10)
    yield root
    # each full-width .ckpt with its optimizer state is ~100 MB
    shutil.rmtree(root, ignore_errors=True)


def _drop(root, *saves):
    for save in saves:
        shutil.rmtree(os.path.join(root, save), ignore_errors=True)


def _argv(root, save, distill, *extra, teacher="teacher.ckpt"):
    return ["--model", "resnet18", "--no_dropblock", "--no_linear_bias",
            "--classifier", "linear", "--data_root",
            os.path.join(root, "data"), "--model_path",
            os.path.join(root, save), "--tb_path", os.path.join(root, "tb"),
            "--epochs", "1", "--batch_size", "64", "--print_freq", "1",
            "--set_seed", "1", "--device", "cpu", "--distill", distill,
            "--teacher_path", os.path.join(root, teacher), "--nce_k",
            str(NCE_K), "--feat_dim", str(FEAT), *extra]


@pytest.fixture(scope="module")
def nce_one_epoch(cli_root):
    train_supervised.main(_argv(cli_root, "nce1", "nce"))
    return os.path.join(cli_root, "nce1", "resnet18_last.ckpt")


@pytest.mark.parametrize("distill", ["kd", "nce", "crd"])
def test_cli_distillation_trains_and_saves(cli_root, capsys, distill,
                                           request):
    if distill == "nce":
        path = request.getfixturevalue("nce_one_epoch")
        out = ""
    else:
        state = train_supervised.main(_argv(cli_root, distill, distill))
        assert state.step == 4
        out = capsys.readouterr().out
        path = os.path.join(cli_root, distill, "resnet18_last.ckpt")
    if distill == "kd":
        assert ("==> KD teacher: resnet18 (64 classes), T=4.0 alpha=1.0 "
                "beta=1.0") in out
    elif distill == "crd":
        assert ("==> CRD teacher: resnet18, feat_dim=8 K=16 T=0.07 m=0.5 "
                "alpha=1.0 beta=1.0") in out
    if out:
        assert "Epoch: [1][3/4]\tLoss " in out
        assert "==> Saved resnet18_last.ckpt" in out
    leaves = ckpt_leaves(path)
    assert all(np.isfinite(np.asarray(v, np.float64)).all()
               for v in leaves.values())
    contrastive = distill != "kd"
    assert ("extra/nce/memory_l" in leaves) == contrastive
    if contrastive:
        assert leaves["extra/nce/memory_l"].shape == (256, FEAT)
        assert leaves["extra/embed_s/linear/kernel"].shape == (640, FEAT)
        assert float(leaves["extra/nce/z_l"]) > 0
        assert "extra/opt_state/1/trace/embed_t/linear/kernel" in leaves
    if distill != "nce":
        _drop(cli_root, distill)


def test_cli_refuses_kd_class_mismatch_and_a_mesh(cli_root, monkeypatch):
    with pytest.raises(ValueError, match="same classes: teacher head has "
                       "10, this run trains 64"):
        train_supervised.main(_argv(cli_root, "kd10", "kd",
                                    teacher="teacher10.ckpt"))
    # a (faked) two-rank torchrun no longer refuses distillation: KD meets
    # the single process's class check, and a contrastive run replicates
    # rank 0's backbone, head, embed heads and banks to every rank (the
    # two-rank runs themselves: tests/test_torch_mesh_distill.py)
    mesh = types.SimpleNamespace(world_size=2, rank=0, n_data=2, n_model=1,
                                 data_index=0)
    monkeypatch.setattr(train_supervised.mesh_lib, "under_torchrun",
                        lambda: True)
    monkeypatch.setattr(train_supervised.mesh_lib, "init_distributed",
                        lambda dev: torch.device(dev))
    monkeypatch.setattr(train_supervised.mesh_lib, "create_mesh",
                        lambda **kw: mesh)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")

    class Replicated(Exception):
        pass

    trees = []

    def replicate(mesh_, tree):
        trees.append(tree)
        if len(trees) == 3:
            raise Replicated
        return tree

    monkeypatch.setattr(train_supervised.mesh_lib, "replicate_tree",
                        replicate)
    with pytest.raises(ValueError, match="same classes: teacher head has "
                       "10, this run trains 64"):
        train_supervised.main(_argv(cli_root, "mesh", "kd",
                                    teacher="teacher10.ckpt"))
    with pytest.raises(Replicated):
        train_supervised.main(_argv(cli_root, "mesh", "nce"))
    from subspace_reg_tpu_torch.distill.embed import Embed
    backbone, head, contrastive = trees
    assert isinstance(backbone, torch.nn.Module) and set(head) == {"w"}
    assert [type(t) for t in contrastive[:2]] == [Embed, Embed]
    assert [tuple(t.shape) for t in contrastive[2:4]] == [(64 * 4, FEAT)] * 2
    assert len(contrastive) == 7


def test_cli_contrastive_resume_is_bit_identical(cli_root, nce_one_epoch,
                                                 capsys):
    """2 epochs straight against 1 epoch, then ``--reload_path`` for the
    second: every leaf of the final ``.ckpt`` (weights, statistics,
    counters, optimizer state, embed heads, banks, Z) bit-identical."""
    train_supervised.main(_argv(cli_root, "nce2", "nce", "--epochs", "2"))
    train_supervised.main(_argv(cli_root, "nce_resumed", "nce", "--epochs",
                                "2", "--reload_path", nce_one_epoch))
    out = capsys.readouterr().out
    assert "==> resumed contrastive state" in out
    diff, same = ckpt_diff(
        os.path.join(cli_root, "nce2", "resnet18_last.ckpt"),
        os.path.join(cli_root, "nce_resumed", "resnet18_last.ckpt"))
    assert same, diff
    diff, same = ckpt_diff(
        nce_one_epoch, os.path.join(cli_root, "nce2", "resnet18_last.ckpt"))
    assert not same
    _drop(cli_root, "nce2", "nce_resumed")


def test_cli_host_gathered_contrastive_equals_device_data(
        cli_root, nce_one_epoch, monkeypatch, capsys):
    monkeypatch.setenv("DEVICE_DATA_MAX_BYTES", "0")
    train_supervised.main(_argv(cli_root, "nce_host", "nce"))
    assert ("==> streaming dataset from the host"
            in capsys.readouterr().out)
    diff, same = ckpt_diff(
        nce_one_epoch, os.path.join(cli_root, "nce_host",
                                    "resnet18_last.ckpt"))
    _drop(cli_root, "nce_host")
    assert same, diff
