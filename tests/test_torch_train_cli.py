"""The port's pretraining CLI
(``python -m subspace_reg_tpu_torch.train_supervised``) on the CPU, on
synthetic category-split miniImageNet (64 classes x 4 images, 16 px): the
reference's printed lines, a saved ``.ckpt`` that the JAX package's loader
and the port's read, the metric log, ``--reload_path`` (1 epoch, then a
resumed second, equals 2 epochs straight: atol 1e-6, as
tests/test_train_cli.py holds the JAX CLI; resuming across the packages is
``slow``), the host-streamed path (a split above
``DEVICE_DATA_MAX_BYTES``: bit-identical to the device-data run), the
other datasets (CIFAR-FS per-partition pickles at 32 px; tieredImageNet
with ``train_b`` pooled), and distillation under a (faked) two-rank
``torchrun``, which is no longer refused."""

import json
import os
import types

import numpy as np
import pytest
import torch

from subspace_reg_tpu.utils.checkpoint import load_checkpoint as jax_load
from subspace_reg_tpu_torch import train_supervised
from subspace_reg_tpu_torch.data import synthetic
from subspace_reg_tpu_torch.utils.checkpoint import load_checkpoint
from subspace_reg_tpu_torch.weights import from_jax_variables


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pretrain_cli"))
    synthetic.make_mini_imagenet_category_split(
        os.path.join(root, "data", "miniImageNet"), per_class=4,
        img_size=16, seed=0)
    return root


def _argv(root, *extra):
    return ["--model", "resnet18", "--no_dropblock", "--no_linear_bias",
            "--classifier", "linear", "--data_root",
            os.path.join(root, "data"), "--model_path",
            os.path.join(root, "save"), "--tb_path",
            os.path.join(root, "tb"), "--epochs", "1", "--batch_size", "64",
            "--print_freq", "1", "--set_seed", "1", "--device", "cpu",
            *extra]


def test_one_epoch_prints_saves_and_logs(root, capsys):
    state = train_supervised.main(_argv(root))
    out = capsys.readouterr().out
    for i in range(4):                  # 256 images / batch 64
        assert f"Epoch: [1][{i}/4]\tLoss " in out
    assert "Acc@1" in out and " * Val Acc@1 " in out
    assert "==> Saved resnet18_last.ckpt" in out
    assert state.step == 4
    path = os.path.join(root, "save", "resnet18_last.ckpt")
    jvars, head, meta = jax_load(path, device=False)
    assert meta["epoch"] == 1 and int(head.n_active) == 64
    assert int(meta["extra"]["step"]) == 4
    variables, head_t, meta_t = load_checkpoint(path)
    assert tuple(head_t.weight.shape) == (64, 640) and head_t.bias is None
    np.testing.assert_array_equal(head_t.weight, np.asarray(head.weight))
    sd = from_jax_variables(variables)
    assert all(torch.isfinite(v).all() for v in sd.values()
               if v.is_floating_point())
    assert torch.equal(sd["layer4.1.conv3.weight"],
                       state.backbone.state_dict()["layer4.1.conv3.weight"])
    with open(os.path.join(root, "tb", "miniImageNet_resnet18_classifier_"
                                       "linear", "metrics.jsonl")) as f:
        names = {json.loads(line)["name"] for line in f}
    assert {"train_acc", "train_loss", "test_acc", "test_acc_top5",
            "test_loss"} <= names
    assert np.isfinite(float(state.head["w"].abs().sum()))


@pytest.mark.parametrize("extra,match", [
    (["--distill", "kd"], "requires --teacher_path"),
])
def test_unported_options_are_refused(root, extra, match, monkeypatch):
    """Distillation on a mesh of more than one rank (JAX
    train_supervised.py:221-235) is served now: under ``torchrun`` with
    two ranks the CLI no longer refuses ``--distill kd`` for the mesh; it
    prints the mesh, loads the data and stops only where a single process
    stops too, at the missing ``--teacher_path``.  The two-rank runs:
    tests/test_torch_mesh_distill.py."""
    monkeypatch.setattr(train_supervised.mesh_lib, "under_torchrun",
                        lambda: True)
    monkeypatch.setattr(train_supervised.mesh_lib, "init_distributed",
                        lambda dev: torch.device(dev))
    monkeypatch.setattr(train_supervised.mesh_lib, "create_mesh",
                        lambda **kw: types.SimpleNamespace(
                            world_size=2, rank=0, n_data=2, n_model=1,
                            data_index=0))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    with pytest.raises(ValueError, match=match):
        train_supervised.main(_argv(root, *extra))


def test_cuda_request_without_card_raises(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(root)
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train_supervised.main(argv)


@pytest.mark.parametrize("limit,want", [(None, 2 * 1024 ** 3),
                                         ("123456", 123456)])
def test_device_data_limit_follows_the_environment(monkeypatch, limit, want):
    """``DEVICE_DATA_MAX_BYTES`` sets the largest split staged on the
    device, with the JAX CLI's default and parsing
    (train_supervised.py:269-270)."""
    if limit is None:
        monkeypatch.delenv("DEVICE_DATA_MAX_BYTES", raising=False)
    else:
        monkeypatch.setenv("DEVICE_DATA_MAX_BYTES", limit)
    assert train_supervised.device_data_max_bytes() == want


def test_split_above_the_device_data_limit_is_refused(root, monkeypatch,
                                                      capsys):
    """Below the split's size the CLI does not stage it (the default
    stages it: ``test_one_epoch_prints_saves_and_logs``): it streams the
    split from the host (``PrefetchLoader``), and the streamed run is
    bit-identical to the device-data run (``DEVICE_DATA_MAX_BYTES=0``,
    as the JAX CLI's branch, train_supervised.py:271,320-326)."""
    def run(save):
        return train_supervised.main(_argv(root, "--model_path",
                                           os.path.join(root, save)))
    staged = run("staged")
    assert "==> staging dataset on cpu" in capsys.readouterr().out
    monkeypatch.setenv("DEVICE_DATA_MAX_BYTES", "0")
    streamed = run("streamed")
    out = capsys.readouterr().out
    assert "==> streaming dataset from the host" in out
    assert "loader: mean wait for a batch" in out
    assert streamed.step == staged.step == 4
    _assert_same_run(_final(staged), _final(streamed), atol=0)
    for p, q in zip(staged.optimizer.param_groups[0]["params"],
                    streamed.optimizer.param_groups[0]["params"]):
        assert torch.equal(staged.optimizer.state[p]["momentum_buffer"],
                           streamed.optimizer.state[q]["momentum_buffer"])


def _final(state):
    out = {k: v.detach().clone() for k, v in
           state.backbone.state_dict().items()}
    out.update({f"head.{k}": v.detach().clone()
                for k, v in state.head.items()})
    return out


def _assert_same_run(a, b, atol=1e-6):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=atol, msg=k)


def test_resume_reproduces_the_uninterrupted_run(root, capsys):
    """2 epochs straight against 1 epoch, then ``--reload_path`` from its
    ``resnet18_last.ckpt`` for the second: the same steps, weights,
    statistics, counters and momentum (the shuffle of the skipped epoch
    consumed, the per-step draws keyed by the restored step)."""
    def run(save, epochs, *extra):
        return train_supervised.main(_argv(root, "--model_path",
                                           os.path.join(root, save),
                                           "--epochs", str(epochs), *extra))
    straight = run("straight", 2)
    run("first", 1)
    resumed = run("resumed", 2, "--reload_path",
                  os.path.join(root, "first", "resnet18_last.ckpt"))
    assert "==> resumed from" in capsys.readouterr().out
    assert resumed.step == straight.step == 8
    _assert_same_run(_final(straight), _final(resumed))
    for p, q in zip(straight.optimizer.param_groups[0]["params"],
                    resumed.optimizer.param_groups[0]["params"]):
        torch.testing.assert_close(
            resumed.optimizer.state[q]["momentum_buffer"],
            straight.optimizer.state[p]["momentum_buffer"], rtol=0,
            atol=1e-6)


def test_cifar_fs_per_partition_pretraining(tmp_path):
    """CIFAR-FS without --continual: the per-partition pickles (sparse
    labels remapped), transform D at 32 px, resnet12 with DropBlock 2."""
    synthetic.make_cifar(str(tmp_path / "data" / "CIFAR-FS"), n_classes=12,
                         per_class=8, sparse_labels=True)
    argv = _argv(str(tmp_path), "--dataset", "CIFAR-FS", "--model",
                 "resnet12", "--batch_size", "16", "--epochs", "1")
    state = train_supervised.main(argv)
    assert state.step == 2 and tuple(state.head["w"].shape) == (4, 640)
    _, head, meta = load_checkpoint(str(tmp_path / "save" /
                                        "resnet12_last.ckpt"))
    assert meta["epoch"] == 1 and head.n_active == 4


def test_tiered_pretraining_pools_train_b(tmp_path, capsys):
    """tieredImageNet with --augment_pretrain_wtrainb: train_a and train_b
    pooled, the 351-class head, validation over the first 200 logits."""
    synthetic.make_tiered(str(tmp_path / "data" / "tieredImageNet"),
                          n_classes=8, per_class=4, img_size=16)
    argv = _argv(str(tmp_path), "--dataset", "tieredImageNet",
                 "--augment_pretrain_wtrainb", "--batch_size", "16")
    state = train_supervised.main(argv)
    assert state.step == 3                      # (32 + 16) images / 16
    assert tuple(state.head["w"].shape) == (351, 640)
    assert "==> Saved resnet18_last.ckpt" in capsys.readouterr().out


@pytest.mark.slow
def test_resume_across_the_packages(root, tmp_path):
    """A JAX-CLI ``.ckpt`` resumes in the port's CLI, and a port ``.ckpt``
    in the JAX CLI: each resumed run starts at the saved epoch and step
    and takes the second epoch's steps (the two packages' f32 steps
    differ at rounding, so the weights are not compared)."""
    import train_supervised as jax_cli
    base = ["--model", "resnet18", "--no_dropblock", "--no_linear_bias",
            "--classifier", "linear", "--data_root",
            os.path.join(root, "data"), "--tb_path", str(tmp_path / "tb"),
            "--batch_size", "64", "--print_freq", "1", "--set_seed", "1"]
    jax_cli.main(base + ["--model_path", str(tmp_path / "jax1"),
                         "--epochs", "1"])
    state = train_supervised.main(base + [
        "--model_path", str(tmp_path / "port2"), "--epochs", "2",
        "--device", "cpu", "--reload_path",
        str(tmp_path / "jax1" / "resnet18_last.ckpt")])
    assert state.step == 8
    train_supervised.main(base + ["--model_path", str(tmp_path / "port1"),
                                  "--epochs", "1", "--device", "cpu"])
    js = jax_cli.main(base + [
        "--model_path", str(tmp_path / "jax2"), "--epochs", "2",
        "--reload_path", str(tmp_path / "port1" / "resnet18_last.ckpt")])
    assert int(js.step) == 8
