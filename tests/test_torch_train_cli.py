"""The port's pretraining CLI
(``python -m subspace_reg_tpu_torch.train_supervised``) for one epoch on the
CPU, on synthetic category-split miniImageNet (64 classes x 4 images,
16 px): the reference's printed lines, a saved ``.pth`` that the JAX
package's importer and the port's loader read, the metric log, and the
refusal of what is not ported."""

import json
import os

import numpy as np
import pytest
import torch

from subspace_reg_tpu.utils.torch_import import import_checkpoint
from subspace_reg_tpu_torch import train_supervised
from subspace_reg_tpu_torch.data import synthetic
from subspace_reg_tpu_torch.weights import load_checkpoint


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
    assert "==> Saved resnet18_last.pth" in out
    assert state.step == 4
    path = os.path.join(root, "save", "resnet18_last.pth")
    _, head, meta = import_checkpoint(path, device=False)
    assert meta["epoch"] == 1 and int(head.n_active) == 64
    sd, head_t, _ = load_checkpoint(path)
    assert tuple(head_t.weight.shape) == (64, 640) and head_t.bias is None
    assert all(torch.isfinite(v).all() for v in sd.values()
               if v.is_floating_point())
    with open(os.path.join(root, "tb", "miniImageNet_resnet18_classifier_"
                                       "linear", "metrics.jsonl")) as f:
        names = {json.loads(line)["name"] for line in f}
    assert {"train_acc", "train_loss", "test_acc", "test_acc_top5",
            "test_loss"} <= names
    assert np.isfinite(float(state.head["w"].abs().sum()))


@pytest.mark.parametrize("extra,match", [
    (["--reload_path", "x.pth"], "reload_path"),
    (["--distill", "kd"], "distill"),
    (["--dataset", "CIFAR-FS"], "CIFAR-FS"),
])
def test_unported_options_are_refused(root, extra, match):
    with pytest.raises(NotImplementedError, match=match):
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


def test_split_above_the_device_data_limit_is_refused(root, monkeypatch):
    """Below the split's size the CLI does not stage it (the default
    stages it: ``test_one_epoch_prints_saves_and_logs``); the host-streamed
    loader it would need is not ported."""
    monkeypatch.setenv("DEVICE_DATA_MAX_BYTES", "1")
    with pytest.raises(NotImplementedError, match="host-streamed"):
        train_supervised.main(_argv(root))
