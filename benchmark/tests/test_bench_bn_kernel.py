"""pretrain.bn_kernel_pct's reader on the program's BatchNorm counters: the
share of train-mode forwards that ran as K5, and None where the program
has no such counter or counted nothing."""

import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the checkout on the path)
from benchmark import harness


def test_bn_kernel_pct_reads_the_counters(monkeypatch):
    from subspace_reg_tpu_torch.models.layers import TorchBatchNorm
    read = harness.metric_reader("pretrain.bn_kernel_pct").read
    monkeypatch.setattr(TorchBatchNorm, "train_forwards", 880)
    monkeypatch.setattr(TorchBatchNorm, "kernel_forwards", 660)
    assert read({}) == pytest.approx(75.0, rel=1e-15)
    monkeypatch.setattr(TorchBatchNorm, "train_forwards", 0)
    assert read({}) is None
    monkeypatch.delattr(TorchBatchNorm, "train_forwards")
    monkeypatch.delattr(TorchBatchNorm, "kernel_forwards")
    assert read({}) is None


def test_bn_kernel_pct_in_a_traced_pretraining_run_on_the_cpu(monkeypatch):
    """On the CPU every BatchNorm keeps its ops: the metric reads 0 (the
    counters start at 0, as in the run's own process)."""
    from bench_tiny import run
    from subspace_reg_tpu_torch.models.layers import TorchBatchNorm
    monkeypatch.setattr(TorchBatchNorm, "train_forwards", 0)
    monkeypatch.setattr(TorchBatchNorm, "kernel_forwards", 0)
    out = run("pretrain-mini84", trace=True)
    assert out["correct"]
    assert out["metrics"]["pretrain.bn_kernel_pct"]["value"] == 0.0
