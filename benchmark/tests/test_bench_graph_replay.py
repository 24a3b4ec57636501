"""pretrain.graph_replay_pct's reader on the program's step counters: the
share of pretraining steps replayed as a CUDA graph, and None where the
program has no such counter or counted nothing."""

import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the checkout on the path)
from benchmark import harness


def test_graph_replay_pct_reads_the_counters(monkeypatch):
    from subspace_reg_tpu_torch.engine.pretrain import StepRunner
    read = harness.metric_reader("pretrain.graph_replay_pct").read
    monkeypatch.setattr(StepRunner, "graph_steps", 1800)
    monkeypatch.setattr(StepRunner, "graph_replays", 1798)
    assert read({}) == pytest.approx(100.0 * 1798 / 1800, rel=1e-15)
    monkeypatch.setattr(StepRunner, "graph_steps", 0)
    assert read({}) is None
    monkeypatch.delattr(StepRunner, "graph_steps")
    monkeypatch.delattr(StepRunner, "graph_replays")
    assert read({}) is None


def test_graph_replay_pct_in_a_traced_pretraining_run_on_the_cpu(
        monkeypatch):
    """On the CPU no step replays a graph: the metric reads 0 (the
    counters start at 0, as in the run's own process)."""
    from bench_tiny import run
    from subspace_reg_tpu_torch.engine.pretrain import StepRunner
    monkeypatch.setattr(StepRunner, "graph_steps", 0)
    monkeypatch.setattr(StepRunner, "graph_replays", 0)
    out = run("pretrain-mini84", trace=True)
    assert out["correct"]
    assert StepRunner.graph_steps > 0
    assert out["metrics"]["pretrain.graph_replay_pct"]["value"] == 0.0
