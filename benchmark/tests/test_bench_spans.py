"""The readers of the program's ranges and counters (benchmark/spans.py and
its per-layer metrics) on hand-built traces: the device's idle time and
the host's launches are attributed to the ranges exactly, and a trace or
a program without them gives None, not 0."""

import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the checkout on the path)
from benchmark import harness, spans
from benchmark.harness import Trace


def _reader(name):
    return harness.metric_reader(name).read


def _eval_trace(with_spans=True):
    """A 100-ns window: the device busy over [10, 20) and [50, 60); the
    setup range [0, 30) with its upload [5, 15) inside, a begin [40, 55),
    a finish [90, 120) that outlasts the window, a sampler [60, 80) and a
    range the readers do not ask for over everything."""
    device = [("kernel_a", 10, 20), ("Memcpy HtoD", 50, 60)]
    host = [("bench.window", 0, 100), ("aten::add", 0, 100)]
    if with_spans:
        host += [("srt.eval.setup", 0, 30), ("srt.eval.upload", 5, 15),
                 ("srt.eval.begin", 40, 55), ("srt.eval.finish", 90, 120),
                 ("srt.data.sampler", 60, 80), ("srt.eval.k1", 0, 100)]
    return Trace(device=device, host=host, span=(0, 100))


def test_idle_intervals():
    assert spans.idle_intervals(_eval_trace()) == [(0, 10), (20, 50),
                                                   (60, 100)]


@pytest.mark.parametrize("names,ns", [
    (("srt.eval.setup",), 20), (("srt.eval.upload",), 5),
    (("srt.eval.setup", "srt.eval.upload"), 20),
    (("srt.eval.begin",), 10), (("srt.eval.finish",), 10),
    (("srt.data.sampler",), 20), (("srt.eval.k1",), 80)])
def test_idle_attribution_is_exact(names, ns):
    assert spans.idle_in_s(_eval_trace(), names) == pytest.approx(ns * 1e-9,
                                                                  abs=0)


@pytest.mark.parametrize("metric,ns", [
    ("eval.host_loop_idle_ms_per_seed", 40),
    ("eval.sampler_idle_ms_per_seed", 20)])
def test_eval_idle_readers(metric, ns):
    rec = {"traces": [_eval_trace()], "runs": 2}
    assert _reader(metric)(rec) == pytest.approx(ns * 1e-6 / 2, rel=1e-12)


@pytest.mark.parametrize("metric", ["eval.host_loop_idle_ms_per_seed",
                                    "eval.sampler_idle_ms_per_seed"])
def test_eval_idle_readers_without_ranges_read_none(metric):
    assert _reader(metric)({"traces": [_eval_trace(False)],
                            "runs": 2}) is None
    assert _reader(metric)({"traces": [], "runs": 2}) is None


def _step_trace(with_spans=True, host_window_s=None):
    """Two steps.  Launch records (cudaLaunch* and cuLaunch*) fall in each
    phase and are counted by time alone, as the backward's, which come
    from the autograd engine's thread, must be; a copy, and a launch at a
    range's end, are not counted there."""
    device = [("k", 0, 1)]
    host = [("bench.window", 0, 1000)]
    for base in (0, 500):
        if with_spans:
            host += [("srt.pretrain.gather", base + 0, base + 10),
                     ("srt.pretrain.augment", base + 10, base + 50),
                     ("srt.pretrain.forward", base + 50, base + 200),
                     ("srt.pretrain.backward", base + 200, base + 400),
                     ("srt.pretrain.optimizer", base + 400, base + 450)]
        host += [("cudaLaunchKernel", base + 2, base + 3),
                 ("cudaLaunchKernel", base + 20, base + 21),
                 ("cudaMemcpyAsync", base + 30, base + 31),
                 ("cuLaunchKernelEx", base + 60, base + 61),
                 ("cudaLaunchKernel", base + 70, base + 71),
                 ("cudaLaunchKernelExC", base + 80, base + 81),
                 ("cudaLaunchKernel", base + 210, base + 211),
                 ("cudaLaunchKernel", base + 300, base + 301),
                 ("cudaLaunchKernel", base + 301, base + 302),
                 ("cudaLaunchKernel", base + 400, base + 401),
                 ("cudaLaunchKernel", base + 449, base + 450),
                 ("cudaLaunchKernel", base + 450, base + 451)]
    return Trace(device=device, host=host, span=(0, 1000),
                 host_window_s=host_window_s)


@pytest.mark.parametrize("metric,per_step", [
    ("pretrain.augment_launches_per_step", 2),
    ("pretrain.forward_launches_per_step", 3),
    ("pretrain.backward_launches_per_step", 3),
    ("pretrain.optimizer_launches_per_step", 2)])
def test_launch_counts_are_exact(metric, per_step):
    # the device-alone trace comes first, as the job records them
    rec = {"traces": [_step_trace(host_window_s=1.0), _step_trace()]}
    assert _reader(metric)(rec) == per_step


@pytest.mark.parametrize("metric", [
    "pretrain.augment_launches_per_step", "pretrain.forward_launches_per_step",
    "pretrain.backward_launches_per_step",
    "pretrain.optimizer_launches_per_step"])
def test_launch_readers_without_ranges_read_none(metric):
    assert _reader(metric)({"traces": [_step_trace(False)]}) is None
    assert _reader(metric)({"traces": [_step_trace(host_window_s=1.0)]}) \
        is None


def test_launches_in_a_trace_without_the_ranges():
    assert spans.launches_in(_step_trace(False), ("srt.pretrain.forward",)) \
        is None
    assert spans.launches_in(_step_trace(), ("srt.nothing",)) is None
    assert spans.launches_in(_step_trace(), ("srt.pretrain.gather",)) == 2


def test_padded_row_pct_reads_the_counters(monkeypatch):
    from subspace_reg_tpu_torch.engine.incremental import SessionProgram
    read = _reader("eval.padded_row_pct")
    monkeypatch.setattr(SessionProgram, "rows_forwarded", 19460)
    monkeypatch.setattr(SessionProgram, "rows_padded", 1600)
    assert read({}) == pytest.approx(100 * 1600 / 19460, rel=1e-15)
    monkeypatch.setattr(SessionProgram, "rows_forwarded", 0)
    assert read({}) is None
    monkeypatch.delattr(SessionProgram, "rows_forwarded")
    monkeypatch.delattr(SessionProgram, "rows_padded")
    assert read({}) is None
