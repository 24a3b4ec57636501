"""The reference against the port on the CPU at a tiny size: sound runs
come out correct, runs with the timed path broken come out not correct,
and the command fails rather than fall back when it finds no card."""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_tiny import ROOT, overrides, run, with_streamed_cell
from benchmark import calibrate, harness


STREAMED = "pretrain-tiered84-streamed"


def _spec(cell):
    spec = harness.load_spec()
    return with_streamed_cell(spec) if cell == STREAMED else spec


@pytest.mark.parametrize("cell", ["eval-mini84", "eval-tiered84",
                                  "pretrain-mini84", STREAMED])
def test_sound_run_is_correct(cell):
    out = run(cell, seed=2 ** 31 + 11, spec=_spec(cell))
    assert out["correct"], out["checks"]
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell,fault", [
    ("eval-mini84", "eval_unchanged"), ("eval-mini84", "eval_answer"),
    ("eval-mini84", "eval_accuracy"),
    ("eval-tiered84", "eval_unchanged"), ("eval-tiered84", "eval_answer"),
    ("eval-tiered84", "eval_accuracy"),
    ("pretrain-mini84", "pretrain_unchanged"),
    ("pretrain-mini84", "pretrain_half_batch"),
    ("pretrain-mini84", "pretrain_repeated_rows"),
    (STREAMED, "pretrain_half_batch")])
def test_broken_timed_path_is_not_correct(cell, fault):
    with calibrate.FAULTS[fault]():
        out = run(cell, seed=5, spec=_spec(cell))
    assert not out["correct"], out["checks"]


def test_streamed_cell_reads_the_loader():
    out = run(STREAMED, trace=True, spec=_spec(STREAMED))
    assert out["correct"]
    assert out["metrics"]["pretrain.loader_wait_ms"]["value"] >= 0


def test_traced_run_reports_the_cells_layers():
    out = run("pretrain-mini84", trace=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"


def _command(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "eval-mini84",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _command(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _command(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["eval-mini84", "eval-tiered84",
                                  "pretrain-mini84"])
def test_control_is_not_correct_on_the_card(card, cell):
    """The control (the reference one precision below the
    configuration's, in the program's place) fails the cell's limits, at
    a size a test run holds; the program passes them."""
    ov = overrides(cell)
    for seed in (1, 2, 3):
        with contextlib.redirect_stdout(io.StringIO()):
            r = calibrate.reading(cell, seed, 0.5, control=True,
                                  device=card, overrides=ov)
        assert r["correct"], r["checks"]
        lim = harness.load_json(
            ROOT / f"benchmark/workloads/{cell}.json")["limits"]
        assert any(r["control"][k] > lim[k] for k in lim
                   if k in r["control"]), r["control"]
