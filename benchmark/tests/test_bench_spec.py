"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name; a new cell is a new file and a new entry."""

import functools
import json
import re
import shutil
from pathlib import Path

import pytest

from bench_tiny import ROOT, run
from benchmark import flops, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) <= 64 * 1024
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)


def test_configs(spec):
    names = [c["name"] for c in spec["configs"]]
    assert len(set(names)) == len(names)
    files = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = harness.load_json(ROOT / c["file"])
        assert body["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not k.endswith(("_dim", "_rank")) and "width" not in k
        assert (ROOT / body["reference"]).exists()
        used = [w for w in spec["workloads"] if w["config"] == c["name"]]
        assert used, f"{c['name']} is used by no cell"


def test_workloads(spec):
    names = [w["name"] for w in spec["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in spec["workloads"]}
    assert len(pairs) == len(names)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        wl = harness.load_json(ROOT / "benchmark" / "workloads"
                               / f"{w['name']}.json")
        assert (ROOT / "benchmark" / "jobs" / f"{wl['job']}.py").exists()
        assert wl["limits"], "every cell compares its output"
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(names) // 4)


def test_metrics(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [m["name"] for m in spec["per_layer"]]
    assert len(set(names)) == len(names)
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    layers = set()
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert _line(m["layer"])
        layers.add(m["layer"])
        for cell in m.get("workloads", []):
            assert cell in cells
            reported = e2e[m["moves"]].get("workloads", cells)
            assert cell in reported, f"{m['name']}: {cell} lacks {m['moves']}"
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough(spec):
    for w in spec["workloads"]:
        cell = harness.find_cell(spec, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, f"{w['name']} reports no per-layer metric"


def test_a_new_cell_is_a_file_and_an_entry(tmp_path, spec):
    """A throwaway workload file and its entry, in a copy of the
    benchmark: found and run without editing a file that is there."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    wl = harness.load_json(ROOT / "benchmark/workloads/pretrain-mini84.json")
    wl["print_freq"] = 5
    (tmp_path / "benchmark/workloads/pretrain-mini84-pf5.json").write_text(
        json.dumps(wl))
    new = json.loads(json.dumps(spec))
    new["workloads"].append({"name": "pretrain-mini84-pf5",
                             "config": "resnet18-mini84",
                             "traffic": "pretrain-mini84-pf5", "chips": 1,
                             "why": "throwaway"})
    for m in new["end_to_end"] + new["per_layer"]:
        if "pretrain-mini84" in m.get("workloads", []):
            m["workloads"].append("pretrain-mini84-pf5")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    cell = harness.find_cell(new, "pretrain-mini84-pf5", tmp_path)
    assert cell.workload["print_freq"] == 5
    assert {m["name"] for m in cell.per_layer} >= {"pretrain.mfu_pct"}
    out = run("pretrain-mini84-pf5", root=tmp_path)
    assert out["correct"]
    assert set(out["metrics"]) == {"pretrain_images_per_s",
                                   "pretrain_step_p95_ms", "setup_s"}


@pytest.mark.parametrize("eps,correct", [(1e-6, True), (1e-3, False)])
def test_a_new_architecture_is_files_and_entries(tmp_path, spec, monkeypatch,
                                                 eps, correct):
    """A throwaway backbone of another architecture (``standin.py``: a
    patch embedding, LayerNorm, one attention block), registered in the
    port's ``model_dict`` for the test alone, enters a copy of the
    benchmark as its reference file, a configuration file, an eval
    workload and their entries, with no file already in the copy edited.
    A sound run reads correct; one whose program forward takes
    LayerNorm's eps at 1e-3, the reference's at 1e-6, does not."""
    import standin
    from subspace_reg_tpu_torch.models.factory import model_dict
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {f: f.read_bytes() for f in bench.rglob("*") if f.is_file()}
    shutil.copy(Path(__file__).with_name("standin_reference.py"),
                bench / "reference/standin.py")
    cfg = harness.load_json(ROOT / "benchmark/configs/resnet18-mini84.json")
    for k in ("widths", "n_blocks", "drop_rate", "dropblock_size",
              "no_dropblock"):
        del cfg[k]
    cfg.update(name="standin-mini32", model="standin",
               reference="benchmark/reference/standin.py", width=32,
               patch=4, heads=2, mlp=64, img_size=32)
    (bench / "configs/standin-mini32.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "workloads/eval-mini84.json",
                bench / "workloads/eval-standin.json")
    new = json.loads(json.dumps(spec))
    new["configs"].append({"name": "standin-mini32",
                           "source": "https://arxiv.org/abs/2010.11929",
                           "file": "benchmark/configs/standin-mini32.json",
                           "reduced": [], "why": "throwaway"})
    new["workloads"].append({"name": "eval-standin",
                             "config": "standin-mini32",
                             "traffic": "eval-standin", "chips": 1,
                             "why": "throwaway"})
    for m in new["end_to_end"] + new["per_layer"]:
        if "eval-mini84" in m.get("workloads", []):
            m["workloads"].append("eval-standin")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    monkeypatch.setitem(model_dict, "standin",
                        functools.partial(standin.build, eps=eps))
    out = run("eval-standin", root=tmp_path)
    assert out["correct"] == correct, out["checks"]
    assert all(f.read_bytes() == b for f, b in before.items())
    cell = harness.find_cell(new, "eval-standin", tmp_path)
    assert flops.feature_dim(cell.config) == 32
    assert flops.forward_flops(cell.config) == (
        2 * 3 * 32 * 16 * 64 + 2 * 65 * 32 * 128 + 4 * 65 * 65 * 32
        + 4 * 65 * 32 * 64)


def test_a_metric_without_workloads_follows_its_end_to_end_metric(spec):
    """A per-layer metric that lists no cells is reported in every cell
    that reports the end-to-end metric it moves, later cells too."""
    new = json.loads(json.dumps(spec))
    new["per_layer"].append({"name": "eval.throwaway", "unit": "%",
                             "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "eval_s_per_seed"})
    for w in new["workloads"]:
        cell = harness.find_cell(new, w["name"])
        moves = "eval_s_per_seed" in {m["name"] for m in cell.end_to_end}
        assert ("eval.throwaway" in {m["name"] for m in cell.per_layer}) \
            == moves
