"""The port's parity gate (``subspace_reg_tpu_torch.parity_gate``) and its
fixture runner (``run_parity_gate_fixture``): each case of
tests/test_parity_gate.py on the port's copy (reference stdout parsing,
a missing trace, the ``.json``/``.out`` loaders, the tolerance, configs
covering the eval scripts, the mapping-dimension error), the port's
``CONFIGS`` and ``_COMMON`` equal to the JAX tool's as data, and one
record-then-compare run of the fixture on the CPU: one configuration
(subspace_reg), one seed, 16 px, a narrow resnet18 (widths 16/32/48/80,
above the 60 base classes) pretrained for 0 epochs (the seeded initial
weights) and the sessions cut to 30 epochs (every other golden flag as
the gate has it), then a compare pass against a trace moved past the
tolerance, which fails the gate."""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from subspace_reg_tpu_torch import parity_gate, run_parity_gate_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF_OUT = """
************* Training arguments *************
...
Overall continual accuracies:  [82.5, 76.61, 71.27, 67.15, 63.74, 61.37, 59.05, 57.28, 55.6]
Novel only incremental:  [58.4, 52.6, 49.33, 47.1, 46.02, 43.93, 42.51, 41.46]
Base only incremental:  [78.05, 74.35, 72.0, 70.2, 69.35, 68.0, 67.2, 66.3]
val_acc_novel: 47.6688, std: 0.0000, time: 128.0
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for this module (six test processes share
    the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_gate():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import parity_gate as jax_gate
    finally:
        sys.path.pop(0)
    return jax_gate


def test_parse_reference_out():
    traces = parity_gate.parse_reference_out(REF_OUT)
    assert len(traces["overall"]) == 9
    assert len(traces["novel"]) == 8
    assert len(traces["base"]) == 8
    assert traces["overall"][0] == 82.5
    assert traces["novel"][-1] == 41.46
    assert traces == _jax_gate().parse_reference_out(REF_OUT)


def test_parse_reference_out_missing_trace():
    with pytest.raises(ValueError, match="Novel only"):
        parity_gate.parse_reference_out("Overall continual accuracies: [1.0]")


def test_load_expected_json_and_out(tmp_path):
    d = {"overall": [1, 2], "novel": [3], "base": [4]}
    with open(tmp_path / "subspace_reg_seed_1.json", "w") as f:
        json.dump(d, f)
    got = parity_gate.load_expected(str(tmp_path), "subspace_reg", 1)
    assert got["overall"] == [1.0, 2.0]
    with open(tmp_path / "fine_tune_seed_2.out", "w") as f:
        f.write(REF_OUT)
    got = parity_gate.load_expected(str(tmp_path), "fine_tune", 2)
    assert got["base"][0] == 78.05
    jax_gate = _jax_gate()
    for config, seed in (("subspace_reg", 1), ("fine_tune", 2)):
        assert parity_gate.load_expected(str(tmp_path), config, seed) == \
            jax_gate.load_expected(str(tmp_path), config, seed)
    with pytest.raises(FileNotFoundError):
        parity_gate.load_expected(str(tmp_path), "fine_tune", 9)


def test_compare_tolerance():
    ours = {"overall": [80.0, 70.0], "novel": [50.0], "base": [75.0]}
    ref = {"overall": [80.3, 69.8], "novel": [50.49], "base": [75.0]}
    ok, rows = parity_gate.compare(ours, ref, tolerance=0.5)
    assert ok
    assert (ok, rows) == _jax_gate().compare(ours, ref, tolerance=0.5)
    ref_bad = {"overall": [80.3, 69.8], "novel": [50.51], "base": [75.0]}
    ok, rows = parity_gate.compare(ours, ref_bad, tolerance=0.5)
    assert not ok
    bad_len = {"overall": [80.3], "novel": [50.0], "base": [75.0]}
    ok, rows = parity_gate.compare(ours, bad_len, tolerance=0.5)
    assert not ok and any("error" in r for r in rows)
    assert (ok, rows) == _jax_gate().compare(ours, bad_len, tolerance=0.5)


def test_configs_equal_the_jax_tools():
    """The port's golden flag sets are the JAX tool's, as data."""
    jax_gate = _jax_gate()
    assert parity_gate.CONFIGS == jax_gate.CONFIGS
    assert parity_gate._COMMON == jax_gate._COMMON


def test_golden_configs_cover_all_eval_scripts():
    """The gate's configs mirror scripts/continual/*.sh (minus pretraining,
    which has no eval trace to diff)."""
    scripts = {f[:-3] for f in os.listdir(os.path.join(
        REPO, "scripts", "continual")) if f.endswith(".sh")} - {
            "run_backbone"}
    assert scripts == set(parity_gate.CONFIGS)
    assert "--attraction_override" in parity_gate.CONFIGS["subspace_reg"]
    assert "distance2subspace" in parity_gate.CONFIGS["subspace_reg"]
    assert "--glove" in parity_gate.CONFIGS["semantic_subspace_reg"]
    sem = parity_gate.CONFIGS["semantic_subspace_reg"]
    assert sem[sem.index("--temperature") + 1] == "3.0"
    lm = parity_gate.CONFIGS["linear_mapping"]
    assert lm[lm.index("--label_pull") + 1] == "0.1"
    assert "mapping_linear_label2image" in lm
    assert "--glove" in lm


def test_mapping_dim_mismatch_raises_helpfully():
    """500-d embeds against a 300-d-trained LinearMap fail fast with a
    message pointing at --glove."""
    from subspace_reg_tpu_torch.models import lang_puller as lp
    state = lp.LangPullerState(
        base_embeds=torch.zeros((4, 500)), novel_embeds=torch.zeros((2, 500)),
        mapping_weight=torch.zeros((8, 300)), mapping_bias=torch.zeros((8,)))
    with pytest.raises(ValueError, match="--glove"):
        lp.pullers_host_f64(state, np.zeros((4, 8), np.float32))
    with pytest.raises(ValueError, match="--glove"):
        lp.pullers(state, torch.zeros((4, 8)))


def test_fixture_records_then_passes_and_a_moved_trace_fails(
        tmp_path, monkeypatch, capsys):
    """The fixture runner end to end on the CPU: synthetic miniImageNet at
    16 px, the port's pretraining CLI (0 epochs) and ``export_pth``, the
    gate in record mode, then in compare mode: PASSED, exit code 0, the
    JAX tool's report schema.  A recorded trace moved by 0.6 fails the
    next compare pass with exit code 1."""
    from subspace_reg_tpu_torch.models.factory import model_dict
    monkeypatch.setattr(parity_gate, "_COMMON", parity_gate._COMMON + [
        "--max_novel_epochs", "30"])
    monkeypatch.setitem(model_dict, "resnet18", functools.partial(
        model_dict["resnet18"], widths=(16, 32, 48, 80)))
    work, out = tmp_path / "work", tmp_path / "report.json"
    rc = run_parity_gate_fixture.main([
        "--work_dir", str(work), "--img_size", "16", "--epochs", "0",
        "--configs", "subspace_reg", "--seeds", "1", "--device", "cpu",
        "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    assert "PARITY GATE RECORDED" in text and "PARITY GATE PASSED" in text
    assert os.path.exists(work / "backbones" / "continual" / "resnet18" /
                          "1" / "resnet18_last.pth")
    with open(out) as f:
        report = json.load(f)
    assert set(report) == {"tolerance", "runs", "all_within", "fixture"}
    assert report["all_within"] and report["fixture"]["device"] == "cpu"
    (run,) = report["runs"]
    assert (run["config"], run["seed"], run["within_tolerance"]) == (
        "subspace_reg", 1, True)
    assert [len(run["ours"][k]) for k in ("overall", "novel", "base")] == [
        9, 8, 8]
    # the same run twice; the recorded .out prints 4 decimals
    assert all(r["max_abs_dev"] <= 5e-5 for r in run["comparison"])

    expected = work / "reference_outputs"
    moved = dict(run["ours"], novel=[run["ours"]["novel"][0] + 0.6]
                 + run["ours"]["novel"][1:])
    run_parity_gate_fixture.write_reference_out(
        str(expected / "subspace_reg_seed_1.out"), moved)
    rc = parity_gate.main([
        "--data_root", str(work / "data"), "--backbones_dir",
        str(work / "backbones" / "continual" / "resnet18"),
        "--word_embed_path", str(work / "word_embeds"),
        "--expected_dir", str(expected), "--configs", "subspace_reg",
        "--seeds", "1", "--device", "cpu", "--out",
        str(tmp_path / "failed.json")])
    assert rc == 1 and "PARITY GATE FAILED" in capsys.readouterr().out
