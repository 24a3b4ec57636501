"""The ViT-B/16 configuration (``configs/vit-b16-mini224.json``, its
reference ``reference/vit_b16.py``) and its cell ``eval-vitb16-mini224``
on the CPU at the reference's tiny sizes: a sound run reads correct; the
same run with the program's LayerNorm eps at 1e-3 or its GELU in the tanh
form does not, nor with the calibration's planted eval faults; a program
without the model fails at once; the cell's
per-layer readers read nothing, without raising, where there is nothing
to read."""

import contextlib
import io

import pytest
import torch

from bench_tiny import ROOT, overrides, run
from benchmark import calibrate, harness

CELL = "eval-vitb16-mini224"
NEW = ("eval.vit_gemm_roofline_pct", "eval.vit_attention_ms_per_seed",
       "eval.vit_launches_per_forward")


def test_sound_run_is_correct():
    out = run(CELL, seed=2 ** 31 + 29)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name,value", [("EPS", 1e-3), ("GELU", "tanh")])
def test_a_program_off_the_published_layers_is_not_correct(monkeypatch,
                                                           name, value):
    from subspace_reg_tpu_torch.models import vit
    monkeypatch.setattr(vit, name, value)
    out = run(CELL, seed=2 ** 31 + 29)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["eval_unchanged", "eval_answer",
                                   "eval_accuracy"])
def test_broken_timed_path_is_not_correct(fault):
    with calibrate.FAULTS[fault]():
        out = run(CELL, seed=5)
    assert not out["correct"], out["checks"]


def test_a_program_without_the_model_fails_at_once(monkeypatch):
    from subspace_reg_tpu_torch.models.factory import model_dict
    monkeypatch.delitem(model_dict, "vit_b16")
    # the factory refuses the name (at the tiny sizes the builder is
    # looked up first)
    with pytest.raises((NotImplementedError, KeyError), match="vit_b16"):
        run(CELL)


def test_the_cells_metrics():
    spec = harness.load_spec()
    cell = harness.find_cell(spec, CELL)
    assert {m["name"] for m in cell.end_to_end} == {"eval_s_per_seed",
                                                    "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW) <= names and "eval.conv_ms_per_seed" not in names
    assert {m["layer"] for m in cell.per_layer if m["name"] in NEW} \
        == {"models.vit"}


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_traces(name):
    spec = harness.load_spec()
    cell = harness.find_cell(spec, CELL)
    reader = harness.metric_reader(name)
    for rec in ({}, {"traces": [], "runs": 2, "cell": cell},
                {"traces": [harness.Trace(device=[], host=[], span=(0, 1))],
                 "runs": 2, "cell": cell, "precision": "f32",
                 "peak_flops": harness.PEAK_FLOPS}):
        assert reader.read(rec) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.gpu
def test_control_is_not_correct_on_the_card(card):
    """The reference in TF32, in the program's place, fails the cell's
    limits at a size a test run holds; the program passes them."""
    ov = overrides(CELL)
    lim = harness.load_json(ROOT / f"benchmark/workloads/{CELL}.json")[
        "limits"]
    for seed in (1, 2, 3):
        with contextlib.redirect_stdout(io.StringIO()):
            r = calibrate.reading(CELL, seed, 0.5, control=True,
                                  device=card, overrides=ov)
        assert r["correct"], r["checks"]
        assert any(r["control"][k] > lim[k] for k in lim
                   if k in r["control"]), r["control"]
