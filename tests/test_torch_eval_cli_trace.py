"""The two eval CLIs, unstubbed, on one fixture: ``eval_incremental.py``
(the JAX package) and ``python -m subspace_reg_tpu_torch.eval_incremental``
print the same reference-format trace.

Fixture (tests/test_cli.py's, at 16 px): synthetic miniImageNet, 100
classes x 560 images (the reference's 500/50 continual split), at 16 px,
the smallest size at which resnet18's four 2x2 max-pools leave a feature
map (tests/test_cli.py's 8 px serves a stubbed engine); one seeded
full-width resnet18 ``.pth`` that both CLIs read, the golden subspace-reg +
memory flags with ``--n_queries 4 --test_base_batch_size 100
--max_novel_epochs 30``, and the semantic subspace configuration
(``--label_pull`` with the override unset, seeded word embeds).

The port's CLI gets the JAX engine's random draws through its ``draws``
keyword (augmentation, head growth and the dropout masks of the epoch-1
train-mode forwards: the CLI's resnet18 keeps the golden drop rate 0.1).
Held per session as the engine test holds the engines: the "Fine-tuning
epochs" exact; "Novel only incremental", "Base only incremental" and
"Overall continual accuracies" within 0.5.  The semantic case is marked
slow (the fast lane holds the semantic configuration's engine against JAX
in tests/test_torch_engine.py), as is the ``--track_weights --verbose``
case, which also holds where the iteration header prints and the
tracking CSV's name."""

import ast
import os
import re

import numpy as np
import pytest
import torch

import eval_incremental as jax_cli
from subspace_reg_tpu.config import parse_option_eval as jax_parse
from subspace_reg_tpu.data import synthetic
from subspace_reg_tpu.models.factory import create_model as jax_model
from subspace_reg_tpu_torch import eval_incremental as torch_cli
from subspace_reg_tpu_torch.models.factory import create_model

from test_torch_engine import JaxDraws

IMG = 16
SEED = 5
FLAGS = [
    "--model", "resnet18", "--no_dropblock", "--n_shots", "5",
    "--classifier", "linear", "--eval_mode", "few-shot-incremental-fine-tune",
    "--min_novel_epochs", "20", "--learning_rate", "0.002",
    "--freeze_backbone_at", "1", "--continual", "--lmbd_reg_transform_w",
    "0.2", "--target_train_loss", "0.0", "--lmbd_reg_novel", "0.1",
    "--n_base_support_samples", "1", "--memory_replay", "1",
    "--n_queries", "4", "--test_base_batch_size", "100",
    "--max_novel_epochs", "30", "--set_seed", str(SEED),
]
CONFIGS = {
    "subspace_reg": ["--label_pull", "1.0", "--attraction_override",
                     "distance2subspace"],
    "semantic_subspace_reg": ["--label_pull", "1.0"],
}
LISTS = ("Overall continual accuracies:", "Novel only incremental:",
         "Base only incremental:")


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
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_trace"))
    synthetic.make_mini_imagenet(os.path.join(root, "miniImageNet"),
                                 n_classes=100, per_class=560, img_size=IMG,
                                 seed=0)
    words = synthetic.make_word_embeds(os.path.join(root, "word_embeds"))

    class O:
        no_dropblock = True
    torch.manual_seed(0)
    sd = create_model("resnet18", O()).state_dict()
    sd["classifier.weight"] = 0.05 * torch.randn(60, 640)
    ckpt = os.path.join(root, "resnet18_last.pth")
    torch.save({"model": sd, "training_classes": {i: i for i in range(60)},
                "label2human": [f"synthetic {i}" for i in range(100)]}, ckpt)
    return dict(argv=FLAGS + ["--data_root", root, "--model_path", ckpt,
                              "--word_embed_path", os.path.dirname(words)])


def parse_trace(out: str):
    """The printed trace: the three per-session lists and the epochs of
    each session."""
    trace = {}
    for name in LISTS:
        lines = [l for l in out.splitlines() if l.startswith(name)]
        assert len(lines) == 1, name
        trace[name] = ast.literal_eval(lines[0][len(name):].strip())
    trace["epochs"] = [int(m) for m in re.findall(
        r"^Fine-tuning epochs:\s+(\d+)$", out, re.M)]
    return trace


@pytest.mark.parametrize("config", [
    "subspace_reg",
    # a second compile of the JAX CLI's full-width session program: ~1 min
    pytest.param("semantic_subspace_reg", marks=pytest.mark.slow),
])
def test_cli_traces_agree(fixture, capsys, config):
    argv = fixture["argv"] + CONFIGS[config]
    capsys.readouterr()
    jax_cli.main(list(argv))
    ref = parse_trace(capsys.readouterr().out)
    opt = jax_parse(list(argv))
    jbb = jax_model(opt.model, 60, opt, dataset=opt.dataset)
    torch_cli.main(list(argv) + ["--device", "cpu"],
                   draws=JaxDraws(SEED, jbb, IMG))
    got = parse_trace(capsys.readouterr().out)
    assert len(got["epochs"]) == 8
    assert got["epochs"] == ref["epochs"]
    for name in LISTS:
        assert len(got[name]) == len(ref[name])
        np.testing.assert_allclose(got[name], ref[name], atol=0.5,
                                   err_msg=name)


def _live_lines(out: str):
    """The iteration headers and the epochs of the Novel Epoch lines, in
    the order printed."""
    return [l.split("\t")[0] for l in out.splitlines()
            if l.startswith("**** Iteration") or l.startswith("Novel Epoch")]


# two more full-width CLI runs, ~2 min on the CPU; the fast lane holds the
# tracked engine against JAX's in tests/test_torch_engine_modes.py
@pytest.mark.slow
def test_cli_tracked_traces_agree(fixture, capsys, tmp_path, monkeypatch):
    """``--track_weights --verbose``: both CLIs run their tracked engines;
    the printed traces agree as above, each session's header comes before
    its live Novel Epoch lines, and both write the same CSV name in the
    working directory."""
    argv = (fixture["argv"] + CONFIGS["subspace_reg"]
            + ["--track_weights", "--verbose"])
    opt = jax_parse(list(argv))
    jbb = jax_model(opt.model, 60, opt, dataset=opt.dataset)
    outs, files = {}, {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        capsys.readouterr()
        if name == "jax":
            jax_cli.main(list(argv))
        else:
            torch_cli.main(list(argv) + ["--device", "cpu"],
                           draws=JaxDraws(SEED, jbb, IMG))
        outs[name] = capsys.readouterr().out
        files[name] = sorted(os.listdir(tmp_path / name))
    ref, got = parse_trace(outs["jax"]), parse_trace(outs["port"])
    assert len(got["epochs"]) == 8 and got["epochs"] == ref["epochs"]
    for name in LISTS:
        np.testing.assert_allclose(got[name], ref[name], atol=0.5,
                                   err_msg=name)
    lines = _live_lines(outs["port"])
    assert lines == _live_lines(outs["jax"])
    assert lines[0] == "**** Iteration 1/8 ****"
    assert lines[1].startswith("Novel Epoch")
    assert files["port"] == files["jax"] == [
        "track_weights_few-shot-incremental-fine-tune_pulling_regularize_"
        "1.0_target_loss_0.0_synonyms_False.csv"]
