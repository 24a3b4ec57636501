"""The port's ViT-B/16 backbone (subspace_reg_tpu_torch/models/vit.py) on
the CPU at the benchmark reference's tiny sizes (width 32, depth 2, 2
heads, MLP 64, 8 px patches, 16 px images resized to 32), against the
benchmark's plain reference (benchmark/reference/vit_b16.py), which
shares no code with it, on seeded random weights:

  * eval-mode features within f32 rounding; train-mode features equal
    when both sides draw their dropout masks from generators of one seed,
    and unequal under another seed; ``sample_mask`` changes no row;
  * the feature width, timm's state-dict names, the operation counts at
    the published widths, f32 only;
  * the ``ViT.forwards`` / ``ViT.rows_forwarded`` counters and the
    ``srt.vit.*`` ranges; no ``srt.*`` name holds a mark of a reader of
    device records (benchmark/metrics, benchmark/harness.py);
  * ``weights.load_pth`` keeps a ViT's keys and loads a resnet ``.pth``
    to the state dict it always did; the eval CLI runs a tiny ``vit_b16``
    ``.pth`` through one session.

No test builds the published widths."""

import functools
import importlib.util
import inspect
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import draws as D
from benchmark import synth
from benchmark.reference import backbone
from subspace_reg_tpu_torch.models import vit
from subspace_reg_tpu_torch.models.factory import create_model, model_dict
from subspace_reg_tpu_torch.utils import spans
from subspace_reg_tpu_torch.weights import load_pth

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark/configs/vit-b16-mini224.json")
                    .read_text())
REF = backbone.of(CONFIG)
TINY = REF.TINY
TINY_CFG = dict(CONFIG, **TINY)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for this module: the tier-1 lane runs six
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Opt:
    no_dropblock = True


def tiny_model(seed: int = 3, **kw):
    m = vit.vit_b16(drop_rate=0.1, **TINY, **kw)
    synth.init_backbone(m, seed)
    return m


def images(n: int = 6, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 3, TINY["img_size"], TINY["img_size"]),
                       generator=g)


def gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_eval_features_match_the_reference():
    m = tiny_model().eval()
    x = images()
    with torch.no_grad():
        f = m(x)
        r = REF.forward(m.state_dict(), {}, x, TINY_CFG, False)
    assert f.shape == (6, 32) and f.dtype == torch.float32
    assert gap(f, r) < 1e-5


def test_train_features_match_under_one_seed_only():
    m = tiny_model().train()
    x = images()
    with torch.no_grad():
        f = m(x, generator=D.generator(5, D.DROPOUT, 0, "cpu"))
        r = REF.forward(m.state_dict(), {}, x, TINY_CFG, True,
                        D.generator(5, D.DROPOUT, 0, "cpu"))
        other = REF.forward(m.state_dict(), {}, x, TINY_CFG, True,
                            D.generator(6, D.DROPOUT, 0, "cpu"))
        plain = m.eval()(x)
    assert gap(f, r) < 1e-5
    assert gap(other, r) > 1e-2 and gap(plain, r) > 1e-2


def test_sample_mask_changes_no_row():
    """A ViT takes no batch statistic: the mask of the replay buffer's
    padded rows has nothing to act on, in either mode."""
    m = tiny_model()
    x = images()
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    with torch.no_grad():
        for train in (True, False):
            m.train(train)
            a = m(x, generator=D.generator(1, D.DROPOUT, 0, "cpu"))
            b = m(x, sample_mask=mask,
                  generator=D.generator(1, D.DROPOUT, 0, "cpu"))
            assert torch.equal(a, b)


def test_feature_width_and_published_sizes():
    assert tiny_model().feature_dim == 32 == REF.feature_dim(TINY_CFG)
    sig = inspect.signature(vit.vit_b16).parameters
    published = {k: sig[k].default for k in ("width", "depth", "heads",
                                              "mlp", "patch", "input_size")}
    assert published == {"width": 768, "depth": 12, "heads": 12,
                         "mlp": 3072, "patch": 16, "input_size": 224}
    assert published == {k: CONFIG[k] for k in published}
    assert REF.feature_dim(CONFIG) == 768
    assert model_dict["vit_b16"] is vit.vit_b16


def test_state_dict_names_are_timms():
    block = ["norm1.weight", "norm1.bias", "attn.qkv.weight",
             "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
             "norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
             "mlp.fc2.weight", "mlp.fc2.bias"]
    want = (["cls_token", "pos_embed", "patch_embed.proj.weight",
             "patch_embed.proj.bias"]
            + [f"blocks.{i}.{k}" for i in range(2) for k in block]
            + ["norm.weight", "norm.bias"])
    sd = tiny_model().state_dict()
    assert list(sd) == want
    assert sd["patch_embed.proj.weight"].shape == (32, 3, 8, 8)
    assert sd["pos_embed"].shape == (1, 17, 32)
    assert sd["blocks.0.attn.qkv.weight"].shape == (96, 32)


def test_operation_counts_at_the_published_widths():
    assert REF.forward_flops(CONFIG) == 35_126_120_448
    assert REF.dense_flops(CONFIG) == 33_695_465_472


def test_f32_only():
    with pytest.raises(NotImplementedError):
        create_model("vit_b16", Opt(), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        REF.forward({}, {}, images(), TINY_CFG, False, dtype=torch.bfloat16)


def test_counters_advance_per_forward_and_row():
    m = tiny_model().eval()
    f0, r0 = vit.ViT.forwards, vit.ViT.rows_forwarded
    with torch.no_grad():
        m(images(6))
        m(images(3))
    assert vit.ViT.forwards - f0 == 2
    assert vit.ViT.rows_forwarded - r0 == 9


def _ranges(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("srt.")]


def test_spans_under_a_profiler_and_the_no_op_otherwise():
    assert spans.span("srt.vit.forward") is spans._OFF
    m = tiny_model().eval()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as p:
        m(images())
    names = [r[0] for r in _ranges(p)]
    assert sorted(names) == sorted(
        ["srt.vit.forward", "srt.vit.embed"]
        + ["srt.vit.attn_block", "srt.vit.mlp_block"] * TINY["depth"])
    outer = next(r for r in _ranges(p) if r[0] == "srt.vit.forward")
    assert all(outer[1] <= a and b <= outer[2] for _, a, b in _ranges(p))


def _device_marks():
    """Every mark a reader of device records matches on: the ``*_MARKS``
    tuples of benchmark/metrics/*.py and what ``Trace.kernels`` leaves
    out."""
    marks = ["Memcpy", "Memset"]
    for f in sorted((ROOT / "benchmark/metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            "marks_" + re.sub(r"\W", "_", f.stem), f)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for k, v in vars(mod).items():
            if k.endswith("MARKS"):
                marks += list(v)
    return marks


def test_no_span_name_meets_a_device_reader():
    names = set()
    for f in (ROOT / "subspace_reg_tpu_torch").rglob("*.py"):
        names |= set(re.findall(r"""["'](srt\.[\w.]+)["']""",
                                f.read_text()))
    assert {"srt.vit.forward", "srt.vit.embed", "srt.vit.attn_block",
            "srt.vit.mlp_block", "srt.eval.k1"} <= names
    marks = _device_marks()
    assert {"fmha_", "finetune_loop", "conv"} <= set(marks)
    assert any("gemm" in m for m in marks)
    for name in names:
        assert not any(m in name for m in marks), name


def _reference_pth(path, sd, n_cls, dim, extra=()):
    sd = dict(sd)
    sd["classifier.weight"] = 0.05 * torch.randn(n_cls, dim)
    for k in extra:
        sd[k] = torch.zeros(3)
    torch.save({"model": sd, "training_classes": {i: i for i in range(n_cls)},
                "label2human": [f"synthetic {i}" for i in range(100)]}, path)


def test_load_pth_keeps_a_vits_keys(tmp_path):
    m = tiny_model()
    path = str(tmp_path / "vit_b16_last.pth")
    _reference_pth(path, m.state_dict(), 60, 32)
    state, head, meta = load_pth(path, max_classes=100)
    assert list(state) == list(m.state_dict())
    fresh = vit.vit_b16(**TINY)
    fresh.load_state_dict(state)            # strict: every key present
    assert all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), m.state_dict().values()))
    assert head.weight.shape == (100, 32) and head.n_active == 60


def test_load_pth_of_a_resnet_is_unchanged(tmp_path):
    """A resnet ``.pth`` with BatchNorm's own counters, a classifier and
    keys outside the backbone loads to exactly the state dict of the
    former rule, the keys that start with ``layer``."""
    m = create_model("resnet18", Opt())
    sd = m.state_dict()
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(3)
    path = str(tmp_path / "resnet18_last.pth")
    _reference_pth(path, sd, 60, 640, extra=("vocab_embeds", "lang.weight"))
    state, _, _ = load_pth(path)
    raw = torch.load(path, weights_only=False)["model"]
    before = {k: v for k, v in raw.items() if k.startswith("layer")}
    assert list(state) == list(before)
    assert all(torch.equal(state[k], before[k]) for k in before)
    create_model("resnet18", Opt()).load_state_dict(state)


def test_eval_cli_runs_a_vit_pth(tmp_path, monkeypatch, capsys):
    """``eval_incremental.main --model vit_b16`` on a tiny ViT ``.pth``:
    the factory, the engine and K1's twin, one session."""
    from torch_support import write_continual_mini
    from subspace_reg_tpu_torch import eval_incremental
    monkeypatch.setitem(model_dict, "vit_b16",
                        functools.partial(vit.vit_b16, **TINY))
    write_continual_mini(str(tmp_path / "miniImageNet"), img=16)
    path = str(tmp_path / "vit_b16_last.pth")
    torch.manual_seed(0)
    _reference_pth(path, tiny_model().state_dict(), 60, 32)
    f0 = vit.ViT.forwards
    res = eval_incremental.main([
        "--model", "vit_b16", "--model_path", path, "--data_root",
        str(tmp_path), "--n_shots", "5", "--classifier", "linear",
        "--eval_mode", "few-shot-incremental-fine-tune",
        "--min_novel_epochs", "5", "--max_novel_epochs", "20",
        "--learning_rate", "0.002", "--freeze_backbone_at", "1",
        "--test_base_batch_size", "100", "--continual", "--n_queries", "4",
        "--lmbd_reg_transform_w", "0.2", "--target_train_loss", "0.0",
        "--label_pull", "1.0", "--lmbd_reg_novel", "0.1",
        "--attraction_override", "distance2subspace",
        "--n_base_support_samples", "1", "--memory_replay", "1",
        "--neval_episodes", "1", "--set_seed", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "val_acc_novel" in out
    assert len(res.epochs_per_session) == 1
    assert np.isfinite(res.acc_average)
    # eval_base, then the support's train-mode forward and four caches
    assert vit.ViT.forwards - f0 == 6
