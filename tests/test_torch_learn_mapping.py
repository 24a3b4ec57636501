"""The port's label->image mapping trainer
(``python -m subspace_reg_tpu_torch.learn_mapping``) and ``.ckpt`` ->
reference ``.pth`` writer (``python -m subspace_reg_tpu_torch.export_pth``)
against the JAX tools (tools/learn_mapping.py, tools/export_pth.py) on the
CPU.

Tolerances: ``train_linear_map`` from the JAX tool's initial (w, b) over
its 1000 epochs (60 base rows, 300 -> 640): w, b and the final MSE at
rtol 1e-4, atol 1e-6 (the two libraries' f32 products round differently;
the iteration contracts, so the difference stays at rounding).  The files
the port writes are read back by both packages' loaders with every leaf,
the head, the metadata and the mapping equal.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.utils import checkpoint as jckpt
from subspace_reg_tpu.utils.torch_import import import_checkpoint
from subspace_reg_tpu_torch import export_pth, learn_mapping
from subspace_reg_tpu_torch.data import synthetic
from subspace_reg_tpu_torch.models.head import Head
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.utils import checkpoint as ckpt
from subspace_reg_tpu_torch.weights import to_jax_variables

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import learn_mapping as jax_tool  # noqa: E402

N_BASE, WIDTHS = 60, (8, 16, 24, 32)


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


def _jax_init(in_dim, out_dim, seed=0):
    """The JAX tool's initial (w, b) (tools/learn_mapping.py:40-44)."""
    k = 1.0 / jnp.sqrt(jnp.asarray(in_dim, jnp.float32))
    kw, kb = jax.random.split(jax.random.PRNGKey(seed))
    w = jax.random.uniform(kw, (out_dim, in_dim), jnp.float32, -k, k)
    b = jax.random.uniform(kb, (out_dim,), jnp.float32, -k, k)
    return np.asarray(w), np.asarray(b)


def test_train_linear_map_matches_the_jax_tool():
    r = np.random.RandomState(0)
    x = r.standard_normal((N_BASE, 300)).astype(np.float32) * 0.3
    t = (0.05 * r.standard_normal((N_BASE, 640))).astype(np.float32)
    w_ref, b_ref = jax_tool.train_linear_map(x, t)
    w, b = learn_mapping.train_linear_map(x, t, init=_jax_init(300, 640),
                                          device="cpu")
    np.testing.assert_allclose(w, w_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b, b_ref, rtol=1e-4, atol=1e-6)
    mse = lambda w_, b_: float(np.mean((x @ w_.T + b_ - t) ** 2))  # noqa
    assert mse(w, b) == pytest.approx(mse(w_ref, b_ref), rel=1e-4)
    # the seeded start of the port: nn.Linear's default range
    w0, _ = learn_mapping.train_linear_map(x, t, epochs=0, device="cpu")
    assert np.abs(w0).max() <= 1.0 / np.sqrt(300)


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """A continual ``.ckpt`` (narrow backbone, 60-row head, the label
    names of the synthetic vocabulary) and a word-embedding pickle."""
    root = str(tmp_path_factory.mktemp("mapping"))
    synthetic.make_word_embeds(os.path.join(root, "word_embeds"),
                               n_classes=N_BASE)
    torch.manual_seed(0)
    bb = ResNetRFS(n_blocks=(1, 1, 2, 2), widths=WIDTHS)
    for i, block in enumerate(bb.blocks()):
        block.num_batches_tracked.fill_(i + 3)
    w = torch.randn(N_BASE, WIDTHS[-1]) * 0.1
    path = os.path.join(root, "src.ckpt")
    label2human = [f"synthetic {i}" for i in range(N_BASE)] + [""] * 4
    ckpt.save_checkpoint(path, to_jax_variables(bb.state_dict()),
                         Head(weight=w, bias=None, n_active=N_BASE),
                         {"epoch": 7, "label2human": label2human,
                          "training_classes": {i + 3: i
                                               for i in range(N_BASE)}})
    return root, path


def _expected_mapping(root, src):
    """The map the port's trainer makes from ``src``: the GloVe slice of
    the synthetic embeddings onto the head's rows."""
    from subspace_reg_tpu_torch.models.embeds import get_embeds
    _, head, meta = ckpt.load_checkpoint(src)
    vocab = [n for n in meta["label2human"] if n != ""]
    e = np.asarray(get_embeds(os.path.join(root, "word_embeds",
                                           "miniImageNet_dim500.pickle"),
                              vocab, 500), np.float32)[:, :300]
    return learn_mapping.train_linear_map(
        e, np.asarray(head.weight)[:N_BASE], device="cpu")


def _assert_same_file(path, src, want_map):
    """``path`` read by both packages' ``load_any``: the backbone, head,
    metadata and mapping of ``src`` and ``want_map``."""
    v_src, h_src, m_src = ckpt.load_checkpoint(src)
    jv, jh, jm = jckpt.load_any(path, device=False)
    sd, h, m = ckpt.load_any(path)
    for meta in (jm, m):
        got = meta["mapping_linear_label2image"]
        np.testing.assert_array_equal(np.asarray(got["weight"]), want_map[0])
        np.testing.assert_array_equal(np.asarray(got["bias"]), want_map[1])
        assert meta["label2human"] == m_src["label2human"]
        assert meta["training_classes"] == m_src["training_classes"]
    for head in (jh, h):
        assert int(head.n_active) == N_BASE
        np.testing.assert_array_equal(np.asarray(head.weight)[:N_BASE],
                                      np.asarray(h_src.weight))
    for leaves, ref in ((jax.tree.leaves(jv["params"]),
                         jax.tree.leaves(v_src["params"])),
                        (jax.tree.leaves(jv["batch_stats"]),
                         jax.tree.leaves(v_src["batch_stats"]))):
        for a, b in zip(leaves, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref_sd = {k: v for k, v in ckpt.load_any(src)[0].items()}
    assert set(sd) >= set(ref_sd)
    for k, v in ref_sd.items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("suffix", [".ckpt", ".pth"])
def test_main_writes_a_mapping_both_packages_read(source, suffix, capsys):
    root, src = source
    out = os.path.join(root, f"mapped{suffix}")
    learn_mapping.main(["--model_path", src, "--save_path", out,
                        "--word_embed_path", os.path.join(root,
                                                          "word_embeds"),
                        "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "final MSE: " in printed and f"saved {out}" in printed
    want = _expected_mapping(root, src)
    assert want[0].shape == (WIDTHS[-1], 300)
    _assert_same_file(out, src, want)
    if suffix == ".pth":
        # the block counters kept (JAX's writer zeroes the BN counters)
        raw = torch.load(out, map_location="cpu", weights_only=False)
        assert int(raw["model"]["layer4.1.num_batches_tracked"]) == 8
        assert set(raw["mapping_linear_label2image"]) == {"map.weight",
                                                          "map.bias"}


def test_export_pth_is_read_by_the_jax_importer(source, tmp_path, capsys):
    """A mapped ``.ckpt`` exported by the port, read by JAX's
    utils/torch_import.py: every backbone leaf, the head, the metadata
    and the mapping equal."""
    root, src = source
    mapped = str(tmp_path / "mapped.ckpt")
    want = _expected_mapping(root, src)
    variables, head, meta = ckpt.load_checkpoint(src)
    meta["mapping_linear_label2image"] = {"weight": want[0],
                                          "bias": want[1]}
    ckpt.save_checkpoint(mapped, variables, head, meta)
    out = str(tmp_path / "exported.pth")
    export_pth.main(["--ckpt", mapped, "--out", out])
    assert f"exported {out}" in capsys.readouterr().out
    jv, jh, jm = import_checkpoint(out, device=False)
    assert jm["epoch"] == 7
    for tree in ("params", "batch_stats"):
        for a, b in zip(jax.tree.leaves(jv[tree]),
                        jax.tree.leaves(variables[tree])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _assert_same_file(out, src, want)
