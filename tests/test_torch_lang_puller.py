"""The port's attractors (subspace_reg_tpu_torch/models/lang_puller.py)
against the JAX package's models/lang_puller.py on the same seeded
embedding pickles: word embeds (softmax attractors, with synonyms and the
GloVe slice), the label->image LinearMap and the description embeds.

``pullers_host_f64`` is the value both engines hand K1: computed in
float64 on the host and rounded once, it must be bit-identical.  The f32
``pullers`` agree to rtol 1e-5 (f32 sums in another order).  Also the
width-mismatch error, the description filename contract and the mapping a
``.pth`` checkpoint carries."""

import os
import pickle
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from subspace_reg_tpu.data import synthetic
from subspace_reg_tpu.models import lang_puller as jlp
from subspace_reg_tpu.utils.torch_import import import_checkpoint
from subspace_reg_tpu_torch.models import lang_puller as lp
from subspace_reg_tpu_torch.weights import load_checkpoint

VOCAB_BASE = [f"synthetic {i}" for i in range(60)]
VOCAB_NOVEL = [f"synthetic {i}" for i in range(60, 65)]
VOCAB_NEXT = [f"synthetic {i}" for i in range(65, 70)]
FEAT = 24


@pytest.fixture(scope="module")
def embeds(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("embeds"))
    words = os.path.join(root, "word_embeds")
    synthetic.make_word_embeds(words, n_classes=100)
    r = np.random.RandomState(7)
    with open(os.path.join(words, "miniImageNet_dim500_base_synonyms.pickle"),
              "wb") as f:
        pickle.dump({name: r.randn(500) for name in VOCAB_BASE}, f)
    descs = os.path.join(root, "description_embeds")
    os.makedirs(descs)
    # values pickled as torch tensors, as the reference's assets are
    with open(os.path.join(
            descs, "miniImageNet_bert-base-cased_layer6_prefix_True.pickle"),
            "wb") as f:
        pickle.dump({name: torch.from_numpy(r.randn(768))
                     for name in VOCAB_BASE + VOCAB_NOVEL + VOCAB_NEXT}, f)
    return dict(words=words, descs=descs, base_weight=(
        0.1 * r.randn(60, FEAT)).astype(np.float32))


def _opt(embeds, **kw):
    o = types.SimpleNamespace(
        dataset="miniImageNet", word_embed_size=500,
        word_embed_path=embeds["words"], use_synonyms=False, glove=False,
        temperature=3.0, use_descriptions=False,
        description_embed_path=embeds["descs"],
        desc_embed_model="bert-base-cased", transformer_layer=6,
        prefix_label=True)
    for k, v in kw.items():
        setattr(o, k, v)
    return o


def _mapping(in_dim, seed=3):
    r = np.random.RandomState(seed)
    return ((0.05 * r.randn(FEAT, in_dim)).astype(np.float32),
            (0.01 * r.randn(FEAT)).astype(np.float32))


def _states(opt, mapping=None):
    """The JAX and the port's puller states after session 0 and one
    update (the next session's novel labels)."""
    j = jlp.update_novel_embeds(
        jlp.create_lang_puller(opt, VOCAB_BASE, VOCAB_NOVEL), opt,
        VOCAB_NEXT)
    t = lp.update_novel_embeds(
        lp.create_lang_puller(opt, VOCAB_BASE, VOCAB_NOVEL), opt, VOCAB_NEXT)
    if mapping is not None:
        j = jlp.with_mapping(j, *mapping)
        t = lp.with_mapping(t, *mapping)
    return j, t


CASES = {
    "softmax": (dict(), None),
    "synonyms": (dict(use_synonyms=True), None),
    "glove": (dict(glove=True), None),
    "glove_synonyms": (dict(glove=True, use_synonyms=True), None),
    "mapping": (dict(glove=True), 300),
    "descriptions": (dict(use_descriptions=True), None),
    "descriptions_mapping": (dict(use_descriptions=True), 768),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_attractors_bit_identical_to_jax(embeds, case):
    over, map_in = CASES[case]
    opt = _opt(embeds, **over)
    j, t = _states(opt, None if map_in is None else _mapping(map_in))
    np.testing.assert_array_equal(np.asarray(j.base_embeds),
                                  t.base_embeds.numpy())
    np.testing.assert_array_equal(np.asarray(j.novel_embeds),
                                  t.novel_embeds.numpy())
    want = jlp.pullers_host_f64(j, embeds["base_weight"])
    got = lp.pullers_host_f64(t, embeds["base_weight"])
    assert got.dtype == np.float32 and got.shape == (5, FEAT)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask_diagonal", [False, True])
@pytest.mark.parametrize("case", ["softmax", "glove_synonyms", "mapping",
                                  "descriptions"])
def test_f32_attractors_match_jax(embeds, case, mask_diagonal):
    """rtol 1e-5, and near zero 1e-4 of the attractors' largest magnitude:
    the softmax over 500-d scores (|score| / T up to ~10 here) turns the
    f32 rounding of the scores into differences of up to ~2e-5 of that
    magnitude between two f32 evaluations (both stay within it of the
    float64 value)."""
    over, map_in = CASES[case]
    opt = _opt(embeds, **over)
    j, t = _states(opt, None if map_in is None else _mapping(map_in))
    want = np.asarray(jlp.pullers(j, jnp.asarray(embeds["base_weight"]),
                                  mask_diagonal=mask_diagonal))
    got = lp.pullers(t, torch.from_numpy(embeds["base_weight"]),
                     mask_diagonal=mask_diagonal)
    assert not got.requires_grad
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-5, atol=1e-4 * np.abs(want).max())


def test_mask_diagonal_masks_the_leading_square(embeds):
    """With the diagonal masked, the first min(n_novel, n_base) attractors
    put no weight on their own index's base row."""
    t = lp.create_lang_puller(_opt(embeds), VOCAB_BASE, VOCAB_NOVEL)
    eye = torch.eye(60)
    got = lp.pullers(t, eye, mask_diagonal=True)     # = the probabilities
    assert torch.all(got[torch.arange(5), torch.arange(5)] < 1e-30)
    torch.testing.assert_close(got.sum(1), torch.ones(5))


def test_mapping_width_mismatch_raises(embeds):
    """The LinearMap is trained on the 300-d GloVe slice: 500-d word
    embeds without --glove are refused, in both forms, as in JAX."""
    _, t = _states(_opt(embeds), _mapping(300))
    j, _ = _states(_opt(embeds), _mapping(300))
    with pytest.raises(ValueError, match="--glove"):
        lp.pullers_host_f64(t, embeds["base_weight"])
    with pytest.raises(ValueError, match="--glove"):
        lp.pullers(t, torch.from_numpy(embeds["base_weight"]))
    with pytest.raises(ValueError, match="--glove"):
        jlp.pullers_host_f64(j, embeds["base_weight"])


def test_description_filename_contract(embeds):
    """The exact filename format of reference util.py:95-99, as the JAX
    package reads it."""
    opt = _opt(embeds, use_descriptions=True)
    assert lp.description_embed_path(opt) == os.path.join(
        embeds["descs"],
        "miniImageNet_bert-base-cased_layer6_prefix_True.pickle")
    opt2 = _opt(embeds, desc_embed_model="bert-large-uncased",
                transformer_layer=9, prefix_label=False)
    assert lp.description_embed_path(opt2) == jlp.description_embed_path(
        opt2)
    assert lp.description_embed_path(opt2).endswith(
        "miniImageNet_bert-large-uncased_layer9_prefix_False.pickle")


def test_checkpoint_carries_the_mapping(tmp_path):
    """A ``.pth`` with a ``mapping_linear_label2image`` state dict: the
    port's loader puts it in ``meta`` as the JAX importer does
    (utils/torch_import.py:143-146)."""
    torch.manual_seed(0)
    w, b = _mapping(300)
    sd = {"layer1.0.conv1.weight": torch.randn(4, 3, 3, 3),
          "classifier.weight": torch.randn(60, 4)}
    path = str(tmp_path / "mapped.pth")
    torch.save({"model": sd, "mapping_linear_label2image": {
        "map.weight": torch.from_numpy(w), "map.bias": torch.from_numpy(b)}},
        path)
    _, _, meta = load_checkpoint(path)
    m = meta["mapping_linear_label2image"]
    np.testing.assert_array_equal(m["weight"], w)
    np.testing.assert_array_equal(m["bias"], b)
    jm = import_checkpoint(path, device=False)[2]
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(m[k], jm["mapping_linear_label2image"]
                                      [k])
    torch.save({"model": sd}, path)
    assert "mapping_linear_label2image" not in load_checkpoint(path)[2]
