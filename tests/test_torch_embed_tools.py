"""The port's embedding-asset tools (subspace_reg_tpu_torch/utils/
embed_tools.py) against the JAX package's (subspace_reg_tpu/utils/
embed_tools.py, tests/test_embed_tools.py), offline: torchnlp's Vico,
transformers and nltk's WordNet are mocked, and both modules run on the
same mocks.  Held: the word splitting, the pickled schema ({word:
ndarray(dim)}, {class: ndarray(768)}), the file names, the reuse of an
existing pickle and the missing-dependency message; each pickle equal
to the JAX module's, key for key and bit for bit."""

import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from subspace_reg_tpu.utils import embed_tools as jax_tools
from subspace_reg_tpu_torch.utils import embed_tools as tools

from test_embed_tools import _install_fake_torchnlp


class Opt:
    dataset = "miniImageNet"
    word_embed_size = 500
    desc_embed_model = "bert-base-cased"
    transformer_layer = 6
    prefix_label = True


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_pickles(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


def test_create_and_save_embeds_matches_jax(tmp_path, monkeypatch):
    recorded = {}
    _install_fake_torchnlp(monkeypatch, recorded)
    paths = []
    for mod, sub in ((jax_tools, "jax"), (tools, "port")):
        opt = Opt()
        opt.word_embed_path = str(tmp_path / sub)
        paths.append(mod.create_and_save_embeds(
            opt, ["golden retriever", "organ"]))
    # multi-word labels are split into words before the include filter
    assert set(recorded["included"]) == {"golden", "retriever", "organ"}
    assert recorded["dim"] == 500
    assert paths[1] == os.path.join(str(tmp_path / "port"),
                                    "miniImageNet_dim500.pickle")
    got = _load(paths[1])
    assert set(got) == {"golden", "retriever", "organ"}
    assert all(isinstance(v, np.ndarray) and v.shape == (500,)
               for v in got.values())
    _same_pickles(_load(paths[0]), got)
    # the port's get_embeds consumes the pickle this tool writes
    from subspace_reg_tpu_torch.models.embeds import get_embeds
    e = get_embeds(paths[1], ["golden retriever"], 500)
    np.testing.assert_allclose(e[0], (got["golden"] + got["retriever"]) / 2,
                               rtol=1e-6)


def test_create_and_save_embeds_idempotent(tmp_path, capsys):
    """An existing pickle short-circuits (reference util.py:58-60): no
    torchnlp import, the JAX module's message."""
    opt = Opt()
    opt.word_embed_path = str(tmp_path)
    pth = os.path.join(str(tmp_path), "miniImageNet_dim500.pickle")
    with open(pth, "wb") as f:
        pickle.dump({"x": np.zeros(500)}, f)
    assert tools.create_and_save_embeds(opt, ["x"]) == pth
    port = capsys.readouterr().out
    assert jax_tools.create_and_save_embeds(opt, ["x"]) == pth
    assert port == capsys.readouterr().out == f"Found {pth}.\n"


def test_create_and_save_embeds_missing_dependency(tmp_path, monkeypatch):
    """Without torchnlp the tool points at the reference's shipped pickle
    assets, as the JAX module does."""
    monkeypatch.setitem(sys.modules, "torchnlp", None)
    messages = []
    for mod in (jax_tools, tools):
        opt = Opt()
        opt.word_embed_path = str(tmp_path / "nope")
        with pytest.raises(RuntimeError, match="pre-generated") as err:
            mod.create_and_save_embeds(opt, ["cat"])
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def _install_fake_transformers(monkeypatch, calls):
    """A tokenizer of character codes and a masked LM whose hidden layer
    l is a seeded function of the tokens; WordNet's first synset defines
    each name."""
    class Tokenizer:
        def __call__(self, text, return_tensors):
            assert return_tensors == "pt"
            calls.append(text)
            return {"input_ids": torch.tensor([[ord(c) for c in text]])}

    class Model:
        def __call__(self, input_ids):
            g = torch.Generator().manual_seed(int(input_ids.sum()))
            t = input_ids.shape[1]
            hidden = [torch.randn((1, t, 768), generator=g)
                      for _ in range(13)]
            return torch.zeros((1, t, 10)), tuple(hidden)

    def tok_from(name):
        assert name == "bert-base-cased"
        return Tokenizer()

    def model_from(name, output_hidden_states):
        assert name == "bert-base-cased" and output_hidden_states
        return Model()

    tf = types.ModuleType("transformers")
    tf.AutoTokenizer = types.SimpleNamespace(from_pretrained=tok_from)
    tf.AutoModelForMaskedLM = types.SimpleNamespace(
        from_pretrained=model_from)

    class Synset:
        def __init__(self, name):
            self.name = name

        def definition(self):
            return f"a kind of {self.name.replace('_', ' ')}"

    nltk = types.ModuleType("nltk")
    corpus = types.ModuleType("nltk.corpus")
    corpus.wordnet = types.SimpleNamespace(
        synsets=lambda name: [Synset(name), Synset("other")])
    nltk.corpus = corpus
    monkeypatch.setitem(sys.modules, "transformers", tf)
    monkeypatch.setitem(sys.modules, "nltk", nltk)
    monkeypatch.setitem(sys.modules, "nltk.corpus", corpus)


@pytest.mark.parametrize("prefix", [True, False])
def test_create_and_save_descriptions_matches_jax(tmp_path, monkeypatch,
                                                  prefix):
    """The description pickle ({class: ndarray(768)}, the layer's mean over
    tokens of the first synset's definition, the label prefixed or not)
    under the reference's file name, equal to the JAX module's; an
    existing pickle is reused without loading a model."""
    calls = []
    _install_fake_transformers(monkeypatch, calls)
    vocab = ["golden retriever", "organ", "house finch"]
    out = []
    for mod, sub in ((jax_tools, "jax"), (tools, "port")):
        opt = Opt()
        opt.prefix_label = prefix
        opt.description_embed_path = str(tmp_path / sub)
        out.append(mod.create_and_save_descriptions(opt, vocab))
    assert os.path.basename(out[1]) == (
        f"miniImageNet_bert-base-cased_layer6_prefix_{prefix}.pickle")
    first = "golden retriever " if prefix else ""
    assert calls[3] == first + "a kind of golden retriever"
    assert calls[:3] == calls[3:]
    got = _load(out[1])
    assert list(got) == vocab
    assert all(v.shape == (768,) for v in got.values())
    _same_pickles(_load(out[0]), got)
    monkeypatch.setitem(sys.modules, "transformers", None)
    opt = Opt()
    opt.prefix_label = prefix
    opt.description_embed_path = str(tmp_path / "port")
    assert tools.create_and_save_descriptions(opt, vocab) == out[1]
