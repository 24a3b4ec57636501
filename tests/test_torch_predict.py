"""The port's serving API (subspace_reg_tpu_torch/engine/predict.py)
against the JAX package's ``make_predict_fn`` on carried weights: a narrow
backbone at 16 px and a padded head, 12 uint8 images made from a seed;
labels equal, probabilities within 1e-5, and ``decode_labels`` as
tests/test_predict.py holds it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from subspace_reg_tpu.engine.predict import make_predict_fn as jax_predict
from subspace_reg_tpu.models import head as jax_head
from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet

from subspace_reg_tpu_torch.engine.predict import (decode_labels,
                                                   make_predict_fn)
from subspace_reg_tpu_torch.models.head import Head
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.weights import from_jax_variables

WIDTHS = (8, 16, 24, 32)


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
def test_predict_matches_jax(bias):
    jbb = JaxResNet(n_blocks=(1, 1, 1, 1), drop_rate=0.1, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    variables = jbb.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                         train=False)
    jhead = jax_head.init_head(jax.random.PRNGKey(1), 7, in_dim=WIDTHS[-1],
                               with_bias=bias, max_classes=12)
    tbb = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.1, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    tbb.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, dict(variables))))
    thead = Head(weight=torch.from_numpy(np.array(jhead.weight)),
                 bias=(torch.from_numpy(np.array(jhead.bias)) if bias
                       else None), n_active=7)
    imgs = np.random.RandomState(0).randint(
        0, 256, (12, 16, 16, 3)).astype(np.uint8)
    want_l, want_p = jax_predict(jbb, variables, jhead)(jnp.asarray(imgs))
    tbb.train()
    labels, probs = make_predict_fn(tbb, thead, device="cpu")(imgs)
    assert labels.shape == (12,) and probs.shape == (12, 12)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_p), atol=1e-5)
    assert np.all(labels.numpy() < 7)              # padded rows masked
    # a torch batch gives the same; the caller's module keeps its mode
    labels2, _ = make_predict_fn(tbb, thead, device="cpu")(
        torch.from_numpy(imgs))
    assert torch.equal(labels, labels2) and tbb.training


def test_decode_labels():
    names = decode_labels(torch.tensor([0, 3, 6]),
                          [f"class {i}" for i in range(100)],
                          training_classes={i + 40: i for i in range(7)})
    assert names == ["class 40", "class 43", "class 46"]
    # base row 0 maps back to original class 40
    assert decode_labels([0], [f"c{i}" for i in range(100)],
                         {40: 0})[0] == "c40"
    # an index past the names, and an empty name, print the index
    assert decode_labels([5, 120], ["a", "b", "c", "d", "e", ""]) == [
        "5", "120"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal "
                    "on a machine without a card")
def test_predict_runs_on_cuda_unless_asked_for_cpu():
    tbb = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.0, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    thead = Head(weight=torch.zeros(4, WIDTHS[-1]), bias=None, n_active=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_predict_fn(tbb, thead)
