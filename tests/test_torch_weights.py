"""Weights carried between the packages: ``from_jax_variables`` is the exact
inverse of the JAX importer (``utils/torch_import.py::import_backbone``),
and a reference ``.pth`` written by ``torch.save`` loads through the port's
loader and the JAX ``import_checkpoint`` to the same eval features (f32,
atol 1e-4: two convolution implementations)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet
from subspace_reg_tpu.utils.torch_import import (import_backbone,
                                                 import_checkpoint)
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.weights import (from_jax_variables,
                                            load_checkpoint)

WIDTHS = (8, 16, 24, 32)


@pytest.fixture(scope="module")
def jax_model():
    jbb = JaxResNet(n_blocks=(1, 1, 2, 2), drop_rate=0.1, no_dropblock=True,
                    use_se=True, avg_pool=True, widths=WIDTHS)
    variables = jbb.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                         train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    r = np.random.RandomState(1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: (v + 0.1 * r.rand(*v.shape)).astype(np.float32),
        variables["batch_stats"])
    variables["counters"] = jax.tree_util.tree_map(
        lambda v: np.asarray(7, np.int32), variables["counters"])
    return jbb, variables


def test_round_trip_through_the_jax_importer(jax_model):
    """JAX tree -> torch state dict -> JAX importer gives back every
    parameter and statistic exactly (SE layers included)."""
    _, variables = jax_model
    sd = from_jax_variables(variables)
    back = import_backbone({k: v.numpy() for k, v in sd.items()})
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    for coll in ("params", "batch_stats"):
        a, b = flat(variables[coll]), flat(back[coll])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=k)
    model = ResNetRFS(n_blocks=(1, 1, 2, 2), drop_rate=0.1,
                      no_dropblock=True, use_se=True, widths=WIDTHS)
    model.load_state_dict(sd)                       # strict: no key missing
    assert all(int(b.num_batches_tracked) == 7
               for li in range(1, 5) for b in getattr(model, f"layer{li}"))


def test_pth_loads_to_the_same_features_in_both(jax_model, tmp_path):
    jbb, variables = jax_model
    sd = from_jax_variables({"params": variables["params"],
                             "batch_stats": variables["batch_stats"]})
    # a reference-format checkpoint: BatchNorm2d's own counters, a head
    r = np.random.RandomState(2)
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(3)
    sd["classifier.weight"] = torch.from_numpy(
        r.randn(60, WIDTHS[-1]).astype(np.float32))
    path = str(tmp_path / "resnet18_last.pth")
    torch.save({"model": sd, "epoch": 90,
                "training_classes": {i: i for i in range(60)},
                "label2human": [f"c{i}" for i in range(60)]}, path)

    state, head, meta = load_checkpoint(path, max_classes=100)
    model = ResNetRFS(n_blocks=(1, 1, 2, 2), drop_rate=0.1,
                      no_dropblock=True, use_se=True, widths=WIDTHS)
    model.load_state_dict(state)
    assert head.weight.shape == (100, WIDTHS[-1]) and head.n_active == 60
    assert head.bias is None and meta["has_bias"] is False
    assert meta["epoch"] == 90

    jvars, jhead, jmeta = import_checkpoint(path, max_classes=100,
                                            device=False)
    np.testing.assert_array_equal(head.weight.numpy(), jhead.weight)
    x = r.randn(3, 16, 16, 3).astype(np.float32)
    ref = np.asarray(jbb.apply({**jvars, "counters": variables["counters"]},
                               jnp.asarray(x), train=False))
    got = model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-4, rtol=0)
