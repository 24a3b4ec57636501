"""The port's ResNetRFS against the flax backbone at f32: eval features,
train-mode features with and without a sample mask, the updated running
statistics and the block counters, on the same weights (carried over with
``weights.from_jax_variables``) and the same seeded inputs.  atol 1e-4:
both sides run f32 convolutions and the single-pass BN variance
E[x^2]-E[x]^2, whose cancellation amplifies the different sum orders.

Also one eval forward of the full-width resnet18 at 84 px, and the
dropout / DropBlock keep rates and the DropBlock gamma ramp of
models/resnet.py:111-122."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet
from subspace_reg_tpu.models.resnet import resnet18 as jax_resnet18
from subspace_reg_tpu_torch.models.factory import create_model
from subspace_reg_tpu_torch.models.layers import apply_dropblock, dropout
from subspace_reg_tpu_torch.models.resnet import ResNetRFS, dropblock_gamma
from subspace_reg_tpu_torch.weights import from_jax_variables

WIDTHS = (8, 16, 24, 32)
ATOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def pair():
    """resnet18 block layout (1, 1, 2, 2) at narrow widths: exercises the
    multi-block stages, their positional quirk and the downsample keys."""
    jbb = JaxResNet(n_blocks=(1, 1, 2, 2), drop_rate=0.0, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    variables = jbb.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)),
                         train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    # non-trivial running statistics, so eval mode is a real test
    r = np.random.RandomState(1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: (v + 0.1 * r.rand(*v.shape)).astype(np.float32),
        variables["batch_stats"])
    tbb = ResNetRFS(n_blocks=(1, 1, 2, 2), drop_rate=0.0, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    tbb.load_state_dict(from_jax_variables(variables))
    x = np.random.RandomState(2).randn(6, 16, 16, 3).astype(np.float32)
    return jbb, variables, tbb, x


def test_eval_features_match_flax(pair):
    jbb, variables, tbb, x = pair
    ref = np.asarray(jbb.apply(variables, jnp.asarray(x), train=False))
    got = tbb.eval()(_nchw(x)).detach().numpy()
    assert got.shape == ref.shape == (6, WIDTHS[-1])
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_train_forward_stats_and_counters_match_flax(pair, masked):
    jbb, variables, tbb0, x = pair
    import copy
    tbb = copy.deepcopy(tbb0).train()
    mask = None
    if masked:
        # a padded replay buffer: only the first 4 of 6 rows are real
        mask = np.asarray([1, 1, 1, 1, 0, 0], np.float32)
    ref, mut = jbb.apply(variables, jnp.asarray(x), train=True,
                         sample_mask=None if mask is None else
                         jnp.asarray(mask),
                         mutable=["batch_stats", "counters"])
    got = tbb(_nchw(x), sample_mask=None if mask is None else
              torch.from_numpy(mask)).detach().numpy()
    rows = slice(0, 4) if masked else slice(None)
    np.testing.assert_allclose(got[rows], np.asarray(ref)[rows], atol=ATOL,
                               rtol=0)
    new_sd = from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": variables["params"], **mut}))
    sd = tbb.state_dict()
    n_stats = 0
    for k, v in new_sd.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=ATOL,
                                       rtol=0, err_msg=k)
            n_stats += 1
        elif k.endswith("num_batches_tracked"):
            assert int(sd[k]) == int(v) == 1, k
    assert n_stats == 2 * (3 * 6 + 4)       # 6 blocks, 4 with downsample


def test_eval_forward_leaves_counters_and_stats(pair):
    _, _, tbb, x = pair
    before = {k: v.clone() for k, v in tbb.state_dict().items()}
    tbb.eval()(_nchw(x))
    for k, v in tbb.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_full_width_resnet18_eval_at_84px():
    jbb = jax_resnet18(avg_pool=True, drop_rate=0.1, no_dropblock=True)
    variables = jax.tree_util.tree_map(np.asarray, dict(jbb.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 84, 84, 3)), train=False)))
    class O:
        no_dropblock = True
    tbb = create_model("resnet18", O())
    tbb.load_state_dict(from_jax_variables(variables))
    x = np.random.RandomState(4).randn(2, 84, 84, 3).astype(np.float32)
    ref = np.asarray(jbb.apply(variables, jnp.asarray(x), train=False))
    got = tbb.eval()(_nchw(x)).detach().numpy()
    assert got.shape == (2, 640)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("bs,feat", [(1, 5), (5, 11), (1, 3)])
def test_dropblock_gamma_ramp(bs, feat):
    """keep_rate = max(1 - drop_rate/(20*2000)*nbt, 1 - drop_rate) and
    gamma = (1-keep)/bs^2 * f^2/(f-bs+1)^2, evaluated in jnp f32 as
    models/resnet.py:115-119 does."""
    drop_rate = 0.1
    for nbt in (0, 1, 7, 1000, 39999, 40000, 10 ** 6):
        keep = jnp.maximum(1.0 - drop_rate / (20 * 2000)
                           * jnp.asarray(nbt, jnp.int32).astype(jnp.float32),
                           1.0 - drop_rate)
        ref = float((1.0 - keep) / bs ** 2 * feat ** 2
                    / (feat - bs + 1) ** 2)
        got = float(dropblock_gamma(drop_rate, torch.tensor(nbt), feat, bs))
        assert got == pytest.approx(ref, rel=1e-6, abs=1e-12)


def test_dropblock_mask_geometry_matches_jax():
    """Seed (i, j) zeroes the bs x bs block (i..i+bs-1, j..j+bs-1), and the
    output is rescaled by numel/count_ones (layers.py:145-162)."""
    bs = 3
    r = np.random.RandomState(5)
    x = r.randn(2, 4, 9, 9).astype(np.float32)
    seeds = (r.rand(2, 4, 9 - bs + 1, 9 - bs + 1) < 0.1).astype(np.float32)
    canvas = jnp.pad(jnp.asarray(seeds.transpose(0, 2, 3, 1)),
                     ((0, 0), (0, bs - 1), (0, bs - 1), (0, 0)))
    block = jax.lax.reduce_window(canvas, -jnp.inf, jax.lax.max,
                                  (1, bs, bs, 1), (1, 1, 1, 1),
                                  ((0, 0), (bs - 1, 0), (bs - 1, 0), (0, 0)))
    mask = 1.0 - jnp.maximum(block, 0.0)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    ref = np.asarray(mask * xj * (mask.size / jnp.sum(mask)))
    got = apply_dropblock(torch.from_numpy(x), torch.from_numpy(seeds), bs)
    np.testing.assert_allclose(got.numpy(), ref.transpose(0, 3, 1, 2),
                               rtol=1e-6, atol=1e-6)


def test_dropout_and_dropblock_keep_rates():
    g = torch.Generator().manual_seed(0)
    x = torch.ones((64, 16, 12, 12))
    y = dropout(x, 0.1, g)
    kept = (y != 0).float().mean().item()
    assert kept == pytest.approx(0.9, abs=0.01)
    assert torch.allclose(y[y != 0], torch.tensor(1.0 / 0.9))
    # a DropBlock block of the golden resnet18 (block size 1 under
    # --no_dropblock) drops a gamma share of the elements
    from subspace_reg_tpu_torch.models.layers import dropblock
    gamma = dropblock_gamma(0.1, torch.tensor(20000), 12, 1)
    z = dropblock(x, gamma, 1, g)
    assert (z == 0).float().mean().item() == pytest.approx(float(gamma),
                                                           abs=0.01)


def test_counters_drive_the_ramp():
    """Train forwards advance each block's counter; eval forwards do not."""
    bb = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.1, no_dropblock=True,
                   widths=WIDTHS)
    x = torch.randn(2, 3, 16, 16)
    g = torch.Generator().manual_seed(0)
    bb.train()(x, generator=g)
    bb.train()(x, generator=g)
    bb.eval()(x)
    assert all(int(b.num_batches_tracked) == 2
               for li in range(1, 5) for b in getattr(bb, f"layer{li}"))
