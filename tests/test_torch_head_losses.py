"""Head, losses, pull and optimizer of the port against the JAX package:
values and gradients (torch autograd vs jax.grad) on the same seeded numpy
inputs, f32, rtol 1e-5 / atol 1e-6 (single reductions in another order);
torch.topk's lower-index-wins tie rule; the growth bounds and the
roll-then-select growth; the optimizer's first step against the optax
chain."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.models import head as jhead
from subspace_reg_tpu.models import lang_puller as jlp
from subspace_reg_tpu.ops import losses as jl
from subspace_reg_tpu.utils.optim import get_optim as jax_get_optim

from subspace_reg_tpu_torch.models import head as thead
from subspace_reg_tpu_torch.models import lang_puller as tlp
from subspace_reg_tpu_torch.ops import losses as tl
from subspace_reg_tpu_torch.utils.optim import get_optim

RTOL, ATOL = 1e-5, 1e-6


def _both(fn_jax, fn_torch, *arrays, argnums=0):
    """Value and gradient w.r.t. argument ``argnums`` in both packages."""
    ja = [jnp.asarray(a) for a in arrays]
    jv, jg = jax.value_and_grad(fn_jax, argnums=argnums)(*ja)
    ta = [torch.from_numpy(np.array(a)) for a in arrays]
    ta[argnums].requires_grad_(True)
    tv = fn_torch(*ta)
    (tg,) = torch.autograd.grad(tv, [ta[argnums]])
    return (float(jv), np.asarray(jg)), (float(tv.detach()), tg.numpy())


def _close(pair):
    (jv, jg), (tv, tg) = pair
    assert tv == pytest.approx(jv, rel=RTOL, abs=ATOL)
    np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL)


@pytest.fixture
def r():
    return np.random.RandomState(0)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(r, masked):
    logits = r.randn(12, 20).astype(np.float32)
    logits[:, 15:] = thead.NEG_INF                  # inactive classes
    y = r.randint(0, 15, 12)
    mask = (np.arange(12) < 7).astype(np.float32)
    m = mask if masked else None
    _close(_both(
        lambda lg: jl.cross_entropy(lg, jnp.asarray(y),
                                    None if m is None else jnp.asarray(m)),
        lambda lg: tl.cross_entropy(lg, torch.from_numpy(y),
                                    None if m is None else
                                    torch.from_numpy(m)),
        logits))


def test_cross_entropy_empty_mask_is_zero():
    lg = torch.randn(4, 5)
    loss = tl.cross_entropy(lg, torch.zeros(4, dtype=torch.long),
                            torch.zeros(4))
    assert float(loss) == 0.0


@pytest.mark.parametrize("with_bias", [False, True])
def test_regloss(r, with_bias):
    w = r.randn(30, 16).astype(np.float32)
    w0 = w + 0.1 * r.randn(30, 16).astype(np.float32)
    b = r.randn(30).astype(np.float32)
    b0 = b + 0.1 * r.randn(30).astype(np.float32)
    if with_bias:
        for arg in (0, 2):                          # d/dW and d/db
            _close(_both(
                lambda w_, w0_, b_, b0_: jl.regloss(0.2, w_, w0_, 20, b_,
                                                    b0_),
                lambda w_, w0_, b_, b0_: tl.regloss(0.2, w_, w0_, 20, b_,
                                                    b0_),
                w, w0, b, b0, argnums=arg))
    else:
        _close(_both(lambda w_, w0_: jl.regloss(0.2, w_, w0_, 20),
                     lambda w_, w0_: tl.regloss(0.2, w_, w0_, 20), w, w0))


def test_regloss_zero_subgradient_at_origin(r):
    """W[:60] == W0 at session 0's first step: the norm's gradient is 0,
    not NaN, in both packages."""
    w = r.randn(30, 16).astype(np.float32)
    (jv, jg), (tv, tg) = _both(lambda a: jl.regloss(0.2, a, jnp.asarray(w),
                                                   20),
                               lambda a: tl.regloss(0.2, a,
                                                    torch.from_numpy(w), 20),
                               w)
    assert jv == tv == 0.0
    assert np.all(tg == 0) and np.all(jg == 0)


@pytest.mark.parametrize("n_reserved", [0, 5, 10])
def test_reglossnovel(r, n_reserved):
    w = r.randn(40, 16).astype(np.float32)
    reserved = r.randn(20, 16).astype(np.float32)
    _close(_both(
        lambda a: jl.reglossnovel(0.1, a, jnp.asarray(reserved), 20,
                                  n_reserved),
        lambda a: tl.reglossnovel(0.1, a, torch.from_numpy(reserved), 20,
                                  n_reserved),
        w))


def test_reglossnovel_refuses_bias(r):
    with pytest.raises(NotImplementedError):
        tl.reglossnovel(0.1, torch.zeros(4, 2), torch.zeros(2, 2), 2, 1,
                        bias=torch.zeros(4))


def test_projected_weight_and_pull_loss(r):
    """The subspace pull of the golden config: gamma*||P(cur) - cur||^2 with
    P the projection onto span(W0[:base]) — value and gradient w.r.t. the
    current rows (the projector itself is constant)."""
    base = r.randn(10, 24).astype(np.float32)
    cur = r.randn(5, 24).astype(np.float32)
    p = np.asarray(jlp.projected_weight(jnp.asarray(base), jnp.asarray(cur)))
    pt = tlp.projected_weight(torch.from_numpy(base), torch.from_numpy(cur))
    np.testing.assert_allclose(pt.numpy(), p, rtol=1e-4, atol=1e-5)
    _close(_both(
        lambda c: jlp.pull_loss(1.0, jlp.projected_weight(jnp.asarray(base),
                                                          c), c),
        lambda c: tlp.pull_loss(1.0, tlp.projected_weight(
            torch.from_numpy(base), c), c),
        cur))
    mask = (np.arange(5) < 3).astype(np.float32)
    target = r.randn(5, 24).astype(np.float32)
    _close(_both(
        lambda c: jlp.pull_loss(0.5, jnp.asarray(target), c,
                                jnp.asarray(mask)),
        lambda c: tlp.pull_loss(0.5, torch.from_numpy(target), c,
                                torch.from_numpy(mask)),
        cur))


def test_accuracy_topk_tie_rule():
    """torch.topk breaks exact ties by the LOWER index: a tied class with a
    smaller index outranks the true class, a tied larger one does not."""
    logits = np.zeros((4, 8), np.float32)
    logits[0, [2, 5]] = 1.0          # label 5 tied with 2 -> top-1 miss
    logits[1, [2, 5]] = 1.0          # label 2 tied with 5 -> top-1 hit
    logits[2, :7] = 1.0              # label 6 tied with 0..5 -> rank 6
    logits[3, 3] = 2.0
    logits[3, 1] = 1.0               # label 1 second -> top-5 hit
    logits[:, 7] = thead.NEG_INF
    y = np.asarray([5, 2, 6, 1])
    ref = [float(v) for v in jl.accuracy_topk(jnp.asarray(logits),
                                              jnp.asarray(y))]
    got = [float(v) for v in tl.accuracy_topk(torch.from_numpy(logits),
                                              torch.from_numpy(y))]
    assert got == ref == [25.0, 75.0]


def test_growth_bounds_and_roll_then_select():
    """A grown row is drawn U(-1/sqrt(in), 1/sqrt(in)); growth places row j
    of the fresh block at n_active + j (models/head.py:84-110)."""
    g = torch.Generator().manual_seed(0)
    w, b = thead.torch_linear_init(100, 640, True, g)
    k = 1.0 / np.sqrt(640)
    assert float(w.abs().max()) <= k and float(b.abs().max()) <= k
    assert float(w.abs().max()) > 0.99 * k
    h0 = thead.init_head(60, 640, with_bias=True, max_classes=100,
                         generator=g)
    assert torch.all(h0.weight[60:] == 0) and torch.all(h0.bias[60:] == 0)
    assert float(h0.weight[:60].abs().max()) <= k

    key = jax.random.PRNGKey(7)
    jh = jhead.Head(weight=jnp.asarray(h0.weight.numpy()),
                    bias=jnp.asarray(h0.bias.numpy()), n_active=60)
    jgrown = jhead.augment(jh, key, 5)
    new_w, new_b = jhead._torch_linear_init(key, 100, 640, True)
    tgrown = thead.augment(h0, torch.from_numpy(np.array(new_w)),
                           torch.from_numpy(np.array(new_b)), 5)
    assert tgrown.n_active == int(jgrown.n_active) == 65
    np.testing.assert_array_equal(tgrown.weight.numpy(),
                                  np.asarray(jgrown.weight))
    np.testing.assert_array_equal(tgrown.bias.numpy(),
                                  np.asarray(jgrown.bias))


@pytest.mark.parametrize("adam", [False, True])
def test_optimizer_first_step_matches_optax(r, adam):
    class Opt:
        learning_rate, weight_decay, momentum = 0.002, 5e-4, 0.9
    Opt.adam = adam
    w = r.randn(10, 6).astype(np.float32)
    g = r.randn(10, 6).astype(np.float32)
    tx = jax_get_optim(Opt)
    params = {"w": jnp.asarray(w)}
    upd, _ = tx.update({"w": jnp.asarray(g)}, tx.init(params), params)
    ref = np.asarray(params["w"] + upd["w"])
    spec = get_optim(Opt)
    assert spec.weight_decay == (0.0005 if adam else 5e-4)
    new, mom, nu = spec.first_step({"w": torch.from_numpy(w)},
                                   {"w": torch.from_numpy(g)})
    np.testing.assert_allclose(new["w"].numpy(), ref, rtol=1e-6, atol=1e-7)
    assert (nu is not None) == adam
