"""The port's distillation modules (subspace_reg_tpu_torch/distill) against
the JAX package's (subspace_reg_tpu/distill) on the CPU, on the same
inputs made from numpy seeds, with JAX's own random draws injected.

Tolerances:
* the seven criteria: rtol 1e-5, atol 1e-7;
* alias tables: equal exactly; a draw from injected (j, u): equal exactly;
* the embed heads through the weight bridge: rtol 1e-5 (the trees round
  trip exactly);
* the NCE contrast in every mode, the full-bank contrast and its loss:
  outputs and Z at rtol 1e-5; updated bank rows at atol 1e-6; untouched
  rows bit-identical; the gradients through both views at rtol 1e-4,
  atol 1e-7 (the contrast's exp(./0.07) scales the dot products'
  rounding by 14).
The reference's torch NCEAverage contract (tests/test_nce_pipeline.py's
oracle) holds the port as it holds the JAX function (rtol 2e-5).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.distill import alias as jalias
from subspace_reg_tpu.distill import criterion as jcrit
from subspace_reg_tpu.distill import embed as jembed
from subspace_reg_tpu.distill import nce as jnce
from subspace_reg_tpu_torch import distill
from subspace_reg_tpu_torch.distill import criterion as crit
from subspace_reg_tpu_torch.distill import embed as pembed
from subspace_reg_tpu_torch.distill import nce as pnce
from test_nce_pipeline import _torch_nce_average

RTOL, ATOL = 1e-5, 1e-7
N_DATA, DIM, K, B = 40, 8, 16, 8


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


def test_exports_mirror_the_jax_package():
    from subspace_reg_tpu import distill as jdistill
    jax_names = {n for n in dir(jdistill) if not n.startswith("_")} - {
        "alias", "criterion", "embed", "nce"}
    assert jax_names <= set(distill.__all__)


@pytest.mark.parametrize("name", [
    "DistillKL", "nce_loss", "nce_softmax_loss", "attention_loss",
    "hint_loss", "label_smoothing_loss", "bce_with_logits_loss"])
def test_criteria_match_jax(name):
    r = np.random.RandomState(0)
    s = r.standard_normal((B, 10)).astype(np.float32)
    t = r.standard_normal((B, 10)).astype(np.float32)
    y = r.randint(0, 10, B)
    pos = r.uniform(0.01, 3.0, (B, K + 1)).astype(np.float32)
    if name == "DistillKL":
        args_j, args_t = (s, t, 4.0), (_t(s), _t(t), 4.0)
    elif name == "nce_loss":
        args_j, args_t = (pos, N_DATA), (_t(pos), N_DATA)
    elif name == "nce_softmax_loss":
        args_j, args_t = (s,), (_t(s),)
    elif name == "attention_loss":
        # NHWC maps for JAX, the same maps NCHW for the port
        fs = [r.standard_normal((2, 6, 6, 4)).astype(np.float32)
              for _ in range(2)]
        ft = [r.standard_normal((2, 6, 6, 4)).astype(np.float32)
              for _ in range(2)]
        nchw = lambda fl: [_t(f.transpose(0, 3, 1, 2)) for f in fl]  # noqa
        args_j, args_t = (fs, ft), (nchw(fs), nchw(ft))
    elif name == "hint_loss":
        args_j, args_t = (s, t), (_t(s), _t(t))
    elif name == "label_smoothing_loss":
        args_j, args_t = (s, y, 0.1), (_t(s), _t(y), 0.1)
    else:
        args_j, args_t = (s, y, 10), (_t(s), _t(y), 10)
    want = getattr(jcrit, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                  else [jnp.asarray(x) for x in a]
                                  if isinstance(a, list) else a
                                  for a in args_j])
    got = getattr(crit, name)(*args_t)
    _close(got, want, msg=name)
    assert crit.EPS == jcrit.EPS


def test_alias_tables_and_injected_draws_equal_jax():
    r = np.random.RandomState(1)
    probs = r.uniform(0.0, 1.0, 37)
    probs[[3, 11]] = 0.0
    js = jalias.AliasSampler(probs)
    ps = distill.AliasSampler(probs, device="cpu")
    np.testing.assert_array_equal(ps.prob.numpy(), np.asarray(js.prob))
    np.testing.assert_array_equal(ps.alias.numpy(), np.asarray(js.alias))
    key = jax.random.PRNGKey(3)
    shape = (6, 50)
    want = np.asarray(js.draw(key, shape))
    kk, kb = jax.random.split(key)
    j = jax.random.randint(kk, shape, 0, js.k)
    u = jax.random.uniform(kb, shape)
    got = ps.draw_from(_t(j), _t(u))
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own draws follow the distribution
    freq = np.bincount(ps.draw(torch.Generator().manual_seed(0),
                               (200_000,)).numpy(), minlength=37) / 2e5
    np.testing.assert_allclose(freq, probs / probs.sum(), atol=0.01)


@pytest.mark.parametrize("name", ["Embed", "LinearEmbed", "MLPEmbed"])
def test_embed_heads_through_the_bridge(name):
    r = np.random.RandomState(2)
    x = r.standard_normal((B, 32)).astype(np.float32)
    jm = getattr(jembed, name)(dim_out=DIM)
    params = jax.tree.map(np.asarray,
                          jm.init(jax.random.PRNGKey(0), jnp.asarray(x))[
                              "params"])
    pm = getattr(pembed, name)(32, DIM)
    pembed.embed_from_jax(pm, params)
    want = jm.apply({"params": params}, jnp.asarray(x))
    _close(pm(_t(x)), want, atol=1e-7, msg=name)
    back = pembed.embed_to_jax(pm)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_embed_init_is_flax_lecun_normal():
    """Kernel ~ N(0, 1/fan_in) truncated at two standard deviations of the
    untruncated normal, bias 0, as flax's Dense draws them."""
    fan_in, out = 640, 512
    m = pembed.Embed(fan_in, out, torch.Generator().manual_seed(0))
    w = m.linear.weight.detach().numpy().T
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, out)))
    assert w.shape == ref.shape
    assert abs(w.std() - ref.std()) < 0.02 * ref.std()
    assert abs(np.abs(w).max() - np.abs(ref).max()) < 0.05 * ref.std()
    assert not m.linear.bias.detach().any()


def _unit(r, n, d):
    v = r.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _jax_state(seed=3):
    return jnce.init_nce_average(jax.random.PRNGKey(seed), N_DATA, DIM, K,
                                 temperature=0.07, momentum=0.5)


def _port_state(js):
    return pnce.NCEAverageState.from_jax(
        jax.tree.map(np.asarray, {k: getattr(js, k) for k in (
            "memory_l", "memory_ab", "z_l", "z_ab", "params")}), "cpu")


def _check_state(got, want, y, before):
    """Z at rtol 1e-5, the updated rows at atol 1e-6, the other rows
    bit-identical to ``before``."""
    for zk in ("z_l", "z_ab"):
        _close(getattr(got, zk), getattr(want, zk), msg=zk)
    rows = np.zeros(N_DATA, bool)
    rows[y] = True
    for bank in ("memory_l", "memory_ab"):
        g = getattr(got, bank).numpy()
        np.testing.assert_allclose(g[rows], np.asarray(getattr(want, bank))[
            rows], rtol=0, atol=1e-6, err_msg=bank)
        np.testing.assert_array_equal(g[~rows],
                                      getattr(before, bank).numpy()[~rows])


@pytest.mark.parametrize("mode", ["auto", "paired", "gather", "matmul"])
def test_nce_forward_matches_jax(mode):
    """Two calls (the first sets Z, the second contrasts against the
    updated banks), outputs, Z, banks and the gradients of the NCE loss
    through both views."""
    r = np.random.RandomState(4)
    js = _jax_state()
    ps = _port_state(js)
    y = r.choice(N_DATA, B, replace=False)
    for call in range(2):
        l, ab = _unit(r, B, DIM), _unit(r, B, DIM)
        idx = r.randint(0, N_DATA, (B, K + 1))
        idx[:, 0] = y

        def jloss(l_, ab_, st=js):
            o_l, o_ab, st2 = jnce.nce_forward(
                st, None, l_, ab_, jnp.asarray(y), jax.random.PRNGKey(0),
                idx=jnp.asarray(idx), mode=mode)
            return (jcrit.nce_loss(o_l, N_DATA) + jcrit.nce_loss(o_ab, N_DATA),
                    (o_l, o_ab, st2))
        (_, (o_l, o_ab, js2)), (gl, gab) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(l),
                                                 jnp.asarray(ab))
        lt, abt = _t(l).requires_grad_(), _t(ab).requires_grad_()
        out_l, out_ab, ps2 = pnce.nce_forward(ps, lt, abt, _t(y),
                                              idx=_t(idx), mode=mode)
        (crit.nce_loss(out_l, N_DATA) + crit.nce_loss(out_ab, N_DATA)
         ).backward()
        _close(out_l, o_l, msg=f"out_l {call}")
        _close(out_ab, o_ab, msg=f"out_ab {call}")
        _check_state(ps2, js2, y, ps)
        _close(lt.grad, gl, rtol=1e-4, msg="grad l")
        _close(abt.grad, gab, rtol=1e-4, msg="grad ab")
        assert not ps2.memory_l.requires_grad
        js, ps = js2, ps2
    with pytest.raises(ValueError, match="unknown NCE contrast mode"):
        pnce.nce_forward(ps, lt, abt, _t(y), idx=_t(idx), mode="pared")


def test_nce_forward_draws_negatives_with_the_sampler():
    r = np.random.RandomState(5)
    ps = _port_state(_jax_state())
    y = np.arange(B)
    sampler = distill.AliasSampler(np.ones(N_DATA), device="cpu")
    out_l, out_ab, _ = pnce.nce_forward(
        ps, _t(_unit(r, B, DIM)), _t(_unit(r, B, DIM)), _t(y),
        sampler=sampler, generator=torch.Generator().manual_seed(0))
    assert out_l.shape == out_ab.shape == (B, K + 1)
    assert torch.isfinite(out_l).all() and torch.isfinite(out_ab).all()


def test_full_bank_contrast_and_loss_match_jax():
    r = np.random.RandomState(6)
    js = _jax_state()
    ps = _port_state(js)
    y = r.choice(N_DATA, B, replace=False)
    for call in range(2):
        l, ab = _unit(r, B, DIM), _unit(r, B, DIM)
        o_l, o_ab, js2 = jnce.nce_forward_full(js, jnp.asarray(l),
                                               jnp.asarray(ab),
                                               jnp.asarray(y))
        out_l, out_ab, ps2 = pnce.nce_forward_full(ps, _t(l), _t(ab), _t(y))
        assert out_l.shape == (B, N_DATA)
        _close(out_l, o_l, msg=f"out_l {call}")
        _close(out_ab, o_ab, msg=f"out_ab {call}")
        _close(pnce.full_softmax_loss(out_l, _t(y)),
               jnce.full_softmax_loss(o_l, jnp.asarray(y)))
        _check_state(ps2, js2, y, ps)
        js, ps = js2, ps2


def test_nce_forward_holds_the_reference_torch_contract():
    """The reference's NCEAverage.forward written in torch
    (tests/test_nce_pipeline.py): Z from the first batch, then the
    momentum + renorm update at the positives."""
    n_data, dim, k, t, m = 40, 16, 6, 0.07, 0.5
    r = np.random.RandomState(0)
    js = jnce.init_nce_average(jax.random.PRNGKey(3), n_data, dim, k,
                               temperature=t, momentum=m)
    ps = pnce.NCEAverageState.from_jax(jax.tree.map(np.asarray, {
        f: getattr(js, f) for f in ("memory_l", "memory_ab", "z_l", "z_ab",
                                    "params")}), "cpu")
    l, ab = _unit(r, 5, dim), _unit(r, 5, dim)
    y = np.array([3, 9, 11, 20, 33])
    idx = r.randint(0, n_data, size=(5, k + 1))
    idx[:, 0] = y
    out_l, out_ab, ps2 = pnce.nce_forward(ps, _t(l), _t(ab), _t(y),
                                          idx=_t(idx))
    o_l, o_ab, mem_l, mem_ab, z_l, z_ab = _torch_nce_average(
        ps.memory_l, ps.memory_ab, l, ab, y, idx, k, t, m, -1.0, -1.0)
    for got, want in ((out_l, o_l), (out_ab, o_ab), (ps2.memory_l, mem_l),
                      (ps2.memory_ab, mem_ab), (ps2.z_l, z_l),
                      (ps2.z_ab, z_ab)):
        _close(got, want, rtol=2e-5, atol=0)
