"""The port's K2/K3 plain versions (subspace_reg_tpu_torch/ops/conv_fused.py)
against the JAX package's Pallas kernels run in interpret mode on the CPU
(``conv3x3_pair``, ``block_tail`` through ``paired``/``unpaired``), on the
same seeded bf16 inputs, plus ``fold_stats`` and ``bn_affine``.  On the CPU
the wrappers take the plain versions because the tensors lie on the CPU.

Tolerances:
* K2's y: within 1 bf16 ulp of the Pallas result, the ulp taken at no less
  than 2^-8 of the summed |terms| (``torch_support.k2_term_scale``): JAX
  accumulates in f32, the plain version in f64, and only near-cancelling
  outputs see the f32 order.  The statistics (sums over the rounded y):
  rtol 1e-4 of the sum of |y|.
* K3: bit-identical pooled map and record, on random inputs and on inputs
  with ties and exact zeros.
* ``fold_stats``: exact.  ``bn_affine``: 2 f32 ulps -- XLA's CPU rsqrt and
  torch's differ by one ulp on about a third of inputs (neither is
  correctly rounded); the rest of the formula is the same f32 arithmetic.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from subspace_reg_tpu.ops.pallas import conv_fused as jcf
from subspace_reg_tpu_torch.ops import conv_fused as cf
from torch_support import bf16_ulp_diff, k2_term_scale

CL = torch.channels_last


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _nchw(a_nhwc, dtype=torch.bfloat16):
    t = torch.from_numpy(np.ascontiguousarray(a_nhwc.transpose(0, 3, 1, 2)))
    return t.to(dtype).contiguous(memory_format=CL)


def _nhwc(t):
    return t.to(torch.float32).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("cin,cout,prologue", [
    (8, 16, False),      # conv1 of a block: no prologue
    (8, 8, True),        # conv2/conv3: folded BN + LeakyReLU prologue
    (3, 8, False),       # the image entry: three channels
    (16, 24, True),
])
def test_k2_plain_matches_pallas_interpret(cin, cout, prologue):
    r = np.random.RandomState(cin * 100 + cout)
    b, h, w = 2, 8, 12
    x = _bf16(r.standard_normal((b, h, w, cin)))
    wt = (r.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    aff = None
    if prologue:
        aff = ((r.uniform(0.5, 1.5, cin)).astype(np.float32),
               (0.1 * r.standard_normal(cin)).astype(np.float32))
    xj = jnp.asarray(x, jnp.bfloat16)
    wp = jcf.pack_weights_pair(jnp.asarray(wt).astype(jnp.bfloat16))
    jaff = None if aff is None else tuple(
        jnp.concatenate([jnp.asarray(v), jnp.asarray(v)]) for v in aff)
    yj, stj = jcf.conv3x3_pair(jcf.paired(xj), wp, affine=jaff,
                               relu_in=prologue, interpret=True)
    yj = np.asarray(jcf.unpaired(yj).astype(jnp.float32))
    stj = np.asarray(stj)
    stj = stj[:, :cout] + stj[:, cout:]

    xt = _nchw(x)
    w_oihw = torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1)))
    taff = None if aff is None else tuple(torch.from_numpy(v) for v in aff)
    y, st = cf.conv3x3_fused(xt, w_oihw, taff, relu_in=prologue)
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=CL)
    assert st.shape == (2, cout) and st.dtype == torch.float32

    floor = k2_term_scale(xt, w_oihw, taff, prologue)
    yj = torch.from_numpy(np.array(yj)).permute(0, 3, 1, 2)
    ulps, _ = bf16_ulp_diff(yj, y, floor)
    assert ulps <= 1.0, ulps
    yf = _nhwc(y).astype(np.float64)
    scale = np.stack([np.abs(yf).sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
    assert np.all(np.abs(st.numpy() - stj) <= 1e-4 * scale)


def _tail_case(r, c, ties):
    shape = (2, 8, 12, c)
    if ties:
        y3 = r.randint(-2, 3, shape).astype(np.float32)
        res = np.zeros(shape, np.float32)
        affs = [np.ones(c), np.zeros(c), np.ones(c), np.zeros(c)]
    else:
        y3, res = _bf16(r.standard_normal(shape)), _bf16(
            r.standard_normal(shape))
        affs = [r.uniform(0.5, 1.5, c), 0.1 * r.standard_normal(c),
                r.uniform(0.5, 1.5, c), 0.1 * r.standard_normal(c)]
    return y3, res, [np.asarray(a, np.float32) for a in affs]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("c", [8, 16])
def test_k3_plain_bit_identical_to_pallas_interpret(c, ties):
    r = np.random.RandomState(c + 7 * ties)
    y3, res, affs = _tail_case(r, c, ties)
    pj = [jnp.concatenate([jnp.asarray(a), jnp.asarray(a)]) for a in affs]
    oj, ij = jcf.block_tail(
        jcf.paired(jnp.asarray(y3, jnp.bfloat16)),
        jcf.paired(jnp.asarray(res, jnp.bfloat16)), (pj[0], pj[1]),
        (pj[2], pj[3]), paired_out=False, interpret=True)
    ta = [torch.from_numpy(a) for a in affs]
    out, idx = cf.block_tail(_nchw(y3), _nchw(res), (ta[0], ta[1]),
                             (ta[2], ta[3]))
    assert out.dtype == torch.bfloat16 and idx.dtype == torch.int8
    np.testing.assert_array_equal(_nhwc(out),
                                  np.asarray(oj.astype(jnp.float32)))
    np.testing.assert_array_equal(idx.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ij))
    if ties:
        # windows with ties and with a non-positive winner are exercised
        assert set(np.unique(np.asarray(ij) & 3)) == {0, 1, 2, 3}
        assert (np.asarray(ij) & 4).min() == 0


def test_fold_stats_and_bn_affine_match_jax():
    r = np.random.RandomState(3)
    c, n = 16, 2 * 8 * 12
    s1 = (r.standard_normal(c) * 10).astype(np.float32)
    s2 = (np.abs(r.standard_normal(c)) * 400 + s1 ** 2 / n).astype(
        np.float32)
    # a channel whose E[y^2]-E[y]^2 rounds below 0 clamps to 0
    s2[0] = s1[0] ** 2 / n * (1 - 1e-6)
    paired = np.concatenate([np.stack([s1, s2]), np.zeros((2, c),
                                                          np.float32)], 1)
    mj, vj = jcf.fold_stats(jnp.asarray(paired), n)
    m, v = cf.fold_stats(torch.from_numpy(np.stack([s1, s2])), n)
    np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vj))
    assert float(v[0]) == 0.0
    scale = r.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (0.1 * r.standard_normal(c)).astype(np.float32)
    aj, bj = jcf.bn_affine(mj, vj, jnp.asarray(scale), jnp.asarray(bias))
    a, b = cf.bn_affine(m, v, torch.from_numpy(scale),
                        torch.from_numpy(bias))
    aj, bj = np.asarray(aj)[:c], np.asarray(bj)[:c]
    np.testing.assert_allclose(a.numpy(), aj, rtol=2.4e-7, atol=0)
    tol = 2.4e-7 * (np.abs(m.numpy() * a.numpy()) + np.abs(bias))
    assert np.all(np.abs(b.numpy() - bj) <= tol)


def test_plain_versions_serve_f32_for_gradient_checks():
    """The working dtype is the input's: in f32 nothing rounds, and K2's
    output equals an f32 convolution of the prologue's output."""
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.standard_normal((2, 4, 6, 6)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((8, 4, 3, 3)).astype(np.float32))
    a, b = torch.rand(4) + 0.5, 0.1 * torch.randn(4)
    y, _ = cf.conv3x3_fused(x, w, (a, b), relu_in=True)
    z = x * a[None, :, None, None] + b[None, :, None, None]
    z = torch.where(z >= 0, z, 0.1 * z)
    ref = torch.nn.functional.conv2d(z, w, padding=1)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
