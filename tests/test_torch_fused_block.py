"""The port's fused BasicBlock (subspace_reg_tpu_torch/ops/fused_block.py)
against the JAX package's ``fused_block_apply`` on the CPU (its Pallas
kernels in interpret mode), both backends, on the same weights (carried over
with ``weights.from_jax_variables``) and the same seeded input.

Tolerances:
* bf16 forward and ``BlockStats``: the pooled map bit-identical; the
  statistics within 4e-6 of their largest value (both sides take f32 sums
  of the same rounded conv outputs in another order, and the variance
  E[y^2] - mean^2 cancels);
* f32 gradients (``dtype=float32``, as tests/test_fused_block.py's f32
  test runs it): rtol 1e-4 with atol 1e-4 of the leaf's largest gradient --
  the same hand-derived backward on both sides, f32 convolutions summed in
  another order;
* bf16 gradients: the JAX test's own envelope (cosine > 0.995, norms
  within 5% per leaf).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.models.resnet import BasicBlock as JaxBlock
from subspace_reg_tpu.ops import fused_block as jfb
from subspace_reg_tpu_torch.models.resnet import BasicBlock
from subspace_reg_tpu_torch.ops import fused_block as fb
from subspace_reg_tpu_torch.weights import from_jax_variables

PREFIX = "layer1.0."
# JAX param leaf -> the port's parameter of the same block
LEAVES = (("conv1", "kernel", "conv1.weight"), ("conv2", "kernel",
                                                "conv2.weight"),
          ("conv3", "kernel", "conv3.weight"),
          ("ds_conv", "kernel", "downsample.0.weight"),
          ("bn1", "scale", "bn1.weight"), ("bn1", "bias", "bn1.bias"),
          ("bn2", "scale", "bn2.weight"), ("bn2", "bias", "bn2.bias"),
          ("bn3", "scale", "bn3.weight"), ("bn3", "bias", "bn3.bias"),
          ("ds_bn", "scale", "downsample.1.weight"),
          ("ds_bn", "bias", "downsample.1.bias"))


def _setup(b=4, h=12, cin=8, cout=8, seed=0):
    """A JAX block's params with random BN affines, the port's block
    holding the same weights, and an NHWC f32 input."""
    r = np.random.RandomState(seed)
    x = r.standard_normal((b, h, h, cin)).astype(np.float32)
    jblock = JaxBlock(planes=cout, stride=2, has_downsample=True)
    variables = jblock.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                            train=False)
    p = {k: dict(v) for k, v in
         jax.tree.map(np.asarray, dict(variables["params"])).items()}
    for bn in ("bn1", "bn2", "bn3", "ds_bn"):
        p[bn]["scale"] = r.uniform(0.5, 1.5, cout).astype(np.float32)
        p[bn]["bias"] = (0.1 * r.standard_normal(cout)).astype(np.float32)
    stats = jax.tree.map(np.asarray, dict(variables["batch_stats"]))
    sd = from_jax_variables({"params": {"layer1_0": p},
                             "batch_stats": {"layer1_0": stats}})
    block = BasicBlock(cin, cout, stride=2, has_downsample=True)
    block.load_state_dict({k[len(PREFIX):]: v for k, v in sd.items()})
    return p, block, x


def _nchw(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))).to(dtype)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("b,h,cin,cout", [(4, 12, 8, 8), (2, 8, 8, 16),
                                          (2, 12, 3, 8)])
def test_forward_and_stats_match_jax(b, h, cin, cout, backend):
    p, block, x = _setup(b, h, cin, cout)
    out_j, st_j = jfb.fused_block_apply(jnp.asarray(x, jnp.bfloat16), p,
                                        paired_out=False, interpret=True,
                                        backend=backend)
    out, st = fb.fused_block_apply(_nchw(x, torch.bfloat16), block,
                                   backend=backend)
    assert out.dtype == torch.bfloat16 and out.shape == (b, cout, h // 2,
                                                         h // 2)
    np.testing.assert_array_equal(
        out.detach().float().permute(0, 2, 3, 1).numpy(),
        np.asarray(out_j.astype(jnp.float32)))
    for (mj, vj), (m, v) in zip(st_j, st):
        for a, t in ((mj, m), (vj, v)):
            a = np.asarray(a)
            np.testing.assert_allclose(t.numpy(), a, rtol=0,
                                       atol=4e-6 * np.abs(a).max())


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("need_dx", [True, False])
def test_f32_gradients_match_jax(need_dx, backend):
    p, block, x = _setup(seed=3)
    cot = np.random.RandomState(7).standard_normal((4, 6, 6, 8)).astype(
        np.float32)

    def loss(params, xx):
        out, _ = jfb.fused_block_apply(xx, params, paired_out=False,
                                       need_dx=need_dx, interpret=True,
                                       dtype=jnp.float32, backend=backend)
        return jnp.sum(out * cot)

    g_p, g_x = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    xt = _nchw(x, torch.float32).requires_grad_(True)
    out, _ = fb.fused_block_apply(xt, block, need_dx=need_dx,
                                  backend=backend)
    assert out.dtype == torch.float32
    (out * _nchw(cot, torch.float32)).sum().backward()
    params = dict(block.named_parameters())
    for mod, leaf, name in LEAVES:
        a = np.asarray(g_p[mod][leaf])
        g = params[name].grad.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)           # OIHW -> HWIO
        np.testing.assert_allclose(g, a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max(), err_msg=name)
    if need_dx:
        a = np.asarray(g_x)
        np.testing.assert_allclose(
            xt.grad.permute(0, 2, 3, 1).numpy(), a, rtol=1e-4,
            atol=1e-4 * np.abs(a).max())
    else:
        # the image entry: no dgrad (JAX returns zeros)
        assert float(jnp.abs(g_x).sum()) == 0.0 and xt.grad is None


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_bf16_gradients_inside_the_jax_envelope(backend):
    p, block, x = _setup(seed=3)
    cot = np.random.RandomState(7).standard_normal((4, 6, 6, 8))
    cot = np.asarray(jnp.asarray(cot, jnp.bfloat16).astype(jnp.float32))

    def loss(params, xx):
        out, _ = jfb.fused_block_apply(xx, params, paired_out=False,
                                       interpret=True, backend=backend)
        return jnp.sum(out.astype(jnp.float32) * cot)

    g_p = jax.grad(loss)(jax.tree.map(jnp.asarray, p),
                         jnp.asarray(x, jnp.bfloat16))
    out, _ = fb.fused_block_apply(_nchw(x, torch.bfloat16), block,
                                  backend=backend)
    (out.float() * _nchw(cot, torch.float32)).sum().backward()
    params = dict(block.named_parameters())
    for mod, leaf, name in LEAVES:
        a = np.asarray(g_p[mod][leaf], np.float32)
        g = params[name].grad.numpy()
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        a, g = a.ravel(), g.ravel()
        na, ng = np.linalg.norm(a), np.linalg.norm(g)
        assert float(a @ g) / max(na * ng, 1e-30) > 0.995, name
        assert abs(na - ng) < 0.05 * max(na, ng), name


def test_stats_carry_no_gradient_and_backend_is_checked():
    _, block, x = _setup()
    out, st = fb.fused_block_apply(_nchw(x, torch.bfloat16), block)
    assert out.requires_grad and not st.bn1[0].requires_grad
    with pytest.raises(ValueError, match="backend"):
        fb.fused_block_apply(_nchw(x, torch.bfloat16), block,
                             backend="mosaic")
