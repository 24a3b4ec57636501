"""K5, the train-mode BatchNorm + LeakyReLU of ``ops/bn_train.py``, on the
CPU.  K5's forward twin is the layer's own chain (``TorchBatchNorm`` and
``leaky_relu``), its backward twin ``bn_train_backward_plain``; here the
two, as one autograd function, against autograd through the chain, the
backward twin against an f64 evaluation, the routing and its counters,
one module step through ``make_train_step``, the refusals, the launch
plan and the launchers' signatures.  The kernels themselves run on the
card only (tests/test_torch_kernels_gpu.py, ``-m gpu``).

Tolerances: bf16 backward bit-identical to autograd through the chain (the
twin takes the same sums and rounds where the chain rounds); f64 backward
within 1e-10 of autograd's through an f64 evaluation of the same formula
(autograd adds x's gradients in another order).  Narrow backbone, 16 px."""

import re
import types
from pathlib import Path

import pytest
import torch

from subspace_reg_tpu_torch.models.layers import TorchBatchNorm, leaky_relu
from subspace_reg_tpu_torch.ops import bn_train as k5

BF16 = torch.bfloat16
CL = torch.channels_last
LAYOUTS = {"cl": CL, "nchw": torch.contiguous_format}


def _case(c=12, hw=6, batch=5, layout="cl", dtype=BF16, seed=0, spread=1.0):
    """x (batch, c, hw, hw) with a per-channel offset of up to ~4 spreads
    (the single-pass variance cancels there), weight, bias, dy."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn((batch, c, hw, hw), generator=g, dtype=torch.float64)
         * spread * (torch.rand((1, c, 1, 1), generator=g,
                                dtype=torch.float64) + 0.1)
         + 4 * torch.randn((1, c, 1, 1), generator=g, dtype=torch.float64))
    x = x.to(dtype).contiguous(memory_format=LAYOUTS[layout])
    wdt = torch.float64 if dtype == torch.float64 else torch.float32
    w = (1 + 0.3 * torch.randn(c, generator=g)).to(wdt)
    b = (0.3 * torch.randn(c, generator=g)).to(wdt)
    dy = torch.randn((batch, c, hw, hw), generator=g).to(dtype).contiguous(
        memory_format=LAYOUTS[layout])
    return x, w, b, dy


def _module(w, b):
    bn = TorchBatchNorm(w.shape[0])
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    return bn.train()


def _chain(bn, x, leaky):
    """Today's ops: TorchBatchNorm's own path, then leaky_relu."""
    out = bn._normalize(x, None)
    return leaky_relu(out) if leaky else out


class _Twins(torch.autograd.Function):
    """K5's function from its plain twins: the layer's chain forward (on
    a TorchBatchNorm holding the caller's running statistics, updated in
    place) and ``bn_train_backward_plain`` backward, from the mean and the
    mean of squares the chain takes."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, leaky):
        bn = TorchBatchNorm(x.shape[1], momentum, eps).train()
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean, bn.running_var = running_mean, running_var
        y = _chain(bn, x, leaky)
        xs = x.to(torch.float32)
        ctx.save_for_backward(x, weight, bias, xs.mean((0, 2, 3)),
                              (xs * xs).mean((0, 2, 3)))
        ctx.eps, ctx.leaky = eps, leaky
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, e2 = ctx.saved_tensors
        dx, dw, db = k5.bn_train_backward_plain(x, dy, mean, e2, weight,
                                                bias, ctx.eps, ctx.leaky)
        return dx, dw, db, None, None, None, None, None


def _twins(x, weight, bias, running_mean, running_var, momentum=0.1,
           eps=1e-5, leaky=False):
    return _Twins.apply(x, weight, bias, running_mean, running_var,
                        momentum, eps, leaky)


@pytest.fixture
def on_card(monkeypatch):
    """Routing as on the card, run by the plain twins: ``wanted`` sees CPU
    tensors as the card's, and ``bn_train`` is ``_twins``.  Yields the
    real ``bn_train``, whose launch counter must not move."""
    wanted, real = k5.wanted, k5.bn_train
    monkeypatch.setattr(k5, "wanted", lambda x, m, g: wanted(
        types.SimpleNamespace(dtype=x.dtype, is_cuda=True), m, g))
    monkeypatch.setattr(k5, "bn_train", _twins)
    yield real


def _f64_chain(x, w, b, leaky):
    """The chain's formula in f64 throughout, for autograd."""
    mean = x.mean((0, 2, 3))
    var = torch.clamp_min((x * x).mean((0, 2, 3)) - mean * mean, 0.0)
    inv = torch.rsqrt(var + 1e-5)
    y = (x * (inv * w).reshape(1, -1, 1, 1)
         + (b - mean * inv * w).reshape(1, -1, 1, 1))
    return torch.where(y >= 0, y, y * 0.1) if leaky else y


@pytest.mark.parametrize("layout", ["cl", "nchw"])
@pytest.mark.parametrize("leaky", [True, False])
@pytest.mark.parametrize("spread", [1.0, 1e-2])
@pytest.mark.parametrize("shape", [(12, 6, 5), (7, 3, 1)],
                         ids=["c12", "c7-one-image"])
def test_function_is_autograd_through_the_chain_bit_for_bit(leaky, layout,
                                                            spread, shape):
    """bf16: y, dx, dweight, dbias and the running statistics of K5's
    function in its plain twins equal the chain's under autograd, also
    where the mean is 400 spreads."""
    c, hw, batch = shape
    x, w, b, dy = _case(c, hw, batch, layout=layout, spread=spread, seed=3)
    bn = _module(w, b)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    xa = x.clone().requires_grad_()
    ya = _chain(bn, xa, leaky)
    ya.backward(dy)
    xk = x.clone().requires_grad_()
    wk, bk = w.clone().requires_grad_(), b.clone().requires_grad_()
    yk = _twins(xk, wk, bk, rm, rv, 0.1, 1e-5, leaky)
    yk.backward(dy)
    assert torch.equal(yk, ya)
    assert yk.stride() == x.stride() and xk.grad.stride() == x.stride()
    assert torch.equal(xk.grad, xa.grad)
    assert torch.equal(wk.grad, bn.weight.grad)
    assert torch.equal(bk.grad, bn.bias.grad)
    assert torch.equal(rm, bn.running_mean)
    assert torch.equal(rv, bn.running_var)


@pytest.mark.parametrize("leaky", [True, False])
def test_backward_twin_in_f64_within_1e10_of_autograd(leaky):
    x, w, b, dy = _case(dtype=torch.float64, seed=5)
    xa = x.clone().requires_grad_()
    wa, ba = w.clone().requires_grad_(), b.clone().requires_grad_()
    _f64_chain(xa, wa, ba, leaky).backward(dy)
    mean, e2 = x.mean((0, 2, 3)), (x * x).mean((0, 2, 3))
    dx, dw, db = k5.bn_train_backward_plain(x, dy, mean, e2, w, b, 1e-5,
                                            leaky)
    for got, want in ((dx, xa.grad), (dw, wa.grad), (db, ba.grad)):
        assert float((got - want).abs().max()) <= 1e-10 * float(
            want.abs().max())


def test_clamped_variance_takes_no_gradient():
    """A constant channel: the single-pass variance may come out below 0
    and is clamped; the chain's gradient through it is 0, and the twin's
    is too."""
    x, w, b, dy = _case(c=4, seed=7)
    x[:, 1] = torch.tensor(3.140625, dtype=BF16)
    xa = x.clone().requires_grad_()
    bn = _module(w, b)
    _chain(bn, xa, True).backward(dy)
    xs = x.float()
    mean, e2 = xs.mean((0, 2, 3)), (xs * xs).mean((0, 2, 3))
    dx, dw, db = k5.bn_train_backward_plain(x, dy, mean, e2, w, b, 1e-5,
                                            True)
    assert torch.equal(dx, xa.grad)
    assert torch.equal(dw, bn.weight.grad) and torch.equal(db, bn.bias.grad)


def test_running_statistics_after_three_steps(on_card):
    """Three train-mode forwards routed to K5 (its twins) leave the running
    statistics of three through the layer's ops, bit for bit, and both
    within f32 rounding of the closed form in f64 (momentum 0.1, the
    unbiased variance n/(n-1))."""
    w, b = _case()[1:3]
    routed, kept = _module(w, b), _module(w, b)
    kept.load_state_dict(routed.state_dict())
    rm0 = routed.running_mean.double()
    rv0 = routed.running_var.double()
    xs = [_case(seed=10 + step)[0] for step in range(3)]
    k0 = TorchBatchNorm.kernel_forwards
    with torch.no_grad():
        for x in xs:
            routed(x, leaky=True)
            _chain(kept, x, True)
    assert TorchBatchNorm.kernel_forwards - k0 == 3
    assert torch.equal(routed.running_mean, kept.running_mean)
    assert torch.equal(routed.running_var, kept.running_var)
    rm, rv = rm0, rv0
    for x in xs:
        xd = x.double()
        n = xd.numel() // xd.shape[1]
        mean = xd.mean((0, 2, 3))
        var = (xd * xd).mean((0, 2, 3)) - mean * mean
        rm = 0.9 * rm + 0.1 * mean
        rv = 0.9 * rv + 0.1 * var * n / (n - 1)
    assert torch.allclose(routed.running_mean.double(), rm, rtol=1e-5,
                          atol=1e-5)
    assert torch.allclose(routed.running_var.double(), rv, rtol=1e-4,
                          atol=1e-5)


def test_routing_by_what_the_call_can_observe(on_card):
    """K5 takes a train-mode bf16 BatchNorm without a mask or a group;
    f32, eval mode, a sample mask and a cross-replica group keep
    TorchBatchNorm's ops, and the counters say so."""
    x, w, b, _ = _case()
    bn = _module(w, b)
    mask = torch.ones(x.shape[0])
    cases = [("bf16 train", x, True, None, None, 1),
             ("f32 train", x.float(), True, None, None, 0),
             ("bf16 eval", x, False, None, None, 0),
             ("masked", x, True, mask, None, 0),
             ("group", x, True, None, object(), 0)]
    for name, xi, train, m, group, kernel in cases:
        bn.train(train)
        bn.sync_group = group
        t0, k0 = TorchBatchNorm.train_forwards, TorchBatchNorm.kernel_forwards
        launches = on_card.launches
        if group is None:
            bn(xi, m, leaky=True)
        else:
            assert not k5.wanted(xi, m, group)
        assert TorchBatchNorm.kernel_forwards - k0 == kernel, name
        assert TorchBatchNorm.train_forwards - t0 == (
            int(train) if group is None else 0), name
        # the twins ran; K5's kernels launched nothing
        assert on_card.launches == launches
    bn.sync_group = None


def test_wanted_needs_the_card_and_a_width_it_takes():
    """``wanted`` asks for a bf16 tensor on the card, whatever its width: a
    width the kernels do not take is refused with a ``ValueError``, never
    sent back to the layer's ops."""
    assert not k5.wanted(torch.zeros((2, 64, 4, 4), dtype=BF16), None, None)
    for c in (64, 255, 257, 514, 1024, 1025):
        card = types.SimpleNamespace(dtype=BF16, is_cuda=True)
        assert k5.wanted(card, None, None), c
    assert not k5.wanted(types.SimpleNamespace(dtype=torch.float32,
                                               is_cuda=True), None, None)
    x = torch.zeros((2, 1025, 2, 2), dtype=BF16)
    w = torch.ones(1025)
    with pytest.raises(ValueError, match="1025 channels"):
        k5.bn_train(x, w, w, w, w)
    for c in (257, 514):
        with pytest.raises(ValueError, match="threads a row"):
            k5.k5_plan(2, c, 3, 3, True, 16, 132)


def test_module_step_through_make_train_step(on_card):
    """One bf16 step of a narrow resnet18 at 16 px through
    ``make_train_step``: with K5's routing (its plain twins) the loss, every
    gradient, parameter and statistic equal today's, and each of the 22
    BatchNorms took it."""
    from torch_support import golden_tx, pretrain_backbone
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.utils.optim import step_decay_schedule
    spec, _ = transforms_options["A"]
    g = torch.Generator().manual_seed(0)
    x_u8 = torch.randint(0, 256, (8, 16, 16, 3), generator=g,
                         dtype=torch.uint8)
    y = torch.randint(0, 6, (8,), generator=g)
    bb = pretrain_backbone(widths=(8, 16, 24, 32))
    runs = []
    for routed in (False, True):
        if not routed:
            k5_wanted = k5.wanted
            k5.wanted = lambda *a: False
        try:
            st = pt.init_pretrain_state(
                __import__("copy").deepcopy(bb), 6, golden_tx(), False,
                torch.Generator().manual_seed(1), "cpu")
            step = pt.make_train_step(
                st.backbone, step_decay_schedule(0.05, [60, 80], 0.1, 100),
                spec, False, TorchDraws(1, torch.device("cpu")))
            k0 = TorchBatchNorm.kernel_forwards
            m = step(st, x_u8, y)
            took = TorchBatchNorm.kernel_forwards - k0
        finally:
            if not routed:
                k5.wanted = k5_wanted
        grads = {k: v.grad.clone() for k, v in st.backbone.named_parameters()}
        runs.append((m, took, grads, st.backbone.state_dict()))
    (m0, took0, g0, sd0), (m1, took1, g1, sd1) = runs
    assert (took0, took1) == (0, 22)
    assert torch.equal(m0["loss"], m1["loss"])
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)


def test_bad_strides_and_operands_raise():
    """Strides, rank, dtype and device are refused before any launch; the
    card's operands' shapes and dtypes are held on the card
    (tests/test_torch_kernels_gpu.py)."""
    x, w, b, _ = _case()
    rm, rv = torch.zeros(12), torch.ones(12)
    with pytest.raises(ValueError, match="channels_last or NCHW"):
        k5.bn_train(x.transpose(2, 3), w, b, rm, rv)
    with pytest.raises(ValueError, match="channels_last or NCHW"):
        k5.bn_train(x[:, :, :, :3], w, b, rm, rv)
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        k5.bn_train(x[0], w, b, rm, rv)
    with pytest.raises(ValueError, match="bfloat16"):
        k5.bn_train(x.float(), w, b, rm, rv)
    with pytest.raises(ValueError, match="CUDA card"):
        k5.bn_train(x, w, b, rm, rv)


@pytest.mark.parametrize("shape,cl,align,want", [
    # the step's shapes on a 132-SM card
    ((64, 64, 84, 84), True, 16, k5.BNPlan(0, 64 * 84 * 84, 1, 8, 132)),
    ((64, 160, 42, 42), False, 16, k5.BNPlan(1, 64, 42 * 42, 1, 4)),
    ((64, 320, 21, 21), False, 16, k5.BNPlan(1, 64, 441, 1, 2)),
    ((64, 640, 10, 10), False, 16, k5.BNPlan(1, 64, 100, 1, 1)),
    # vector widths by C and by the pointers' alignment; few rows
    ((2, 24, 3, 3), True, 16, k5.BNPlan(0, 18, 1, 8, 1)),
    ((2, 12, 3, 3), True, 16, k5.BNPlan(0, 18, 1, 4, 1)),
    ((2, 64, 3, 3), True, 4, k5.BNPlan(0, 18, 1, 2, 1)),
    ((2, 5, 3, 3), True, 16, k5.BNPlan(0, 18, 1, 1, 1)),
    ((3, 8, 2, 2), False, 16, k5.BNPlan(1, 3, 4, 1, 3))])
def test_plan(shape, cl, align, want):
    assert k5.k5_plan(*shape, cl, align, 132) == want


def test_plan_refuses_a_row_wider_than_the_block():
    with pytest.raises(ValueError, match="threads a row"):
        k5.k5_plan(2, 514, 3, 3, True, 16, 132)


def test_launchers_take_the_arguments_the_wrapper_passes():
    """Each ``extern "C"`` launcher of csrc/bn_train.cu has the ctypes
    signature the wrapper gives it (a wrong count or type corrupts the
    call instead of raising)."""
    src = (Path(k5.__file__).resolve().parents[1] / "csrc" /
           "bn_train.cu").read_text()
    found = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        sig = ""
        for a in (" ".join(t.split()) for t in args.split(",")):
            sig += ("p" if "*" in a else "l" if a.startswith("long long")
                    else "f" if a.startswith("float") else "i")
        found[name] = sig
    assert found == k5._SIGNATURES
    with pytest.raises(TypeError, match="arguments"):
        k5._call("k5_bn_square", 1, 2)
