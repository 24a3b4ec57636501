"""K4, the backbone's f32 convolution (ops/conv_f32.py), on the CPU: the
plain version against an f64 ``F.conv2d``, the routing of ``BasicBlock``
(no-grad f32 forwards to K4, training forwards to ``F.conv2d``), the
wrapper's refusals, the weight and input layouts the kernel reads, the
launch plan, and the channels_last layout through a whole forward.  The
kernel itself runs on the card: tests/test_torch_kernels_gpu.py.

Tolerance: the plain version sums f32 products tap by tap; against f64,
max |y - y64| / max |y64| stays below 1e-6 at these sizes (sums of at
most 9 x 24 products)."""

import pytest
import torch
import torch.nn.functional as F

from subspace_reg_tpu_torch.models.factory import model_dict
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.ops import conv_f32 as k4
from torch_support import (SMALL_ARGS, golden_opt, pretrain_backbone,
                           pretrain_data, pretrain_state, pretrain_step,
                           run_engine, small_data, small_model)

CL = torch.channels_last
WIDTHS = (8, 16, 24, 32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for this module, as the tier-1 lane runs six
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def calls(monkeypatch):
    """Counts the plain version's calls (every K4 call on the CPU)."""
    seen = []
    plain = k4.conv_f32_plain

    def counted(x, w):
        seen.append((tuple(x.shape), tuple(w.shape)))
        return plain(x, w)
    monkeypatch.setattr(k4, "conv_f32_plain", counted)
    return seen


def _rel_err(y, ref):
    return float((y.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("cin,cout,h,w", [(3, 8, 16, 16), (8, 12, 7, 9),
                                          (24, 4, 1, 1), (16, 20, 5, 16)])
def test_plain_matches_f64_conv2d(r, cin, cout, h, w):
    g = torch.Generator().manual_seed(cin * 100 + r)
    x = torch.randn((3, cin, h, w), generator=g)
    wt = torch.randn((cout, cin, r, r), generator=g)
    ref = F.conv2d(x.double(), wt.double(), padding=r // 2)
    for xin in (x, x.contiguous(memory_format=CL)):
        y = k4.conv_f32(xin, wt)
        assert y.shape == ref.shape and y.dtype == torch.float32
        assert y.is_contiguous(memory_format=CL)
        assert _rel_err(y, ref) <= 1e-6


def test_cpu_tensors_take_the_plain_version(calls, monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel")
    monkeypatch.setattr(k4, "_fn", no_kernel)
    launches = k4.conv_f32.launches
    x, w = torch.randn(2, 8, 6, 6), torch.randn(4, 8, 3, 3)
    y = k4.conv_f32(x, w, 1, 1)
    assert calls == [((2, 8, 6, 6), (4, 8, 3, 3))]
    assert torch.equal(y, k4.conv_f32_plain(x, w))
    assert k4.conv_f32.launches == launches


@pytest.mark.parametrize("bad", ["f64", "bf16", "stride", "padding", "5x5",
                                 "layout", "channels", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x, w = torch.randn(2, 8, 6, 6), torch.randn(4, 8, 3, 3)
    kw = {}
    if bad == "f64":
        x, w = x.double(), w.double()
    elif bad == "bf16":
        x = x.to(torch.bfloat16)
    elif bad == "stride":
        kw = dict(stride=2)
    elif bad == "padding":
        kw = dict(padding=0)
    elif bad == "5x5":
        w = torch.randn(4, 8, 5, 5)
    elif bad == "layout":
        x = torch.randn(2, 8, 6, 12)[..., ::2]
    elif bad == "channels":
        w = torch.randn(4, 6, 3, 3)
    elif bad == "device":
        x = x.to("meta")
    with pytest.raises(ValueError, match="conv_f32"):
        k4.conv_f32(x, w, **kw)


def test_wanted_routes_f32_without_gradients_only():
    x, w = torch.randn(1, 4, 3, 3), torch.randn(4, 4, 3, 3)
    wg = w.clone().requires_grad_()
    assert k4.wanted(x, w) and k4.wanted(x, wg.detach())
    assert not k4.wanted(x, wg)
    with torch.no_grad():
        assert k4.wanted(x, wg)
    assert not k4.wanted(x.to(torch.bfloat16), w.to(torch.bfloat16))
    assert not k4.wanted(x.double(), w.double())


def test_k_major_layout_rotates_each_group_of_four():
    """Row (r*R + s)*C + c of the kernel's weight holds w[n, c, r, s],
    output channels in groups of four stored as (1, 2, 3, 0); input
    channels padded with zeros."""
    w = torch.randn(8, 3, 3, 3)
    wk = k4._k_major(w, 4)
    assert wk.shape == (36, 8) and wk.is_contiguous()
    back = wk.view(36, 2, 4)[:, :, [3, 0, 1, 2]].reshape(3, 3, 4, 8)
    assert torch.equal(back[:, :, :3].permute(3, 2, 0, 1), w)
    assert torch.all(back[:, :, 3] == 0)


@pytest.mark.parametrize("fmt", ["nchw", "cl"])
def test_nhwc_input_views_or_copies(fmt):
    x = torch.randn(2, 3, 5, 6)
    if fmt == "cl":
        x = x.contiguous(memory_format=CL)
    xh = k4._nhwc(x, 4)
    assert xh.shape == (2, 5, 6, 4) and xh.is_contiguous()
    assert torch.equal(xh[..., :3], x.permute(0, 2, 3, 1))
    assert torch.all(xh[..., 3] == 0)
    xc = torch.randn(2, 8, 5, 6).contiguous(memory_format=CL)
    assert k4._nhwc(xc, 8).data_ptr() == xc.data_ptr()


OCC = (4, 3, 4)


@pytest.mark.parametrize("m,n,c,config", [
    (1000 * 84 * 84, 64, 64, 0), (1000 * 42 * 42, 160, 160, 1),
    (125 * 42 * 42, 160, 64, 1), (1000 * 21 * 21, 320, 320, 0),
    (125 * 5 * 5, 640, 640, 0), (1000 * 84 * 84, 64, 4, 2),
    (3 * 7 * 9, 12, 8, 2)])
def test_plan_picks_from_the_shape(m, n, c, config):
    """128 x 64 tiles, 256 x 32 where 64 does not divide N (no idle
    columns at 160); the k tile of 4 where 16 does not divide C."""
    plan = k4.conv_f32_plan(m, n, c, 132, OCC)
    wm, wn, bk = k4.K4_CONFIGS[plan.config]
    assert c % bk == 0
    assert (plan.bm, plan.bn) == (64 * wm, 32 * wn)
    assert plan.tiles == -(-m // plan.bm) * -(-n // plan.bn)
    assert plan.grid == min(plan.tiles, 132 * OCC[plan.config])
    assert plan.config == config


def test_plan_refuses_when_no_instance_fits():
    with pytest.raises(ValueError, match="no kernel instance"):
        k4.conv_f32_plan(100, 64, 16, 132, (0, 0, 4))


def _resnet18_small():
    torch.manual_seed(0)
    return model_dict["resnet18"](avg_pool=True, widths=WIDTHS)


def test_eval_forward_goes_through_k4_in_channels_last(calls):
    """Every one of resnet18's 22 convolutions (18 3x3, 4 1x1) takes K4 in
    a no-grad f32 forward; every conv and BatchNorm output is
    channels_last; the features match the F.conv2d forward."""
    m = _resnet18_small().eval()
    x = torch.randn(3, 3, 16, 16)
    layouts = []
    hooks = [mod.register_forward_hook(
        lambda mod, i, o: layouts.append(o.is_contiguous(memory_format=CL)))
        for mod in m.modules() if type(mod).__name__ == "TorchBatchNorm"]
    with torch.no_grad():
        f = m(x)
    for h in hooks:
        h.remove()
    assert len(calls) == 22
    assert sum(w[2] == 3 for _, w in calls) == 18
    assert len(layouts) == 22 and all(layouts)
    ref = m(x)                      # autograd on: F.conv2d
    assert len(calls) == 22
    assert _rel_err(f, ref.detach().double()) <= 1e-5


def test_conv_launches_stay_zero_on_the_cpu():
    launches = k4.conv_f32.launches
    m = _resnet18_small().eval()
    with torch.no_grad():
        m(torch.randn(2, 3, 16, 16))
        m.train()(torch.randn(2, 3, 16, 16))
    assert k4.conv_f32.launches == launches


def test_training_forwards_keep_conv2d(calls):
    """Gradients into the backbone (the general freeze's f32 epochs) and
    bf16 (pretraining, its validation) keep F.conv2d."""
    m = _resnet18_small().train()
    m(torch.randn(2, 3, 16, 16)).sum().backward()
    bf = ResNetRFS(n_blocks=(1, 1, 2, 2), avg_pool=True, widths=WIDTHS,
                   dtype=torch.bfloat16).eval()
    with torch.no_grad():
        bf(torch.randn(2, 3, 16, 16))
    assert calls == []


def test_pretraining_step_does_not_touch_k4(calls):
    launches = k4.conv_f32.launches
    dev = torch.device("cpu")
    data, labels = pretrain_data(dev, n_cls=4, per_class=4, img=32)
    state = pretrain_state(pretrain_backbone(widths=WIDTHS), dev, n_cls=4)
    step = pretrain_step(state, dev, fused=False, transform="D")
    out = step(state, data, labels, torch.arange(8))
    assert torch.isfinite(out["loss"])
    assert calls == [] and k4.conv_f32.launches == launches


def test_evaluation_forwards_all_take_k4(tmp_path, calls):
    """The golden 8-session run (memory replay on): ``eval_base`` once,
    then each session's epoch-1 support forward, its replay forward once
    the buffer holds rows (sessions 2-8) and the four cached forwards: 48
    backbone forwards, each with all of the backbone's convolutions in K4
    (16 in this resnet12, 22 in resnet18: 1,056 launches on the card)."""
    root = small_data(str(tmp_path))
    opt = golden_opt(root, *SMALL_ARGS)
    backbone, head = small_model(drop_rate=0.1)
    forwards = []
    backbone.register_forward_hook(lambda *a: forwards.append(1))
    run_engine(root, opt, backbone, head, "cpu", verbose=False)
    assert len(forwards) == 1 + 8 * 5 + 7
    assert len(calls) == 16 * len(forwards)
