"""The CUDA kernels against their plain torch versions on the card: K1 at
the evaluation path's shapes (chip_smoke.py's ``k1_case``) in every
configuration the engine uses; K2 and K3 at the fused pretraining step's
shapes (``k2_case``, ``k3_case``).  Marked ``gpu``: it skips where no card
is present and runs on the card with

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py configures JAX, which the card's
machine does not have.)

Tolerances (K1): epochs exact; max |dW| <= 1e-4 and loss / accuracies to
1e-4 relative — the kernel and the twin run the same f32 arithmetic with
sums in a different order.  K2 and K3: stated at each test.  No JAX here."""

import pytest
import torch

from chip_smoke import (K2_SHAPES, K3_SHAPES, bf16_ulp_diff, k1_case,
                        k2_case, k2_term_scale, k3_case)
from subspace_reg_tpu_torch.ops import conv_fused as cf
from subspace_reg_tpu_torch.ops import finetune as ft
from subspace_reg_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return resolve_device("cuda")


@pytest.mark.parametrize("kind", ["sgd", "adam", "bias", "semantic",
                                  "plain"])
def test_kernel_matches_twin(cuda, kind):
    ops, cfg = k1_case(kind, cuda, max_epochs=60)
    w_k, st_k, tr_k = ft.finetune_loop(**ops, cfg=cfg)
    w_p, st_p, tr_p = ft.finetune_loop_plain(**ops, cfg=cfg)
    torch.cuda.synchronize()
    ep = int(st_p[1])
    assert int(st_k[1]) == ep > 2
    assert float((w_k - w_p).abs().max()) <= 1e-4
    torch.testing.assert_close(st_k[[0, 3, 4]], st_p[[0, 3, 4]], rtol=1e-4,
                               atol=0.0)
    torch.testing.assert_close(tr_k[:ep + 1], tr_p[:ep + 1], rtol=1e-4,
                               atol=1e-5)
    assert torch.all(tr_k[ep + 1:] == 0)


def test_kernel_is_deterministic(cuda):
    ops, cfg = k1_case("sgd", cuda, max_epochs=30)
    a = ft.finetune_loop(**ops, cfg=cfg)
    b = ft.finetune_loop(**ops, cfg=cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_epoch1_stop_launches_no_epoch(cuda):
    ops, cfg = k1_case("sgd", cuda, max_epochs=1)
    w, stats, _ = ft.finetune_loop(**ops, cfg=cfg)
    assert int(stats[1]) == 1
    assert torch.equal(w, ops["w"])


def test_cuda_tensors_never_reach_the_twin(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the twin ran on CUDA tensors")

    monkeypatch.setattr(ft, "finetune_loop_plain", boom)
    ops, cfg = k1_case("sgd", cuda, max_epochs=5)
    before = ft.finetune_loop.launches
    ft.finetune_loop(**ops, cfg=cfg)
    assert ft.finetune_loop.launches == before + 1


@pytest.mark.parametrize("case", range(len(K2_SHAPES)),
                         ids=[s[0] for s in K2_SHAPES])
def test_k2_matches_plain(cuda, case):
    """At the fused step's shapes: y within 1 bf16 ulp of the plain version,
    the ulp taken at no less than 2^-8 of the summed |terms|
    (``k2_term_scale``: the f32 sums run in another order; the prologue
    rounds identically), and at most 0.1% of elements differing at all;
    the statistics are the sums of the kernel's own rounded y to rtol 1e-4
    of the sum of |y| (the partial sums run in another order)."""
    _, cin, cout, hw, pro = K2_SHAPES[case]
    x, w, aff = k2_case(cin, cout, hw, pro, cuda)
    y, st = cf.conv3x3_fused(x, w, aff, relu_in=pro)
    yp, _ = cf.conv3x3_fused_plain(x, w, aff, relu_in=pro)
    torch.cuda.synchronize()
    assert y.shape == yp.shape and y.is_contiguous(
        memory_format=torch.channels_last)
    ulps, share = bf16_ulp_diff(y, yp, k2_term_scale(x, w, aff, pro))
    assert ulps <= 1.0 and share <= 1e-3, (ulps, share)
    yf = y.double()
    ref = torch.stack([yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))])
    scale = torch.stack([yf.abs().sum((0, 2, 3)), ref[1]])
    assert torch.all((st.double() - ref).abs() <= 1e-4 * scale)


def test_k2_is_deterministic(cuda):
    x, w, aff = k2_case(64, 64, 84, True, cuda, batch=8)
    a = cf.conv3x3_fused(x, w, aff, relu_in=True)
    b = cf.conv3x3_fused(x, w, aff, relu_in=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", range(len(K3_SHAPES)),
                         ids=[s[0] for s in K3_SHAPES])
def test_k3_bit_identical_to_plain(cuda, case, ties):
    _, c, hw = K3_SHAPES[case]
    ops = k3_case(c, hw, cuda, ties=ties)
    out, idx = cf.block_tail(*ops)
    out_p, idx_p = cf.block_tail_plain(*ops)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), out_p.view(torch.int16))
    assert torch.equal(idx, idx_p)
    if ties:
        assert int((idx & 3).max()) == 3 and int((idx & 4).min()) == 0


def test_k2_k3_count_launches_and_refuse_bad_operands(cuda):
    x, w, aff = k2_case(64, 64, 16, True, cuda, batch=2)
    before = cf.conv3x3_fused.launches
    cf.conv3x3_fused(x, w, aff, relu_in=True)
    assert cf.conv3x3_fused.launches == before + 1
    with pytest.raises(ValueError, match="channels_last"):
        cf.conv3x3_fused(x.contiguous(), w)
    with pytest.raises(ValueError, match="bf16"):
        cf.conv3x3_fused(x.float().contiguous(
            memory_format=torch.channels_last), w)
    with pytest.raises(ValueError, match="Cout"):
        cf.conv3x3_fused(x, torch.randn((20, 64, 3, 3), device=cuda))
    y3, res, a3, ad = k3_case(64, 16, cuda, batch=2)
    before = cf.block_tail.launches
    cf.block_tail(y3, res, a3, ad)
    assert cf.block_tail.launches == before + 1
    with pytest.raises(ValueError, match="even"):
        cf.block_tail(y3[:, :, :15, :15].contiguous(
            memory_format=torch.channels_last),
            res[:, :, :15, :15].contiguous(
            memory_format=torch.channels_last), a3, ad)


def test_wrapper_refuses_bad_operands(cuda):
    ops, cfg = k1_case("sgd", cuda, max_epochs=5)
    with pytest.raises(ValueError, match="f_sup"):
        ft.finetune_loop(**dict(ops, f_sup=ops["f_sup"].double()), cfg=cfg)
    with pytest.raises(ValueError, match="w0"):
        ft.finetune_loop(**dict(ops, w0=ops["w0"].cpu()), cfg=cfg)
