"""K1's CUDA kernel against its plain torch twin on the card, at the main
path's shapes (chip_smoke.py's ``k1_case``), in every configuration the
engine uses.  Marked ``gpu``: it skips where no card is present and runs on
the card with

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py configures JAX, which the card's
machine does not have.)

Tolerances: epochs exact; max |dW| <= 1e-4 and loss / accuracies to 1e-4
relative — the kernel and the twin run the same f32 arithmetic with sums in
a different order.  No JAX here."""

import pytest
import torch

from chip_smoke import k1_case
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


def test_wrapper_refuses_bad_operands(cuda):
    ops, cfg = k1_case("sgd", cuda, max_epochs=5)
    with pytest.raises(ValueError, match="f_sup"):
        ft.finetune_loop(**dict(ops, f_sup=ops["f_sup"].double()), cfg=cfg)
    with pytest.raises(ValueError, match="w0"):
        ft.finetune_loop(**dict(ops, w0=ops["w0"].cpu()), cfg=cfg)
