"""The CUDA kernels against their plain torch versions on the card: K1 at
the evaluation path's shapes (chip_smoke.py's ``k1_case``) in every
configuration the engine uses, at each golden session's shapes, and on
grids of 1, 3, 17 blocks and one block per SM; K2 and K3 at the fused
pretraining step's shapes (``k2_case``, ``k3_case``) and at edge shapes
(``K2_EDGE_SHAPES``, ``K3_EDGE_SHAPES``; K3 also at each vector width its
pointers' alignment forces).  Marked
``gpu``: it skips where no card is present and runs on the card with

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py configures JAX, which the card's
machine does not have.)

Tolerances (K1): epochs exact; max |dW| <= 1e-4 and loss / accuracies to
1e-4 relative — the kernel and the twin run the same f32 arithmetic with
sums in a different order.  K2 and K3: stated at each test.  No JAX here."""

import pytest
import torch

from chip_smoke import (K2_EDGE_SHAPES, K2_SHAPES, K3_EDGE_SHAPES,
                        K3_SHAPES, bf16_ulp_diff, k1_case, k2_agreement,
                        k2_case, k2_term_scale, k3_agreement, k3_case)
from subspace_reg_tpu_torch.ops import conv_fused as cf
from subspace_reg_tpu_torch.ops import finetune as ft
from subspace_reg_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return resolve_device("cuda")


def _assert_matches_twin(ops, cfg, out):
    w_k, st_k, tr_k = out
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


@pytest.mark.parametrize("kind", ["sgd", "adam", "bias", "semantic",
                                  "plain"])
def test_kernel_matches_twin(cuda, kind):
    ops, cfg = k1_case(kind, cuda, max_epochs=60)
    _assert_matches_twin(ops, cfg, ft.finetune_loop(**ops, cfg=cfg))


@pytest.mark.parametrize("session", range(1, 9))
def test_k1_session_shapes_match_twin(cuda, session):
    """Each golden session's counts: 65..100 active classes, 0..175 replay
    rows, 0..35 reserved rows."""
    ops, cfg = k1_case("sgd", cuda, max_epochs=40, session=session)
    _assert_matches_twin(ops, cfg, ft.finetune_loop(**ops, cfg=cfg))


@pytest.mark.parametrize("kind", ["sgd", "bias"])
@pytest.mark.parametrize("blocks", [1, 3, 17, None])
def test_k1_block_counts_match_twin(cuda, kind, blocks):
    """The grid's size changes who owns what, not the result (None: one
    block per SM)."""
    ops, cfg = k1_case(kind, cuda, max_epochs=30)
    ft._validate(ops, cfg)
    _assert_matches_twin(ops, cfg, ft._launch(ops, cfg, blocks=blocks))


def test_k1_full_grid_rerun_is_bit_identical_at_1000_epochs(cuda):
    ops, cfg = k1_case("sgd", cuda, max_epochs=1000, stable_target=10 ** 6)
    a = ft.finetune_loop(**ops, cfg=cfg)
    b = ft.finetune_loop(**ops, cfg=cfg)
    assert int(a[1][1]) == 1000
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_k1_grid_that_cannot_be_resident_raises(cuda):
    ops, cfg = k1_case("sgd", cuda, max_epochs=5)
    before = ft.finetune_loop.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        ft._launch(ops, cfg, blocks=ft.k1_blocks(cuda) + 1)
    assert ft.finetune_loop.launches == before


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


@pytest.mark.parametrize("case", range(len(K2_EDGE_SHAPES)),
                         ids=[s[0] for s in K2_EDGE_SHAPES])
def test_k2_edge_shapes_match_plain(cuda, case):
    """Ragged tiles, a one-pixel image, Cin = 3 and 5 (the scalar halo
    path), Cin = 24 and 160, Cout = 8, 40 and 96 (output widths padded to
    64 or 160): the same rule as at the fused step's shapes."""
    _, cin, cout, hw, pro, batch = K2_EDGE_SHAPES[case]
    x, w, aff = k2_case(cin, cout, hw, pro, cuda, batch=batch)
    _, _, ulps, share, st_err, _ = k2_agreement(x, w, aff, pro)
    assert ulps <= 1.0 and share <= 1e-3, (ulps, share)
    assert st_err <= 1e-4, st_err


@pytest.mark.parametrize("cin,cout,hw,batch", [(64, 64, 84, 8),
                                               (160, 160, 42, 64)])
def test_k2_is_deterministic(cuda, cin, cout, hw, batch):
    x, w, aff = k2_case(cin, cout, hw, True, cuda, batch=batch)
    a = cf.conv3x3_fused(x, w, aff, relu_in=True)
    b = cf.conv3x3_fused(x, w, aff, relu_in=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", range(len(K3_SHAPES)),
                         ids=[s[0] for s in K3_SHAPES])
def test_k3_bit_identical_to_plain(cuda, case, ties):
    _, c, hw = K3_SHAPES[case]
    ops = k3_case(c, hw, hw, cuda, ties=ties)
    out, idx = cf.block_tail(*ops)
    out_p, idx_p = cf.block_tail_plain(*ops)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), out_p.view(torch.int16))
    assert torch.equal(idx, idx_p)
    if ties:
        assert int((idx & 3).max()) == 3 and int((idx & 4).min()) == 0


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", range(len(K3_EDGE_SHAPES)),
                         ids=[s[0] for s in K3_EDGE_SHAPES])
def test_k3_edge_shapes_bit_identical_to_plain(cuda, case, ties):
    """Each vector width (C = 3, 6, 20, 24/64/160), a single window,
    non-square maps, batches of 1, 3 and 64."""
    _, c, h, w, batch = K3_EDGE_SHAPES[case]
    _, _, same, _ = k3_agreement(k3_case(c, h, w, cuda, ties=ties,
                                         batch=batch))
    assert same


@pytest.mark.parametrize("case", range(len(K3_SHAPES)),
                         ids=[s[0] for s in K3_SHAPES])
def test_k3_rerun_is_bit_identical(cuda, case):
    _, c, hw = K3_SHAPES[case]
    ops = k3_case(c, hw, hw, cuda)
    out, idx = cf.block_tail(*ops)
    out2, idx2 = cf.block_tail(*ops)
    assert torch.equal(out.view(torch.int16), out2.view(torch.int16))
    assert torch.equal(idx, idx2)


@pytest.mark.parametrize("offset,width", [(0, 8), (4, 4), (2, 2), (1, 1)])
def test_k3_pointer_alignment_picks_the_vector_width(cuda, offset, width):
    """y3 starting ``offset`` bf16 elements into its buffer: 16-, 8-, 4- or
    2-byte aligned, so 8, 4, 2 or 1 channels a thread."""
    y3, res, a3, ad = k3_case(64, 6, 10, cuda, batch=3)
    buf = torch.empty(y3.numel() + 8, dtype=torch.bfloat16, device=cuda)
    view = buf[offset:offset + y3.numel()].view(3, 6, 10, 64).permute(
        0, 3, 1, 2)
    view.copy_(y3)
    assert view.is_contiguous(memory_format=torch.channels_last)
    _, out, idx = cf._k3_operands(view, res, a3, ad)
    plan = cf.k3_plan(3, 6, 10, 64, (view.data_ptr(), res.data_ptr(),
                                     out.data_ptr(), idx.data_ptr()))
    assert plan.v == width
    _, _, same, _ = k3_agreement((view, res, a3, ad))
    assert same


def test_k3_bare_launch_counts_and_matches_plain(cuda):
    """The launcher under the wrapper (which the kernel-alone timer calls
    with outputs allocated once) counts each launch where it makes it."""
    ops = k3_case(20, 6, 10, cuda, batch=3)
    vecs, out, idx = cf._k3_operands(*ops)
    before = cf.block_tail.launches
    cf._k3_launch(ops[0], ops[1], vecs, out, idx)
    assert cf.block_tail.launches == before + 1
    out_p, idx_p = cf.block_tail_plain(*ops)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), out_p.view(torch.int16))
    assert torch.equal(idx, idx_p)


def test_k3_cuda_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(cf, "block_tail_plain", boom)
    ops = k3_case(64, 16, 16, cuda, batch=2)
    before = cf.block_tail.launches
    cf.block_tail(*ops)
    assert cf.block_tail.launches == before + 1


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
    y3, res, a3, ad = k3_case(64, 16, 16, cuda, batch=2)
    before = cf.block_tail.launches
    cf.block_tail(y3, res, a3, ad)
    assert cf.block_tail.launches == before + 1
    with pytest.raises(ValueError, match="even"):
        cf.block_tail(y3[:, :, :15, :15].contiguous(
            memory_format=torch.channels_last),
            res[:, :, :15, :15].contiguous(
            memory_format=torch.channels_last), a3, ad)
    with pytest.raises(ValueError, match="empty"):
        cf.block_tail(y3[:0], res[:0], a3, ad)
    assert cf.block_tail.launches == before + 1


def test_wrapper_refuses_bad_operands(cuda):
    ops, cfg = k1_case("sgd", cuda, max_epochs=5)
    with pytest.raises(ValueError, match="f_sup"):
        ft.finetune_loop(**dict(ops, f_sup=ops["f_sup"].double()), cfg=cfg)
    with pytest.raises(ValueError, match="w0"):
        ft.finetune_loop(**dict(ops, w0=ops["w0"].cpu()), cfg=cfg)
