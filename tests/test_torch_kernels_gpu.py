"""The CUDA kernels against their plain torch versions on the card, the one
place where they are held to them (chip_smoke.py times them): K1 at the
evaluation path's shapes (tests/torch_support.py's ``k1_case``) in every
configuration the engine uses, at each golden session's shapes, over the
golden run's 1000 epochs, at ViT-B/16's 768 features, and on grids of 1,
3, 17 blocks and one block per SM, and seed-batched over S seeds (each
seed bit-identical to a single-seed launch on its group's blocks); K2 and
K3 at the fused pretraining step's shapes (``k2_case``, ``k3_case``) and
at edge shapes (``K2_EDGE_SHAPES``, ``K3_EDGE_SHAPES``; K3 also at each
vector width its pointers' alignment forces); K4 against an f64
convolution at each of the 22 convolutions of the evaluation's resnet18
forward at each of its batch sizes (``K4_SHAPES`` x ``K4_ROWS``) and at
edge shapes (``K4_EDGE_SHAPES``), against its plain version, and the
evaluation's forward through K4 against the same forward through cuDNN;
K5 bit-identical to autograd through its plain chain and to its plain
backward twin at the pretraining step's 22 BatchNorm shapes
(``K5_SHAPES``, in both layouts, with and without the LeakyReLU) and at
odd widths and alignments; each kernel's launches, reruns and refusals.
Marked ``gpu``: it skips where no card is present and runs on the card
with

    python -m pytest -m gpu --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py configures JAX, which the card's
machine does not have.)

Tolerances (K1): epochs exact; max |dW| <= 1e-4 and loss / accuracies to
1e-4 relative — the kernel and the twin run the same f32 arithmetic with
sums in a different order; over 1000 epochs a support row's logits come
within an ulp of a rival class's and the two orders may rank it either
side, so there the accuracies of up to 10 epochs may differ by one
support row.  K2 and K3: stated at each test.  No JAX here."""

import pytest
import torch

from subspace_reg_tpu_torch.ops import bn_train as k5
from subspace_reg_tpu_torch.ops import conv_f32 as k4
from subspace_reg_tpu_torch.ops import conv_fused as cf
from subspace_reg_tpu_torch.ops import finetune as ft
from subspace_reg_tpu_torch.utils.device import resolve_device
from torch_support import (K2_CIFAR_SHAPES, K2_EDGE_SHAPES, K2_SHAPES,
                           K3_CIFAR_SHAPES, K3_EDGE_SHAPES, K3_SHAPES,
                           K4_EDGE_SHAPES, K4_ROWS, K4_SHAPES, K4_TOL,
                           K5_SHAPES, TIERED_BASE, bf16_ulp_diff,
                           check_k1_matches_plain, k1_case, k1_seed_case,
                           k2_agreement, k2_case, k2_term_scale,
                           k3_agreement, k3_case, k4_case, k4_error,
                           k5_agreement, k5_agreement_ok, k5_case)

pytestmark = pytest.mark.gpu
# the fused step's shapes at 84 px (resnet18) and at CIFAR's 32 px (resnet12)
K2_STEP_SHAPES = K2_SHAPES + K2_CIFAR_SHAPES
K3_STEP_SHAPES = K3_SHAPES + K3_CIFAR_SHAPES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return resolve_device("cuda")


# (kind, base classes, epochs): 60 epochs in every configuration, the last
# session at up to 100 (the stable rule may stop it first) and the golden
# run's 1000 on random weights, which never meet the stable rule; on
# miniImageNet and at tieredImageNet's last session (391 of 391 classes,
# 476 support rows, 175 replay rows)
K1_RUNS = ([(k, 60, 60) for k in ("sgd", "adam", "bias", "semantic",
                                  "plain")]
           + [(k, 60, 100) for k in ("sgd", "adam", "bias", "semantic")]
           + [("sgd", 60, 1000)]
           + [(k, TIERED_BASE, 60) for k in ("sgd", "adam", "bias")]
           + [("sgd", TIERED_BASE, 1000)])


@pytest.mark.parametrize("kind,orig_base,epochs", K1_RUNS,
                         ids=[f"{k}-{b}-{e}" for k, b, e in K1_RUNS])
def test_kernel_matches_twin(cuda, kind, orig_base, epochs):
    """Against the plain version (over 1000 epochs the accuracies of up to
    10 epochs may differ by one support row), and a rerun
    bit-identical."""
    long = epochs == 1000
    ops, cfg = k1_case(kind, cuda, max_epochs=epochs, orig_base=orig_base,
                       stable_target=10 ** 6 if long else 10)
    assert cfg.n_active == ops["w"].shape[0] == orig_base + 40
    out = ft.finetune_loop(**ops, cfg=cfg)
    ep = check_k1_matches_plain(ops, cfg, out, acc_flips=10 if long else 0)
    assert ep == epochs or not long
    assert _same(out, ft.finetune_loop(**ops, cfg=cfg))


@pytest.mark.parametrize("session", range(1, 9))
def test_k1_session_shapes_match_twin(cuda, session):
    """Each golden session's counts: 65..100 active classes, 0..175 replay
    rows, 0..35 reserved rows."""
    ops, cfg = k1_case("sgd", cuda, max_epochs=40, session=session)
    check_k1_matches_plain(ops, cfg, ft.finetune_loop(**ops, cfg=cfg))


@pytest.mark.parametrize("kind", ["sgd", "bias"])
@pytest.mark.parametrize("blocks", [1, 3, 17, None])
def test_k1_block_counts_match_twin(cuda, kind, blocks):
    """The grid's size changes who owns what, not the result (None: one
    block per SM)."""
    ops, cfg = k1_case(kind, cuda, max_epochs=30)
    ft._validate(ops, cfg)
    check_k1_matches_plain(ops, cfg, ft._launch(ops, cfg, blocks=blocks))


def test_k1_grid_that_cannot_be_resident_raises(cuda):
    ops, cfg = k1_case("sgd", cuda, max_epochs=5)
    before = ft.finetune_loop.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        ft._launch(ops, cfg, blocks=ft.k1_blocks(cuda) + 1)
    assert ft.finetune_loop.launches == before


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


@pytest.mark.parametrize("case", range(len(K2_STEP_SHAPES)),
                         ids=[s[0] for s in K2_STEP_SHAPES])
def test_k2_matches_plain(cuda, case):
    """At the fused step's shapes: y within 1 bf16 ulp of the plain version,
    the ulp taken at no less than 2^-8 of the summed |terms|
    (``k2_term_scale``: the f32 sums run in another order; the prologue
    rounds identically), and at most 0.1% of elements differing at all;
    the statistics are the sums of the kernel's own rounded y to rtol 1e-4
    of the sum of |y| (the partial sums run in another order)."""
    _, cin, cout, hw, pro = K2_STEP_SHAPES[case]
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


@pytest.mark.parametrize("kind", ["sgd", "bias"])
@pytest.mark.parametrize("orig_base,rows,classes", [(60, 360, 100),
                                                    (TIERED_BASE, 651, 391)])
def test_k1_matches_twin_at_the_vit_width(cuda, kind, orig_base, rows,
                                          classes):
    """D = 768, ViT-B/16's features (769 with the bias column): the last
    miniImageNet session (360 rows, 100 classes) and the last tiered one
    (651 rows, 391 classes); 60 epochs."""
    ops, cfg = k1_case(kind, cuda, max_epochs=60, orig_base=orig_base,
                       feat=768)
    assert cfg.n_sup + cfg.mem_count == rows and cfg.n_active == classes
    assert ops["w"].shape[1] == (769 if kind == "bias" else 768)
    check_k1_matches_plain(ops, cfg, ft.finetune_loop(**ops, cfg=cfg))


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
@pytest.mark.parametrize("case", range(len(K3_STEP_SHAPES)),
                         ids=[s[0] for s in K3_STEP_SHAPES])
def test_k3_bit_identical_to_plain(cuda, case, ties):
    _, c, hw = K3_STEP_SHAPES[case]
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


@pytest.mark.parametrize("case", range(len(K3_STEP_SHAPES)),
                         ids=[s[0] for s in K3_STEP_SHAPES])
def test_k3_rerun_is_bit_identical(cuda, case):
    _, c, hw = K3_STEP_SHAPES[case]
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


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n_seeds", [1, 2, 5, 10])
def test_k1_seed_batched_matches_single_launches_and_twin(cuda, n_seeds):
    """One launch of S seeds (blocks in S groups of G = P // S): each seed
    bit-identical to a single-seed launch on G blocks and equal to the
    plain version; seed 0 capped at 12 epochs, so its group stops while
    the others run on; a rerun bit-identical."""
    stacked, per, cfg = k1_seed_case("sgd", cuda, n_seeds, max_epochs=30,
                                     stable_target=10 ** 6, stop=(0, 12))
    g = ft.k1_blocks(cuda) // n_seeds
    before = (ft.finetune_loop.launches, ft.finetune_loop.seed_loops)
    out = ft.finetune_loop_seeds(**stacked, cfg=cfg)
    assert (ft.finetune_loop.launches, ft.finetune_loop.seed_loops) == (
        before[0] + 1, before[1] + n_seeds)
    for s in range(n_seeds):
        mine = tuple(t[s] for t in out)
        assert _same(mine, ft._launch(per[s], cfg, blocks=g))
        check_k1_matches_plain(per[s], cfg, mine)
        assert int(mine[1][1]) == (12 if s == 0 else 30)
    assert _same(out, ft.finetune_loop_seeds(**stacked, cfg=cfg))


@pytest.mark.parametrize("orig_base,n_seeds,twins,epochs",
                         [(60, 2, 2, 1000), (TIERED_BASE, 10, 1, 40),
                          (TIERED_BASE, 10, 1, 1000)],
                         ids=["S2-1000", "tiered-S10-40", "tiered-S10-1000"])
def test_k1_seed_batched_golden_lengths(cuda, orig_base, n_seeds, twins,
                                        epochs):
    """S seeds over 40 epochs or the golden run's 1000, at tieredImageNet's
    last session with S = 10 (G = P // 10 blocks a seed, ~31 update tiles
    a block): each seed bit-identical to a single-seed launch on its
    group's G = P // S blocks, the first ``twins`` seeds against the plain
    version, and a rerun bit-identical."""
    stacked, per, cfg = k1_seed_case("sgd", cuda, n_seeds, max_epochs=epochs,
                                     stable_target=10 ** 6,
                                     orig_base=orig_base)
    out = ft.finetune_loop_seeds(**stacked, cfg=cfg)
    g = ft.k1_blocks(cuda) // n_seeds
    for s in range(n_seeds):
        mine = tuple(t[s] for t in out)
        assert _same(mine, ft._launch(per[s], cfg, blocks=g)), s
        if s < twins:
            check_k1_matches_plain(per[s], cfg, mine,
                                   acc_flips=10 if epochs == 1000 else 0)
    assert _same(out, ft.finetune_loop_seeds(**stacked, cfg=cfg))


@pytest.mark.parametrize("kind", ["semantic", "bias", "adam"])
def test_k1_seed_batched_configurations(cuda, kind):
    stacked, per, cfg = k1_seed_case(kind, cuda, 3, max_epochs=25)
    out = ft.finetune_loop_seeds(**stacked, cfg=cfg)
    for s in range(3):
        check_k1_matches_plain(per[s], cfg, tuple(t[s] for t in out))
    assert _same(out, ft.finetune_loop_seeds(**stacked, cfg=cfg))


def test_k1_more_seeds_than_blocks_is_refused(cuda):
    stacked, _, cfg = k1_seed_case("sgd", cuda, 4, max_epochs=5)
    before = ft.finetune_loop.launches
    with pytest.raises(ValueError, match="seeds"):
        ft._launch_seeds(stacked, cfg, blocks=3)
    assert ft.finetune_loop.launches == before


def test_k1_no_fallback_when_the_library_fails_to_load(cuda, monkeypatch):
    """A kernel library that does not load raises; neither entry runs the
    plain version on CUDA tensors instead."""
    from subspace_reg_tpu_torch.utils import cuda_build

    def boom(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    def broken(name):
        raise OSError(f"cannot load {name}")

    monkeypatch.setattr(ft, "finetune_loop_plain", boom)
    monkeypatch.setattr(ft, "finetune_loop_seeds_plain", boom)
    monkeypatch.setattr(cuda_build, "load", broken)
    stacked, per, cfg = k1_seed_case("sgd", cuda, 2, max_epochs=5)
    before = ft.finetune_loop.launches
    with pytest.raises(OSError, match="finetune_loop"):
        ft.finetune_loop_seeds(**stacked, cfg=cfg)
    with pytest.raises(OSError, match="finetune_loop"):
        ft.finetune_loop(**per[0], cfg=cfg)
    assert ft.finetune_loop.launches == before


@pytest.mark.parametrize("rows", K4_ROWS)
@pytest.mark.parametrize("case", range(len(K4_SHAPES)),
                         ids=[s[0] for s in K4_SHAPES])
def test_k4_matches_f64_at_eval_shapes(cuda, case, rows):
    """Each convolution of the evaluation's forward at each of its batch
    sizes: max |y - y64| / max |y64| over the first, a middle and the last
    image within ``K4_TOL`` (f32 sums of up to 5,760 products in another
    order; TF32 reads ~1e-3); channels_last out."""
    _, cin, cout, hw, r, _ = K4_SHAPES[case]
    x, w = k4_case(cin, cout, hw, hw, r, rows, cuda)
    y = k4.conv_f32(x, w)
    assert y.shape == (rows, cout, hw, hw)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert k4_error(x, w, y) <= K4_TOL


@pytest.mark.parametrize("case", range(len(K4_EDGE_SHAPES)),
                         ids=[s[0] for s in K4_EDGE_SHAPES])
def test_k4_edge_shapes_match_f64(cuda, case):
    """Ragged rows and columns, one-pixel and non-square images, the k
    tile of 4: every image within ``K4_TOL``."""
    _, cin, cout, h, w, r, batch = K4_EDGE_SHAPES[case]
    x, wt = k4_case(cin, cout, h, w, r, batch, cuda)
    y = k4.conv_f32(x, wt)
    assert k4_error(x, wt, y, list(range(batch))) <= K4_TOL


# (name, Cin, Cout, H = W, R, rows)
K4_PLAIN_CASES = ((("s2 160->160 37 rows", 160, 160, 42, 3, 37),)
                  + tuple((n, ci, co, hw, r, min(K4_ROWS))
                          for n, ci, co, hw, r, _ in K4_SHAPES))


@pytest.mark.parametrize("case", K4_PLAIN_CASES, ids=lambda c: c[0])
def test_k4_is_deterministic_and_matches_plain(cuda, case):
    """Ragged rows at one shape, and each convolution of the evaluation's
    forward at its fewest rows: a rerun bit-identical, and against the
    plain version within ``K4_TOL`` of the largest output."""
    _, cin, cout, hw, r, rows = case
    x, w = k4_case(cin, cout, hw, hw, r, rows, cuda)
    y = k4.conv_f32(x, w)
    assert torch.equal(y, k4.conv_f32(x, w))
    plain = k4.conv_f32_plain(x, w)
    assert float((y - plain).abs().max() / plain.abs().max()) <= K4_TOL


def test_k4_counts_launches_and_refuses_bad_operands(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(k4, "conv_f32_plain", boom)
    x, w = k4_case(64, 64, 9, 9, 3, 2, cuda)
    before = k4.conv_f32.launches
    k4.conv_f32(x, w)
    k4.conv_f32(x.contiguous(), w)
    assert k4.conv_f32.launches == before + 2
    with pytest.raises(ValueError, match="multiple of 4"):
        k4.conv_f32(x, torch.randn((6, 64, 3, 3), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        k4.conv_f32(x.double(), w.double())
    with pytest.raises(ValueError, match="stride"):
        k4.conv_f32(x, w, stride=2)
    with pytest.raises(ValueError, match="channels_last"):
        k4.conv_f32(x[:, :, :, :4], w)
    assert k4.conv_f32.launches == before + 2


def test_k4_eval_forward_matches_cudnn(cuda, monkeypatch):
    """resnet18 at full width and 84 px, 200 rows, eval mode: the features
    through K4 against the same forward through cuDNN (f32, TF32 off)
    within 1e-5 of their largest (the benchmark's feature limit is 5e-5);
    22 launches a forward."""
    from subspace_reg_tpu_torch.models.factory import model_dict
    torch.manual_seed(0)
    m = model_dict["resnet18"](avg_pool=True).to(cuda).eval()
    x = torch.randn((200, 84, 84, 3), device=cuda).permute(0, 3, 1, 2)
    before = k4.conv_f32.launches
    with torch.no_grad():
        f = m(x.contiguous())
        assert k4.conv_f32.launches == before + 22
        monkeypatch.setattr(k4, "wanted", lambda x, w: False)
        ref = m(x.contiguous())
    assert k4.conv_f32.launches == before + 22
    assert float((f - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.parametrize("layout", ["cl", "nchw"])
@pytest.mark.parametrize("leaky", [True, False])
@pytest.mark.parametrize("case", K5_SHAPES, ids=lambda c: c[0])
def test_k5_matches_plain_at_step_shapes(cuda, case, leaky, layout):
    """Batch 64: the statistics, y, the running statistics, dx, dweight
    and dbias bit-identical to autograd through the plain chain and to a
    rerun, and the backward to its plain twin."""
    _, c, hw, _, _, _ = case
    r = k5_agreement(*k5_case(c, hw, 64, layout, cuda), leaky)
    assert k5_agreement_ok(r), r


@pytest.mark.parametrize("layout", ["cl", "nchw"])
def test_k5_launches_and_bit_identical_rerun(cuda, layout):
    """A forward and a backward through the autograd function run K5's
    four kernels and torch's four reductions between them (with the
    reductions' memsets), nothing else; a second run is bit-identical."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, w, b, rm, rv, dy = k5_case(160, 42, 64, layout, cuda)
    outs = []
    for i in range(3):
        xg = x.detach().requires_grad_()
        wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()
        rm1, rv1 = rm.clone(), rv.clone()
        before = k5.bn_train.launches
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y = k5.bn_train(xg, wg, bg, rm1, rv1, 0.1, 1e-5, True)
            y.backward(dy)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if i:
            ours = [n for n in names if "k5_" in n]
            sums = [n for n in names if "reduce_kernel" in n]
            rest = [n for n in names if n not in ours + sums
                    and not n.startswith("Memset")]
            assert len(ours) == 4 and len(sums) == 4 and not rest, names
        assert k5.bn_train.launches == before + 4
        outs.append((y, xg.grad, wg.grad, bg.grad, rm1, rv1))
    for p, q in zip(outs[1], outs[2]):
        assert torch.equal(p, q)


def test_k5_odd_widths_and_alignments_match_plain(cuda):
    """Channels_last at every vector width (C = 24, 12, 6, 5) and through a
    pointer offset by one element, NCHW with odd planes and one image."""
    for c, hw, batch, layout in ((24, 7, 3, "cl"), (12, 5, 2, "cl"),
                                 (6, 9, 3, "cl"), (5, 3, 4, "cl"),
                                 (40, 3, 1, "nchw"), (7, 11, 5, "nchw")):
        for leaky in (True, False):
            r = k5_agreement(*k5_case(c, hw, batch, layout, cuda), leaky)
            assert k5_agreement_ok(r), (c, hw, batch, layout, leaky, r)
    x, w, b, rm, rv, dy = k5_case(8, 6, 4, "cl", cuda)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xo = buf[1:].view(4, 6, 6, 8).permute(0, 3, 1, 2)
    xo.copy_(x)
    assert xo.is_contiguous(memory_format=torch.channels_last)
    r = k5_agreement(xo, w, b, rm, rv, dy, True)
    assert k5_agreement_ok(r), r


def test_k5_refuses_bad_operands(cuda):
    """Bad strides, dtypes, shapes, widths and devices raise before any
    launch; nothing falls back to the layer's ops."""
    x, w, b, rm, rv, _ = k5_case(16, 6, 2, "cl", cuda)
    before = k5.bn_train.launches
    with pytest.raises(ValueError, match="channels_last or NCHW"):
        k5.bn_train(x[:, :, :, :4], w, b, rm, rv)
    with pytest.raises(ValueError, match="channels_last or NCHW"):
        k5.bn_train(x.transpose(2, 3), w, b, rm, rv)
    with pytest.raises(ValueError, match="bfloat16"):
        k5.bn_train(x.float(), w, b, rm, rv)
    with pytest.raises(ValueError, match="weight"):
        k5.bn_train(x, w[:8], b, rm, rv)
    with pytest.raises(ValueError, match="float32"):
        k5.bn_train(x, w.double(), b, rm, rv)
    with pytest.raises(ValueError, match="CUDA card"):
        k5.bn_train(x.cpu(), w.cpu(), b.cpu(), rm.cpu(), rv.cpu())
    wide = torch.zeros((2, 1025, 2, 2), dtype=torch.bfloat16, device=cuda)
    ones = torch.ones(1025, device=cuda)
    with pytest.raises(ValueError, match="1025 channels"):
        k5.bn_train(wide, ones, ones, ones, ones)
    with pytest.raises(ValueError, match="threads a row"):
        k5.bn_train(wide[:, :257].contiguous(
            memory_format=torch.channels_last), ones[:257], ones[:257],
            ones[:257], ones[:257])
    assert k5.bn_train.launches == before
    k5.bn_train(x, w, b, rm, rv)
    assert k5.bn_train.launches == before + 2


def test_k5_module_routing_on_the_card(cuda):
    """A bf16 train-mode resnet forward on the card sends its 22
    BatchNorms to K5; eval mode, f32, a sample mask keep the ops."""
    from subspace_reg_tpu_torch.models.layers import TorchBatchNorm
    from subspace_reg_tpu_torch.models.factory import model_dict
    torch.manual_seed(0)
    m = model_dict["resnet18"](avg_pool=True, drop_rate=0.1,
                               no_dropblock=True, widths=(16, 24, 32, 40),
                               dtype=torch.bfloat16).to(cuda)
    x = torch.randn((4, 16, 16, 3), device=cuda).permute(0, 3, 1, 2)
    for mode, mask, want in (("train", None, 22), ("eval", None, 0),
                             ("train", torch.ones(4, device=cuda), 0)):
        m.train(mode == "train")
        k0 = TorchBatchNorm.kernel_forwards
        t0 = TorchBatchNorm.train_forwards
        launches = k5.bn_train.launches
        f = m(x, sample_mask=mask)
        assert torch.isfinite(f).all()
        assert TorchBatchNorm.kernel_forwards - k0 == want
        assert TorchBatchNorm.train_forwards - t0 == (
            22 if mode == "train" else 0)
        assert k5.bn_train.launches - launches == 2 * want


@pytest.mark.parametrize("no_dropblock", [True, False])
def test_pretrain_graph_step_matches_the_eager_step(cuda, monkeypatch,
                                                    no_dropblock):
    """The module step at full width, 84 px, batch 64, replayed as a CUDA
    graph, against the eager step from one state and one ``TorchDraws``:
    24 steps, the learning rate decayed at step 12, with the golden
    one-pixel DropBlock and with 5 x 5 blocks.  The graph replays the
    eager step's own kernels on the same draws, so its losses are the
    eager ones bit for bit and its parameters, momentum buffers, BatchNorm
    statistics and counters are no further from them than the eager step
    is from itself (the floor); the eager first step, captures at steps 1
    and 12 and 23 replays, K5's 88 launches counted at every step but the
    captures; a returned loss keeps its value through the next replay."""
    import numpy as np
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from torch_support import (BATCH, pretrain_backbone, pretrain_data,
                               pretrain_gaps, pretrain_run)
    data, labels = pretrain_data(cuda)
    r = np.random.RandomState(3)
    batches = [torch.from_numpy(r.randint(0, len(labels), BATCH)).to(cuda)
               for _ in range(24)]
    bb = pretrain_backbone(no_dropblock=no_dropblock)
    captures = []
    capture = pt.StepRunner._capture
    monkeypatch.setattr(pt.StepRunner, "_capture",
                        lambda self, state: (captures.append(state.step),
                                             capture(self, state)))
    replays, launches = pt.StepRunner.graph_replays, k5.bn_train.launches
    start, graph, m_graph = pretrain_run(bb, cuda, data, labels, batches, 12)
    assert pt.StepRunner.graph_replays - replays == 23
    assert captures == [1, 12]
    assert k5.bn_train.launches - launches == 24 * 88
    runs = [pretrain_run(bb, cuda, data, labels, batches, 12, eager=True)
            for _ in range(2)]
    assert pt.StepRunner.graph_replays - replays == 23
    (_, eager, m_eager), (_, again, m_again) = runs
    gaps = pretrain_gaps(start, graph, eager, m_graph, m_eager)
    floor = pretrain_gaps(start, again, eager, m_again, m_eager)
    print(f"graph against eager {gaps}; eager against itself {floor}")
    for a, b in zip(m_graph, m_eager):
        for k in ("loss", "acc1", "acc5"):
            assert torch.equal(a[k], b[k]), k
    for k in gaps:
        assert gaps[k] <= floor[k], (k, gaps, floor)
    assert all(int(v) == 24 for k, v in graph.backbone.named_buffers()
               if k.endswith("num_batches_tracked"))
    # the returned metrics are copies, not the graph's own outputs
    step = pt.make_train_step_device_data(
        graph.backbone, None, transforms_options["A"][0], False,
        TorchDraws(2, cuda))
    m = step(graph, data, labels, batches[0])
    m = step(graph, data, labels, batches[1])
    kept = m["loss"].clone()
    step(graph, data, labels, batches[2])
    assert torch.equal(m["loss"], kept)
