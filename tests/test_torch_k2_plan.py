"""K2's host side (subspace_reg_tpu_torch/ops/conv_fused.py), which the CPU
can check without the card: the packed weights are the shared-memory image
of the wgmma B operand that the kernel's descriptor assumes, and the launch
plan covers every output pixel exactly once within the card's shared
memory.  The kernel itself is held against the plain version on the card
(tests/test_torch_kernels_gpu.py).  Exact checks."""

import numpy as np
import pytest
import torch

from subspace_reg_tpu_torch.ops import conv_fused as cf

STEP_SHAPES = ((3, 64, 84), (64, 64, 84), (64, 160, 42), (160, 160, 42))
# resnet12 on CIFAR's 32 px images: stage 1 at 32 px, stage 2 at 16 px
CIFAR_SHAPES = ((3, 64, 32), (64, 64, 32), (64, 160, 16), (160, 160, 16))


def _byte_offset(tap, n, k, cin_pad, n_pad):
    """Where the kernel's descriptor reads B element (n, k) of a tap: the
    tap's slot, the K chunk's N x 16 block, the core matrix (8 output
    channels x 16 bytes) at SBO along N and LBO along K, row n % 8."""
    return (tap * cin_pad * n_pad * 2 + (k // 16) * (n_pad // 8) * cf.K2_SBO
            + (n // 8) * cf.K2_SBO + ((k % 16) // 8) * cf.K2_LBO
            + (n % 8) * 16 + (k % 8) * 2)


@pytest.mark.parametrize("cin,cout", [(3, 8), (5, 16), (24, 40), (64, 64),
                                      (64, 96), (160, 8), (160, 160)])
def test_pack_k2_weights_is_the_wgmma_b_image(cin, cout):
    r = np.random.RandomState(cin * 1000 + cout)
    w = torch.from_numpy(r.standard_normal((cout, cin, 3, 3)).astype(
        np.float32))
    plan = cf.k2_plan(2, 16, 16, cin, cout)
    n_pad, cin_pad = plan.n_pad, plan.cin_pad
    assert n_pad == (64 if cout <= 64 else 160)
    assert cin_pad % 16 == 0 and cin <= cin_pad < cin + 16
    packed = cf.pack_k2_weights(w, n_pad)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() == 9 * n_pad * cin_pad
    flat = packed.reshape(-1).to(torch.float32).numpy()
    tap, n, k = np.meshgrid(np.arange(9), np.arange(cout), np.arange(cin),
                            indexing="ij")
    idx = _byte_offset(tap, n, k, cin_pad, n_pad)
    assert np.all(idx % 2 == 0)
    idx //= 2
    assert len(np.unique(idx)) == idx.size
    # unpacking gives back the bf16 weights, tap = kh*3 + kw
    wb = w.to(torch.bfloat16).to(torch.float32).numpy()
    want = wb.transpose(2, 3, 0, 1).reshape(9, cout, cin)
    np.testing.assert_array_equal(flat[idx], want)
    # every pad row (n >= Cout) and column (k >= Cin) is zero
    rest = np.ones(flat.size, bool)
    rest[idx.ravel()] = False
    assert np.all(flat[rest] == 0.0)


def _covered(plan, b, h, w):
    """How often each output pixel is written: persistent block k walks the
    tiles k, k + grid, ...; tile gt is rows 0..m_tile-1 at flat positions
    (gt % tiles) * m_tile + row of image gt // tiles, read at the padded
    width wp; flat position p is pixel (p // wp, p % wp) when inside."""
    count = np.zeros((b, h, w), np.int64)
    gt = np.concatenate([np.arange(k, plan.n_blk, plan.grid)
                         for k in range(plan.grid)])
    img, tile = gt // plan.tiles, gt % plan.tiles
    p = tile[:, None] * plan.m_tile + np.arange(plan.m_tile)[None, :]
    hh, ww = p // plan.wp, p % plan.wp
    ok = (hh < h) & (ww < w)
    np.add.at(count, (np.broadcast_to(img[:, None], p.shape)[ok], hh[ok],
                      ww[ok]), 1)
    return count


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("hw", [84, 42, 16, 13, 1])
def test_k2_plan_covers_every_output_pixel_once(hw, batch):
    for cin, cout in ((3, 64), (64, 160), (160, 160)):
        plan = cf.k2_plan(batch, hw, hw, cin, cout)
        assert plan.wp == hw + 2 and plan.m_tile == 64 * plan.nc
        assert plan.n_blk == batch * plan.tiles
        assert plan.grid == min(plan.n_blk, 132)
        count = _covered(plan, batch, hw, hw)
        assert np.all(count == 1)
        # no block lies wholly past the image
        assert (plan.tiles - 1) * plan.m_tile < hw * plan.wp


@pytest.mark.parametrize("w", [84, 42, 21, 16, 13, 1])
def test_k2_plan_fits_shared_memory(w):
    """Every (Cin, Cout) the wrapper accepts, at the widths the backbones
    use: the plan's shared memory is within one block's limit and is the
    kernel's layout (ring + halo + statistics scratch + barriers)."""
    for cin in range(1, cf.MAX_COUT + 1):
        for cout in range(8, cf.MAX_COUT + 1, 8):
            plan = cf.k2_plan(2, w, w, cin, cout)
            assert 1 <= plan.stages <= 18 and 1 <= plan.nc <= 3
            assert plan.nbuf in (1, 2) and (plan.nbuf == 1 or cin % 8 == 0)
            assert plan.smem <= cf.K2_SMEM_MAX
            assert plan.smem == cf.k2_smem_bytes(plan.n_pad, plan.cin_pad,
                                                 plan.stages, plan.nc,
                                                 plan.nbuf, w)


def test_k2_plan_at_the_fused_step_shapes():
    """One block per SM; three consumer warpgroups at 64 output channels,
    two at 160; the 64-wide taps held for the block's life; the next
    tile's halo in flight wherever Cin is a multiple of 8."""
    plans = {s: cf.k2_plan(64, s[2], s[2], s[0], s[1]) for s in STEP_SHAPES}
    for (cin, cout, hw), plan in plans.items():
        assert plan.nc == (3 if cout == 64 else 2)
        assert plan.nbuf == (1 if cin == 3 else 2)
        assert plan.stages >= 2 and plan.grid == 132
        assert plan.resident == (cout == 64)
    assert plans[(64, 64, 84)].tiles == 38      # 84 x 86 flat / 192
    assert plans[(160, 160, 42)].tiles == 15    # 42 x 44 flat / 128


@pytest.mark.parametrize("shape", CIFAR_SHAPES,
                         ids=lambda s: "{}to{}_{}px".format(*s))
def test_k2_plan_at_the_cifar_step_shapes(shape):
    """CIFAR's fused step (batch 64): every output pixel written once; the
    3-channel image at 32 px keeps one halo buffer (its rows are not
    16-byte multiples), and a 32-pixel-wide image fits every warpgroup."""
    cin, cout, hw = shape
    plan = cf.k2_plan(64, hw, hw, cin, cout)
    assert plan.nc == (3 if cout == 64 else 2)
    assert plan.nbuf == (1 if cin == 3 else 2)
    assert plan.wp == hw + 2 and plan.grid == 132
    assert plan.tiles == -(-(hw * (hw + 2)) // plan.m_tile)
    assert np.all(_covered(plan, 64, hw, hw) == 1)


def test_k2_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="does not fit"):
        cf.k2_plan(1, 4, 1000, 160, 160)


def test_library_name_follows_every_header(tmp_path, monkeypatch):
    """An added or edited header under csrc/ renames (so rebuilds) every
    kernel's library; the sources themselves are unchanged."""
    from subspace_reg_tpu_torch.utils import cuda_build as cb
    for src in cb.SOURCES.values():
        (tmp_path / src).write_bytes((cb.CSRC_DIR / src).read_bytes())
    monkeypatch.setattr(cb, "CSRC_DIR", tmp_path)
    names = [cb.library_path("conv3x3_fused")]
    (tmp_path / "common.cuh").write_text("// one\n")
    names.append(cb.library_path("conv3x3_fused"))
    (tmp_path / "common.cuh").write_text("// two\n")
    names.append(cb.library_path("conv3x3_fused"))
    assert len(set(names)) == 3
