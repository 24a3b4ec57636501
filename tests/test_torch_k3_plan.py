"""K3's launch plan (subspace_reg_tpu_torch/ops/conv_fused.py::k3_plan),
which the CPU can check without the card: a Python model of the kernel's
thread decode (csrc/block_tail.cu) covers every (image, pooled row, pooled
column, channel) exactly once and reads each pooling window where NHWC puts
it; the vector width divides C and matches the pointers' alignment; the
tile loop fits 32 bits at any size the card holds; each thread loads its
affines once per group tile.  The kernel itself is held against the plain
version on the card (tests/test_torch_kernels_gpu.py).  Exact checks."""

import numpy as np
import pytest

from subspace_reg_tpu_torch.ops import conv_fused as cf

# (B, H, W, C): the fused step's two tails, then the card's edge shapes
STEP_SHAPES = ((64, 84, 84, 64), (64, 42, 42, 160))
# the two tails of resnet12's fused step on CIFAR's 32 px images
CIFAR_SHAPES = ((64, 32, 32, 64), (64, 16, 16, 160))
EDGE_SHAPES = ((1, 2, 2, 3), (3, 6, 10, 3), (3, 6, 10, 6), (3, 14, 14, 6),
               (1, 6, 10, 20), (3, 2, 2, 24), (1, 84, 84, 64),
               (3, 14, 14, 160), (2, 4, 6, 640), (1, 2, 4, 2049))
U32 = 2 ** 32


def _walk(plan, n_pix):
    """Model of the kernel's tile walk: block k takes tiles k, k + grid,
    ...; tile t is group tile t // pixel tiles and pixel tile t % pixel
    tiles.  Returns (the tiles in the order the blocks take them, one row
    per block, -1 padded; the number of pixel tiles)."""
    pix_tiles = -(-n_pix // plan.py)
    tiles = pix_tiles * plan.gtiles
    assert tiles + plan.grid < U32  # the kernel's 32-bit tile loop
    walk = np.full((plan.grid, -(-tiles // plan.grid)), -1, np.int64)
    for k in range(plan.grid):
        t = np.arange(k, tiles, plan.grid)
        walk[k, :len(t)] = t
    return walk, pix_tiles


def _decode(plan, b, h, w, c):
    """Model of the kernel's thread decode: thread (x, y) of a block on
    tile t owns group gtile*gx + x and pixel ptile*py + y when both are in
    range; pixel p is pooled row q = p // wo and column p % wo of the
    batch.  Checks that each thread's window starts where NHWC puts it;
    returns each owning thread's output offset (its first channel, in
    elements from the start of the tensor)."""
    ho, wo = h // 2, w // 2
    groups = c // plan.v
    n_pix = b * ho * wo
    walk, pix_tiles = _walk(plan, n_pix)
    t = walk[walk >= 0]
    assert np.array_equal(np.sort(t), np.arange(pix_tiles * plan.gtiles))
    t = t[:, None, None]
    x = np.arange(plan.gx)[None, :, None]
    y = np.arange(plan.py)[None, None, :]
    gtile, ptile = t // pix_tiles, t % pix_tiles
    g = np.broadcast_to(gtile * plan.gx + x, (len(t), plan.gx, plan.py))
    p = np.broadcast_to(ptile * plan.py + y, g.shape)
    ok = (g < groups) & (p < n_pix)
    g, p = g[ok].astype(np.int64), p[ok].astype(np.int64)
    q, pw = p // wo, p % wo
    ch = g * plan.v
    # the kernel's window base against where NHWC puts the window: image
    # bb, input rows 2ph and 2ph + 1
    base = 2 * q * w * c + 2 * pw * c + ch
    bb, ph = q // ho, q % ho
    assert np.array_equal(base, ((bb * h + 2 * ph) * w + 2 * pw) * c + ch)
    return p * c + ch


def _check_covers(plan, b, h, w, c):
    """Every pooled element written once: the threads' first channels are
    distinct multiples of v and their v-channel runs tile the output (and
    so their windows tile the input)."""
    outs = _decode(plan, b, h, w, c)
    n_out = b * (h // 2) * (w // 2) * c
    assert np.all(outs % plan.v == 0)
    assert np.all(np.bincount(outs // plan.v,
                              minlength=n_out // plan.v) == 1)
    assert 1 <= plan.grid <= 132 * cf.K3_MIN_BLOCKS


@pytest.mark.parametrize("shape", STEP_SHAPES + CIFAR_SHAPES + EDGE_SHAPES,
                         ids=lambda s: "b{}_{}x{}_c{}".format(*s))
def test_k3_plan_covers_every_pooled_element_once(shape):
    b, h, w, c = shape
    plan = cf.k3_plan(b, h, w, c)
    assert plan.gx * plan.py <= cf.K3_THREADS
    _check_covers(plan, b, h, w, c)


def test_k3_plan_at_the_fused_step_shapes():
    """16-byte vectors; stage 1 in blocks of 8 channel groups x 32 pixels,
    stage 2 in blocks of 20 x 12; 4 resident blocks on each of the 132 SMs
    walking all tiles."""
    p1 = cf.k3_plan(64, 84, 84, 64)
    p2 = cf.k3_plan(64, 42, 42, 160)
    assert p1 == (8, 8, 32, 1, 528)
    assert p2 == (8, 20, 12, 1, 528)
    # fewer SMs, or SMs that hold fewer threads, shrink the grid
    assert cf.k3_plan(64, 84, 84, 64, n_sm=66).grid == 264
    assert cf.k3_plan(64, 84, 84, 64, sm_threads=512).grid == 264
    # a small call gets one block per tile
    assert cf.k3_plan(1, 2, 2, 64).grid == 1


@pytest.mark.parametrize("c,offsets,want", [
    (64, (0, 0, 0, 0), 8), (160, (0, 0, 0, 0), 8), (24, (0, 0, 0, 0), 8),
    (20, (0, 0, 0, 0), 4), (6, (0, 0, 0, 0), 2), (3, (0, 0, 0, 0), 1),
    (64, (8, 0, 0, 0), 4), (64, (0, 4, 0, 0), 2), (64, (0, 0, 2, 0), 1),
    (64, (0, 0, 0, 4), 4), (64, (0, 0, 0, 2), 2), (64, (0, 0, 0, 1), 1),
    (160, (0, 24, 0, 4), 4), (20, (8, 8, 8, 4), 4), (6, (4, 4, 4, 2), 2)])
def test_k3_width_follows_channels_and_alignment(c, offsets, want):
    ptrs = tuple(0x7f0000000000 + o for o in offsets)
    v = cf.k3_width(c, ptrs)
    assert v == want
    assert c % v == 0
    assert all(p % (2 * v) == 0 for p in ptrs[:3]) and ptrs[3] % v == 0
    plan = cf.k3_plan(2, 6, 10, c, ptrs)
    assert plan.v == v
    _check_covers(plan, 2, 6, 10, c)


def test_k3_width_refuses_an_odd_bf16_pointer():
    with pytest.raises(ValueError, match="aligned"):
        cf.k3_width(64, (1, 0, 0, 0))


# (B, H, W, C), planned only: 4160 images of 2048 x 2048 at C = 1 (83 GB
# of operands, about all the card holds; pixel indices pass 2^32, where
# the kernel divides them in 64 bits), 2^31 - 1 images of one window, and
# one image of 2^31 pooled pixels at C = 2
HUGE_SHAPES = ((4160, 2048, 2048, 1), (2 ** 31 - 1, 2, 2, 1),
               (1, 2 ** 16, 2 ** 17, 2))


@pytest.mark.parametrize("shape", HUGE_SHAPES,
                         ids=lambda s: "b{}_{}x{}_c{}".format(*s))
def test_k3_plan_covers_calls_beyond_32_bit_pixel_indices(shape):
    """One launch at any size: the tile loop stays in 32 bits, and the last
    tiles of the walk own the last pooled pixels, whose window starts
    where NHWC puts it."""
    b, h, w, c = shape
    ho, wo = h // 2, w // 2
    n_pix = b * ho * wo
    plan = cf.k3_plan(b, h, w, c)
    pix_tiles = -(-n_pix // plan.py)
    tiles = pix_tiles * plan.gtiles
    assert plan.grid == 528 and tiles + plan.grid < U32
    t = tiles - 1
    p = (t % pix_tiles) * plan.py + np.arange(plan.py)
    p = p[p < n_pix]
    assert p[-1] == n_pix - 1
    q, pw = p // wo, p % wo
    bb, ph = q // ho, q % ho
    assert np.array_equal(2 * q * w * c + 2 * pw * c,
                          ((bb * h + 2 * ph) * w + 2 * pw) * c)
    assert bb[-1] == b - 1 and ph[-1] == ho - 1 and pw[-1] == wo - 1


@pytest.mark.parametrize("c", [3, 6, 20, 64, 160, 640, 2049, 4104])
def test_k3_affines_load_once_per_group_tile(c):
    """Each thread rounds the affines of its own V channels, all within
    the (C,) vectors, and only when its group tile changes: the tiles are
    group-tile major and a block takes them in rising order, so a block
    loads them once per group tile it visits (C = 2049 and 4104 have
    several)."""
    b, h, w = 3, 6, 10
    plan = cf.k3_plan(b, h, w, c)
    walk, pix_tiles = _walk(plan, b * (h // 2) * (w // 2))
    gtile = np.where(walk >= 0, walk // pix_tiles, -1)
    loads = (np.diff(gtile, axis=1) > 0).sum(1) + (gtile[:, 0] >= 0)
    visited = [len(set(row[row >= 0])) for row in gtile]
    assert np.array_equal(loads, visited)
    assert max(visited) <= plan.gtiles
    # the channels a thread's affine pairs read (ch + 2j and, at v > 1,
    # ch + 2j + 1 for j < ceil(v/2)) are its own v channels
    groups = c // plan.v
    ch = np.arange(groups) * plan.v
    reads = ch[:, None] + np.arange(plan.v)[None, :]
    assert np.array_equal(np.sort(reads.ravel()), np.arange(c))
    assert reads.max() < c
