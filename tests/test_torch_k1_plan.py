"""K1's launch plan (subspace_reg_tpu_torch/ops/finetune.py::k1_plan), which
the CPU can check without the card: on P persistent blocks, every logits
row, every pull column and every (class, column) of the gradient, of the
W update and of the anchor sums is owned by exactly one block, each block's
partial sums land in the slots the wrapper allocates, and a block's shared
memory fits.  Also the kernel's view of the operands (the feature axis
widened with zero columns to a multiple of 4).  The kernel itself is held
against the plain version on the card (tests/test_torch_kernels_gpu.py).
Exact checks; no JAX."""

import numpy as np
import pytest
import torch

from subspace_reg_tpu_torch.ops import finetune as ft

N_SUP, C_PAD, ORIG_BASE, N_WAYS = 185, 100, 60, 5
BLOCKS = (1, 2, 7, 66, 132)


def _covered(plan, seed=0):
    """How often each logits row, pull column and update element of seed
    ``seed`` is owned, over the blocks of its group; and the slots
    written."""
    rows = np.zeros(plan.rows, np.int64)
    cols = np.zeros(plan.d_pad, np.int64)
    upd = np.zeros((plan.c_pad, plan.d_pad), np.int64)
    slots = []
    for b in range(seed * plan.blocks, (seed + 1) * plan.blocks):
        work = ft.k1_work(plan, b)
        assert work["seed"] == work["bar"] == seed
        for lo, hi in work["logits"]:
            assert 0 <= lo < hi <= plan.rows and hi - lo <= ft.K1_TR
            rows[lo:hi] += 1
        for lo, hi in work["pull"]:
            assert 0 <= lo < hi <= plan.d_pad and hi - lo <= ft.K1_PULL_COLS
            cols[lo:hi] += 1
        for c0, c1, j0, j1, gemm in work["update"]:
            assert c1 - c0 <= ft.K1_TC and j1 - j0 <= ft.K1_TJ
            # the product runs exactly where the tile holds an active class
            assert gemm == (c0 < plan.n_active)
            # dlog's stride covers the tile's classes: no read past a row
            assert c0 + ft.K1_TC <= plan.ldl
            upd[c0:c1, j0:j1] += 1
        slots += work["slots"]
    return rows, cols, upd, slots


def _check_plan(plan, d, pull=True):
    assert plan.d_pad % 4 == 0 and d <= plan.d_pad < d + 4
    assert plan.ldl % ft.K1_TC == 0 and plan.c_pad <= plan.ldl
    rows, cols, upd, slots = _covered(plan)
    assert np.all(rows == 1)
    assert np.all(cols == (1 if pull else 0))
    assert np.all(upd == 1)
    # each block writes its own K1_NQ slots; together exactly the scratch
    assert sorted(slots) == list(range(plan.slots))
    cfg = ft.LoopConfig(n_sup=plan.rows, mem_count=0, n_active=plan.n_active,
                        n_reserved=0, orig_base=0, n_ways=N_WAYS,
                        memory_on=False, use_regbase=False,
                        use_regnovel=False, pull_mode="none",
                        stable_mode=False, trace_rows=8)
    scratch = ft.k1_scratch(plan, cfg, "cpu")
    assert scratch["slots"].numel() == plan.slots
    assert tuple(scratch["dlog"].shape) == (1, plan.rows, plan.ldl)
    assert tuple(scratch["w"].shape) == (1, plan.c_pad, plan.d_pad)
    assert scratch["bar"].dtype == torch.int32 and int(scratch["bar"]) == 0
    assert plan.smem == ft.k1_smem_bytes(plan.d_pad, plan.ldl, plan.rows)
    assert plan.smem <= ft.K1_SMEM_MAX


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("d", [640, 641])
@pytest.mark.parametrize("session", range(1, 9))
def test_k1_plan_partitions_each_golden_session(session, d, blocks):
    """Session s: 60 + 5s active classes, 25(s-1) valid replay rows of 200
    behind the 185 support rows; D = 640, or 641 with the bias column."""
    n_active, mem_count = ORIG_BASE + 5 * session, 25 * (session - 1)
    plan = ft.k1_plan(N_SUP + mem_count, n_active, C_PAD, d, N_WAYS, blocks)
    assert plan.blocks == blocks and plan.rows == N_SUP + mem_count
    assert plan.row_tiles == -(-plan.rows // ft.K1_TR)
    _check_plan(plan, d)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("d", [16, 17])
def test_k1_plan_partitions_a_narrow_head(d, blocks):
    plan = ft.k1_plan(19, 9, 12, d, 3, blocks)
    assert plan.ldl == 20 and plan.class_tiles == 1
    _check_plan(plan, d)


@pytest.mark.parametrize("blocks", [1, 132])
def test_k1_plan_without_pull_or_memory(blocks):
    """No subspace pull: no pull items; memory off: support rows only."""
    plan = ft.k1_plan(N_SUP, 100, C_PAD, 640, 0, blocks)
    assert plan.pull_chunks == 0 and plan.rows == N_SUP
    _check_plan(plan, 640, pull=False)


def test_k1_plan_at_the_last_session_on_the_card():
    """One block per SM of an H100: every phase-A item and every phase-B
    tile has a block of its own."""
    plan = ft.k1_plan(N_SUP + 175, 100, C_PAD, 640, N_WAYS, 132)
    assert (plan.row_tiles, plan.pull_chunks) == (45, 80)
    assert plan.items <= 132 and plan.tiles == 100


def test_k1_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        ft.k1_plan(185, 100, 100, 20000, 5, 132)
    with pytest.raises(ValueError, match="shared memory"):
        ft.k1_plan(5000, 100, 100, 640, 5, 132)
    with pytest.raises(ValueError, match="no plan"):
        ft.k1_plan(185, 100, 100, 640, 5, 0)


def test_kernel_operands_widen_with_zero_columns():
    """D = 641 -> 644: the given columns unchanged, the new ones zero
    (pull_op along both axes); labels and scalars untouched."""
    r = np.random.RandomState(0)
    ops = {name: torch.from_numpy(r.standard_normal(shape).astype(
        np.float32)) for name, shape in (("f_sup", (7, 641)),
                                         ("w", (12, 641)),
                                         ("pull_op", (641, 641)))}
    ops.update(y_sup=torch.arange(7, dtype=torch.int32), nu=None,
               scalars=torch.zeros(ft.N_SCALARS))
    out = ft.kernel_operands(ops, 644)
    assert out["nu"] is None and out["y_sup"] is ops["y_sup"]
    assert out["scalars"] is ops["scalars"]
    for name in ("f_sup", "w"):
        assert out[name].shape[1] == 644
        assert torch.equal(out[name][:, :641], ops[name])
        assert torch.all(out[name][:, 641:] == 0)
    assert out["pull_op"].shape == (644, 644)
    assert torch.equal(out["pull_op"][:641, :641], ops["pull_op"])
    assert torch.all(out["pull_op"][641:] == 0)
    assert torch.all(out["pull_op"][:, 641:] == 0)
    # already 4-wide and aligned: passed through as they are
    same = ft.kernel_operands({"w": ops["w"][:, :640].contiguous()}, 640)
    assert same["w"].shape == (12, 640)


@pytest.mark.parametrize("blocks", [132, 7])
@pytest.mark.parametrize("seeds", [1, 2, 5, 10])
def test_k1_plan_splits_the_grid_into_seed_groups(seeds, blocks):
    """The seed-batched launch: P blocks in S groups of G = P // S, the
    rest idle.  Within each group every logits row, pull column and update
    element of that seed is owned once; the slots and barrier counters of
    the seeds are disjoint and together exactly the scratch; a block keeps
    an operand resident exactly where it owns one item (tile) of its
    group, a decision taken on G.  More seeds than blocks are refused."""
    args = (N_SUP + 175, 100, C_PAD, 640, N_WAYS, blocks)
    if seeds > blocks:
        with pytest.raises(ValueError, match="seeds"):
            ft.k1_plan(*args, seeds=seeds)
        return
    plan = ft.k1_plan(*args, seeds=seeds)
    g = blocks // seeds
    assert (plan.seeds, plan.blocks, plan.grid) == (seeds, g, seeds * g)
    assert plan.idle == blocks - seeds * g and plan.slots == g * ft.K1_NQ
    slots = []
    for seed in range(seeds):
        rows, cols, upd, own = _covered(plan, seed)
        assert np.all(rows == 1) and np.all(cols == 1) and np.all(upd == 1)
        assert sorted(own) == list(range(seed * plan.slots,
                                         (seed + 1) * plan.slots))
        slots += own
    assert sorted(slots) == list(range(seeds * plan.slots))
    bars = [ft.k1_work(plan, b)["bar"] for b in range(plan.grid)]
    assert sorted(set(bars)) == list(range(seeds))
    for b in range(plan.grid):
        work = ft.k1_work(plan, b)
        items = len(work["logits"]) + len(work["pull"])
        assert work["resident"] == (items == 1, len(work["update"]) == 1)
    cfg = ft.LoopConfig(n_sup=N_SUP, mem_count=175, n_active=100,
                        n_reserved=35, orig_base=ORIG_BASE, n_ways=N_WAYS,
                        memory_on=True, use_regbase=True, use_regnovel=True,
                        pull_mode="subspace", stable_mode=True, trace_rows=8)
    scratch = ft.k1_scratch(plan, cfg, "cpu")
    assert scratch["slots"].numel() == seeds * plan.slots
    assert tuple(scratch["bar"].shape) == (seeds,)
    for name in ("w", "mom", "stats", "trace", "dlog", "pullv"):
        assert scratch[name].shape[0] == seeds


def test_k1_plan_at_ten_seeds_on_the_card():
    """S = 10 on an H100's 132 SMs: groups of 13, two blocks idle; no
    block of a group owns a single phase-A item (125 items on 13 blocks),
    so none keeps its F rows or M columns resident."""
    plan = ft.k1_plan(N_SUP + 175, 100, C_PAD, 640, N_WAYS, 132, seeds=10)
    assert (plan.blocks, plan.idle) == (13, 2)
    assert not any(ft.k1_work(plan, b)["resident"][0]
                   for b in range(plan.grid))
    single = ft.k1_plan(N_SUP + 175, 100, C_PAD, 640, N_WAYS, 132)
    assert all(ft.k1_work(single, b)["resident"][0]
               for b in range(single.items))


# tieredImageNet's golden geometry: 351 base classes + 8 sessions of 5, one
# exemplar per base class beside the 125 novel support rows, 200 replay rows
T_BASE, T_SUP = 351, 125 + 351
T_PAD = T_BASE + 8 * N_WAYS


@pytest.mark.parametrize("blocks", [1, 7, 132])
@pytest.mark.parametrize("d", [640, 641])
@pytest.mark.parametrize("session", [1, 4, 8])
def test_k1_plan_partitions_each_tiered_session(session, d, blocks):
    """tieredImageNet, session s: 351 + 5s of 391 classes, 476 support
    rows and 25(s-1) valid replay rows; every row, pull column and update
    element owned once within the card's shared memory."""
    n_active, mem_count = T_BASE + 5 * session, 25 * (session - 1)
    plan = ft.k1_plan(T_SUP + mem_count, n_active, T_PAD, d, N_WAYS, blocks)
    assert plan.ldl == 400 and plan.class_tiles == 20
    _check_plan(plan, d)


def test_k1_plan_at_the_last_tiered_session_on_the_card():
    """The last tiered session on 132 SMs: 651 rows in 82 logits tiles
    plus 80 pull chunks, so 30 blocks own two phase-A items and keep no
    operand resident; 20 x 20 = 400 update tiles, 3 or 4 a block; 180 KB
    of shared memory a block, within the 227 KB limit."""
    plan = ft.k1_plan(T_SUP + 175, T_PAD, T_PAD, 640, N_WAYS, 132)
    assert (plan.rows, plan.row_tiles, plan.pull_chunks) == (651, 82, 80)
    assert plan.tiles == 400 and plan.smem == 184560 < ft.K1_SMEM_MAX
    work = [ft.k1_work(plan, b) for b in range(132)]
    assert sum(len(w["logits"]) + len(w["pull"]) == 2 for w in work) == 30
    assert {len(w["update"]) for w in work} == {3, 4}
    assert not any(w["resident"][1] for w in work)


@pytest.mark.parametrize("blocks", [1, 7, 132])
@pytest.mark.parametrize("d", [768, 769])
@pytest.mark.parametrize("rows,n_active,c_pad", [
    (N_SUP, 65, C_PAD), (N_SUP + 175, 100, C_PAD),
    (T_SUP + 175, T_PAD, T_PAD)])
def test_k1_plan_at_the_vit_width(rows, n_active, c_pad, d, blocks):
    """ViT-B/16's 768 features (769 with a bias column): the first and
    last miniImageNet sessions and tiered's last; every row, pull column
    and update element owned once within the card's shared memory.  At
    360 rows and 100 classes a block needs 132,224 bytes of the 232,448."""
    plan = ft.k1_plan(rows, n_active, c_pad, d, N_WAYS, blocks)
    assert plan.d_pad == (768 if d == 768 else 772)
    assert plan.smem <= ft.K1_SMEM_MAX
    _check_plan(plan, d)
    if (rows, c_pad, d) == (N_SUP + 175, C_PAD, 768):
        assert plan.smem == 132224 and ft.K1_SMEM_MAX == 232448


@pytest.mark.parametrize("seeds", [2, 10])
def test_k1_plan_seed_groups_at_the_tiered_shapes(seeds):
    """The seed-batched launch at tiered's last session: at S = 10 each
    seed's 13 blocks own ~12 phase-A items and ~31 update tiles an epoch;
    each seed's rows, columns and update elements owned once."""
    plan = ft.k1_plan(T_SUP + 175, T_PAD, T_PAD, 640, N_WAYS, 132,
                      seeds=seeds)
    assert plan.blocks == 132 // seeds
    for seed in range(seeds):
        rows, cols, upd, own = _covered(plan, seed)
        assert np.all(rows == 1) and np.all(cols == 1) and np.all(upd == 1)
        assert sorted(own) == list(range(seed * plan.slots,
                                         (seed + 1) * plan.slots))
    if seeds == 10:
        counts = [len(ft.k1_work(plan, b)["update"]) for b in range(13)]
        assert (min(counts), max(counts)) == (30, 31)
