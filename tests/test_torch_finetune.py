"""K1's plain twin (subspace_reg_tpu_torch/ops/finetune.py) against the JAX
package's fused Pallas loop in interpret mode, on identical operands made
from a seeded numpy stream.  Every K1 configuration the engines use: SGD x
{subspace, semantic, no pull} x replay memory on/off, Adam, and the [W | b]
bias-column layout.

Tolerances are those of tests/test_pallas_finetune.py: W to rtol 2e-4 /
atol 2e-5 and the loss to rtol 1e-4 (f32 sums in another order, compounded
over the epochs), epochs exactly."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from subspace_reg_tpu.ops.pallas.finetune import (finetune_loop_pallas,
                                                  label_tile)
from subspace_reg_tpu.ops.pallas.finetune import pack_scalars as jax_scalars
from subspace_reg_tpu_torch.ops.finetune import (LoopConfig, finetune_loop,
                                                 finetune_loop_seeds,
                                                 pack_scalars)

C_PAD, D = 32, 128
NS_PAD, NM_PAD = 48, 32
TRACE_ROWS = 32


def _case(seed, *, memory_on, pull_mode, adam=False, bias=False):
    r = np.random.RandomState(seed)
    n_sup, mem_count = 40, (20 if memory_on else 0)
    orig_base, n_ways, n_active = 15, 5, 25
    n_reserved = 0 if bias else 5
    bias_col = D - 1 if bias else None

    f_sup = np.zeros((NS_PAD, D), np.float32)
    f_sup[:n_sup] = r.randn(n_sup, D)
    y_sup = np.zeros(NS_PAD, np.int32)
    y_sup[:n_sup] = r.randint(n_active - n_ways, n_active, n_sup)
    f_mem = np.zeros((NM_PAD, D), np.float32)
    y_mem = np.zeros(NM_PAD, np.int32)
    f_mem[:mem_count] = r.randn(mem_count, D)
    y_mem[:mem_count] = r.randint(orig_base, n_active - n_ways, mem_count)
    if bias:
        f_sup[:, bias_col] = 1.0
        f_mem[:, bias_col] = 1.0

    w = np.zeros((C_PAD, D), np.float32)
    w[:n_active] = 0.1 * r.randn(n_active, D)
    w0 = np.zeros_like(w)
    w0[:orig_base] = w[:orig_base] + 0.01 * r.randn(orig_base, D)
    reserved = np.zeros_like(w)
    reserved[orig_base:orig_base + n_reserved] = 0.1 * r.randn(n_reserved, D)
    mom = (0.01 * r.randn(C_PAD, D)).astype(np.float32)
    nu = (1e-4 * r.rand(C_PAD, D)).astype(np.float32)
    feat = D - 1 if bias else D
    q, _ = np.linalg.qr(w0[:orig_base, :feat].T.astype(np.float64))
    pull_m = np.zeros((D, D), np.float32)
    pull_m[:feat, :feat] = np.eye(feat) - q @ q.T
    pull_t = np.zeros_like(w)
    pull_t[n_active - n_ways:n_active] = 0.05 * r.randn(n_ways, D)

    hp = dict(lr=0.01, wd=0.0005 if adam else 5e-3, momentum=0.9,
              lmbd_base=0.2, lmbd_novel=0.1, gamma=0.5, eps=1e-4,
              target_loss=0.0, min_epochs=3, max_epochs=25, stable_target=4,
              prev_loss0=5.0, stable0=0.0, acc1_0=12.5, acc5_0=50.0)
    cfg = LoopConfig(n_sup=n_sup, mem_count=mem_count, n_active=n_active,
                     n_reserved=n_reserved, orig_base=orig_base,
                     n_ways=n_ways, memory_on=memory_on, use_regbase=True,
                     use_regnovel=not bias, pull_mode=pull_mode,
                     stable_mode=True, trace_rows=TRACE_ROWS, use_adam=adam,
                     bias_col=bias_col)
    arrays = dict(f_sup=f_sup, y_sup=y_sup, f_mem=f_mem, y_mem=y_mem, w=w,
                  mom=mom, nu=nu, w0=w0, reserved=reserved, pull_op=pull_m,
                  pull_tgt=pull_t)
    return arrays, hp, cfg


def _run_jax(a, hp, cfg):
    scalars = jax_scalars(
        lr=hp["lr"], wd=hp["wd"], momentum=hp["momentum"],
        lmbd_base=hp["lmbd_base"], lmbd_novel=hp["lmbd_novel"],
        gamma=hp["gamma"], eps=hp["eps"], target_loss=hp["target_loss"],
        min_epochs=hp["min_epochs"], max_epochs=hp["max_epochs"],
        stable_target=hp["stable_target"], n_active=cfg.n_active,
        n_reserved=cfg.n_reserved, mem_count=cfg.mem_count,
        prev_loss0=hp["prev_loss0"], stable0=hp["stable0"],
        orig_base=cfg.orig_base, n_ways=cfg.n_ways, acc1_0=hp["acc1_0"],
        acc5_0=hp["acc5_0"])
    w, stats, trace = finetune_loop_pallas(
        jnp.asarray(a["f_sup"]), label_tile(a["y_sup"], NS_PAD),
        jnp.asarray(a["f_mem"]), label_tile(a["y_mem"], NM_PAD),
        jnp.asarray(a["w"]), jnp.asarray(a["mom"]), jnp.asarray(a["nu"]),
        jnp.asarray(a["w0"]), jnp.asarray(a["reserved"]),
        jnp.asarray(a["pull_op"]), jnp.asarray(a["pull_tgt"]), scalars,
        n_sup=cfg.n_sup, memory_on=cfg.memory_on,
        use_regbase=cfg.use_regbase, use_regnovel=cfg.use_regnovel,
        pull_mode=cfg.pull_mode, stable_mode=cfg.stable_mode,
        orig_base=cfg.orig_base, n_ways=cfg.n_ways,
        trace_rows=TRACE_ROWS, use_adam=cfg.use_adam,
        bias_col=cfg.bias_col, interpret=True)
    return (np.asarray(w), np.asarray(stats)[0, :5],
            np.asarray(trace)[:, :3])


def _run_torch(a, hp, cfg):
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    scalars = pack_scalars(
        "cpu", **{k: v for k, v in hp.items()},
        adam_b1=0.9, adam_b2=0.999, adam_eps=1e-8)
    w, stats, trace = finetune_loop(**t, scalars=scalars, cfg=cfg)
    return w.numpy(), stats.numpy()[:5], trace.numpy()


def _compare(arrays, hp, cfg):
    w_j, st_j, tr_j = _run_jax(arrays, hp, cfg)
    w_t, st_t, tr_t = _run_torch(arrays, hp, cfg)
    ep = int(st_j[1])
    assert int(st_t[1]) == ep
    assert st_t[2] == st_j[2]                       # stable count
    np.testing.assert_allclose(st_t[0], st_j[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w_t, w_j, rtol=2e-4, atol=2e-5)
    # support accuracies are counts over 40 rows: equal unless a logit tie
    # flips, which these random features do not produce
    np.testing.assert_allclose(st_t[3:5], st_j[3:5], atol=1e-4)
    np.testing.assert_allclose(tr_t[2:ep + 1, 0], tr_j[2:ep + 1, 0],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tr_t[2:ep + 1, 1:], tr_j[2:ep + 1, 1:],
                               atol=1e-4)
    assert np.all(tr_t[ep + 1:] == 0) and np.all(tr_t[:2] == 0)
    return ep


@pytest.mark.parametrize("pull_mode", ["none", "subspace", "semantic"])
@pytest.mark.parametrize("memory_on", [False, True])
def test_sgd_twin_matches_pallas(pull_mode, memory_on):
    arrays, hp, cfg = _case(0, memory_on=memory_on, pull_mode=pull_mode)
    assert _compare(arrays, hp, cfg) >= 2


def test_adam_twin_matches_pallas():
    arrays, hp, cfg = _case(3, memory_on=True, pull_mode="subspace",
                            adam=True)
    hp["stable_target"] = 10 ** 6                   # run to max_epochs
    assert _compare(arrays, hp, cfg) == hp["max_epochs"]


def test_bias_column_twin_matches_pallas():
    arrays, hp, cfg = _case(5, memory_on=True, pull_mode="subspace",
                            bias=True)
    assert _compare(arrays, hp, cfg) >= 2


def test_epoch1_stop_is_replayed():
    """A stop already decided by epoch 1 runs no epoch in either package."""
    arrays, hp, cfg = _case(1, memory_on=True, pull_mode="subspace")
    hp["stable0"] = 4.0                             # == stable_target
    assert _compare(arrays, hp, cfg) == 1


def test_wrapper_validates_operands():
    arrays, hp, cfg = _case(0, memory_on=True, pull_mode="subspace")
    t = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    scalars = pack_scalars("cpu", **hp)
    bad = dict(t, pull_op=None)
    with pytest.raises(ValueError, match="pull_op"):
        finetune_loop(**bad, scalars=scalars, cfg=cfg)
    bad = dict(t, y_sup=t["y_sup"].long())
    with pytest.raises(ValueError, match="y_sup"):
        finetune_loop(**bad, scalars=scalars, cfg=cfg)
    bad = dict(t, w=t["w"].T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        finetune_loop(**bad, scalars=scalars, cfg=cfg)
    before = finetune_loop.launches
    finetune_loop(**t, scalars=scalars, cfg=cfg)
    assert finetune_loop.launches == before     # the twin is not a launch


@pytest.mark.parametrize("eps,lr", [(0.3, 0.002), (0.3, 0.01), (0.1, 0.01)])
def test_stable_stop_matches_pallas(eps, lr):
    """The stable-epoch stop fires before max_epochs, at the same epoch."""
    arrays, hp, cfg = _case(2, memory_on=True, pull_mode="subspace")
    hp.update(eps=eps, lr=lr)
    assert 2 < _compare(arrays, hp, cfg) < hp["max_epochs"]


def _seed_batch(pull_mode, lrs=(0.01, 0.03, 0.002)):
    """Three seeds of one geometry: operands from different streams, and
    per-seed scalars (the learning rate moves each seed's stop epoch)."""
    seeds = []
    for i, lr in enumerate(lrs):
        arrays, hp, cfg = _case(20 + i, memory_on=True, pull_mode=pull_mode)
        hp.update(lr=lr, eps=0.1)
        seeds.append((arrays, hp))
    stacked = {k: torch.from_numpy(np.stack([a[k] for a, _ in seeds]))
               for k in seeds[0][0]}
    scalars = torch.stack([pack_scalars("cpu", **hp, adam_b1=0.9,
                                        adam_b2=0.999, adam_eps=1e-8)
                           for _, hp in seeds])
    return seeds, stacked, scalars, cfg


@pytest.mark.parametrize("pull_mode", ["subspace", "semantic"])
def test_seed_batched_twin_equals_per_seed_loops(pull_mode):
    """``finetune_loop_seeds`` on CPU tensors: each seed's slice is what
    ``finetune_loop`` gives for that seed alone, bit for bit; and the
    first seed equals the Pallas kernel in interpret mode."""
    seeds, stacked, scalars, cfg = _seed_batch(pull_mode)
    w, stats, trace = finetune_loop_seeds(**stacked, scalars=scalars,
                                          cfg=cfg)
    assert w.shape == (3, C_PAD, D) and stats.shape == (3, 8)
    assert trace.shape == (3, TRACE_ROWS, 3)
    epochs = []
    for i, (arrays, hp) in enumerate(seeds):
        t = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
        one = finetune_loop(**t, scalars=scalars[i], cfg=cfg)
        for got, want in zip((w[i], stats[i], trace[i]), one):
            assert torch.equal(got, want)
        epochs.append(int(stats[i, 1]))
    assert len(set(epochs)) > 1           # the seeds stop at other epochs
    w_j, st_j, tr_j = _run_jax(seeds[0][0], seeds[0][1], cfg)
    assert int(st_j[1]) == epochs[0]
    np.testing.assert_allclose(w[0].numpy(), w_j, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(stats[0, 0].item(), st_j[0], rtol=1e-4,
                               atol=1e-5)


def test_seed_batched_entry_validates_operands():
    _, stacked, scalars, cfg = _seed_batch("subspace")
    with pytest.raises(ValueError, match="seeds"):
        finetune_loop_seeds(**dict(stacked, mom=stacked["mom"][:2]),
                            scalars=scalars, cfg=cfg)
    with pytest.raises(ValueError, match="pull_op"):
        finetune_loop_seeds(**dict(stacked, pull_op=None), scalars=scalars,
                            cfg=cfg)
    with pytest.raises(ValueError, match=r"\(S, Cp, D\)"):
        finetune_loop_seeds(**dict(stacked, w=stacked["w"][0]),
                            scalars=scalars, cfg=cfg)
    before = finetune_loop.launches
    finetune_loop_seeds(**stacked, scalars=scalars, cfg=cfg)
    assert finetune_loop.launches == before     # the twin is not a launch
