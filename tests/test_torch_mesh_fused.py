"""The fused pretraining step (stages 1-2 through K2/K3: ops/fused_block.py)
on a data mesh of two gloo ranks against the single-process fused step on
the global batch, with the mesh harness of tests/torch_support.py (ranks
as processes, a file store, a timeout on everything; its ``launch``,
``reference``, ``agreement`` and tolerances), at its narrow resnet18
(widths 8/16/24/32, 16 px, global batch 8, drop rate 0.1), every rank
and the single process starting from the JAX package's initial
parameters carried as numpy (``jax_initial_state``).

The fused step computes in bf16 in production; here it runs in f32 (the
fused block's f32 twin: ``can_fuse`` without its bf16 condition), as the
JAX package holds its mesh in f32, with backend "xla" and backend
"pallas" (the kernels' plain versions on the CPU).  Held at
the harness's tolerances: loss rtol 2e-5, running statistics rtol
1e-4 / atol 1e-5, each update's cosine >= 0.999 and norm within 1%; the
fused blocks' BN statistics (what each K2 prologue takes) at the
statistics' tolerances, and bit-identical across the ranks.  One
single-process bf16 fused step is held against JAX's
``make_train_step(fused=True)`` with JAX's draws injected, inside the
chaos-control envelope of tests/test_torch_pretrain.py.
"""

import numpy as np
import pytest
import torch

from torch_support import (NCE_FEAT, NCE_K, NCE_M, NCE_T, SEED, SMALL,
                           agreement, carried_state, launch, ranks_identical,
                           reference, stats_excess)


def jax_initial_state(cfg, path: str, contrastive: bool = False) -> str:
    """The JAX package's initial pretraining state at ``cfg``'s geometry
    (``init_pretrain_state``: the backbone's variables and the head; with
    ``contrastive``, ``init_nce_training``'s embed heads and banks at the
    harness's NCE geometry), as numpy leaves in the JAX state's form,
    pickled at ``path``: ``cfg["init_state"]`` makes every rank, and the
    reference, start from it.  Called where JAX is, never in a rank."""
    import pickle
    import jax
    from subspace_reg_tpu.engine import pretrain as jpt
    from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet
    from subspace_reg_tpu.utils import optim as joptim
    jbb = JaxResNet(n_blocks=tuple(cfg["n_blocks"]), drop_rate=0.1,
                    no_dropblock=True, avg_pool=True,
                    widths=tuple(cfg["widths"]))
    tx = joptim.sgd_torch(0.05, momentum=0.9, weight_decay=5e-4)
    js = jpt.init_pretrain_state(jbb, jax.random.PRNGKey(SEED),
                                 cfg["n_cls"], cfg["img"], tx,
                                 with_bias=False)
    out = {"variables": {"params": js.params["backbone"],
                         "batch_stats": js.batch_stats,
                         "counters": js.counters},
           "head": js.params["head"]["w"]}
    if contrastive:
        d = cfg["widths"][-1]
        js, _, _, jnce = jpt.init_nce_training(
            jax.random.PRNGKey(SEED + 5), js, tx, teacher_feat_dim=d,
            student_feat_dim=d, feat_dim=NCE_FEAT, n_data=cfg["n_store"],
            nce_k=NCE_K, nce_t=NCE_T, nce_m=NCE_M)
        out.update(embed_s=js.params["embed_s"], embed_t=js.params["embed_t"],
                   nce={f: getattr(jnce, f) for f in (
                       "memory_l", "memory_ab", "z_l", "z_ab", "params")})
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, out), f)
    return path


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------
SCENARIOS = [dict(name="fused_xla", kind="fused", backend="xla", n_data=2,
                  n_model=1, steps=1, mode="streamed"),
             dict(name="fused_pallas", kind="fused", backend="pallas",
                  n_data=2, n_model=1, steps=1, mode="device_data")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_fused")
    cfg = dict(SMALL, device="cpu", scenarios=SCENARIOS, timeout_s=90.0)
    cfg["init_state"] = jax_initial_state(cfg, str(work / "init.pickle"))
    ranks = launch(cfg, 2, str(work))
    return ranks, reference(cfg), cfg


def test_every_rank_starts_from_the_jax_state(runs):
    """The ranks' and the single process's initial backbone and head are
    the JAX package's ``init_pretrain_state``, carried as numpy."""
    from subspace_reg_tpu_torch.weights import from_jax_variables
    ranks, ref, cfg = runs
    init = carried_state(cfg)
    want = from_jax_variables(init["variables"])
    for res in [r["fused_xla"] for r in ranks] + [ref["fused_xla"]]:
        got = res["init"]
        assert torch.equal(got["head.w"], torch.from_numpy(init["head"]))
        assert all(torch.equal(got[k], v) for k, v in want.items()
                   if not k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("name", ["fused_xla", "fused_pallas"])
def test_fused_step_on_two_ranks_equals_single_process(runs, name):
    """Two ranks' fused step (K2's epilogue sums all-reduced between the
    launches, the backward's BN sums too) equals the single-process fused
    step on the global batch, and the ranks stay bit-identical."""
    ranks, ref, _ = runs
    for r in ranks:
        rep = agreement(ref[name], r[name])
        assert rep["ok"], rep
    assert ranks_identical(ranks, name)


@pytest.mark.parametrize("name", ["fused_xla", "fused_pallas"])
def test_fused_block_statistics_are_the_global_batch(runs, name):
    """The statistics each fused block normalizes with, which fold into the
    next K2 launch's prologue, are the global batch's on every rank: equal
    to the single process's at the statistics' tolerances, bit-identical
    across the ranks; two blocks a step."""
    ranks, ref, _ = runs
    want = ref[name]["block_stats"]
    assert len(want) == 2
    for r in ranks:
        got = r[name]["block_stats"]
        assert len(got) == len(want)
        for a, b in zip(want, got):
            assert stats_excess(a, b) <= 1.0
    for a, b in zip(ranks[0][name]["block_stats"],
                    ranks[1][name]["block_stats"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_single_process_fused_step_matches_jax(backend):
    """The port's bf16 fused step against JAX's ``make_train_step(fused=
    True)`` (its XLA backend) from the same weights and batch, JAX's draws
    injected: loss within 1%, each update inside the chaos-control
    envelope of tests/test_torch_pretrain.py (at most 3x JAX's own step
    from half-ulp-perturbed weights, or 2% of the update); the block
    counters advance once."""
    import jax
    import jax.numpy as jnp
    from subspace_reg_tpu.data.transforms import transforms_options as jtf
    from subspace_reg_tpu.engine import pretrain as jpt
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from test_torch_pretrain import (SEED, JaxPretrainDraws, _batch,
                                     _jax_sd, _pair, _port_sd)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jbb, tx, js, bb, ts = _pair(torch.bfloat16)
        spec_j, _ = jtf["A"]
        spec, _ = transforms_options["A"]
        p0 = {k: v.clone() for k, v in _jax_sd(js, False).items()}
        r = np.random.RandomState(5)
        pert = jax.tree.map(lambda p: jnp.asarray(
            np.asarray(p) * (1.0 + 0.004 * r.standard_normal(p.shape)),
            jnp.float32), js.params)
        js_ctl = jax.tree.map(jnp.copy, js).replace(params=pert)
        p0_ctl = {k: v.clone() for k, v in _jax_sd(js_ctl, False).items()}
        step_j = jpt.make_train_step(jbb, tx, spec_j, with_bias=False,
                                     fused=True, fused_backend="xla")
        step = pt.make_train_step(bb, None, spec, False,
                                  JaxPretrainDraws(SEED), fused=True,
                                  fused_backend=backend)
        x, y = _batch()
        key = jax.random.PRNGKey(SEED)
        js_ctl, _ = step_j(js_ctl, jnp.asarray(x), jnp.asarray(y), key)
        js, mj = step_j(js, jnp.asarray(x), jnp.asarray(y), key)
        m = step(ts, torch.from_numpy(x), torch.from_numpy(y).long())
    finally:
        torch.set_num_threads(n)
    assert float(m["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-2)
    assert all(int(b.num_batches_tracked) == 1 for b in bb.blocks())
    ref, got, ctl = _jax_sd(js, False), _port_sd(ts), _jax_sd(js_ctl, False)
    for k, v0 in p0.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        u_ref, u_got = ref[k] - v0, got[k] - v0
        u_ctl = ctl[k] - p0_ctl[k]
        d = float((u_got - u_ref).norm())
        allow = max(3.0 * float((u_ctl - u_ref).norm()),
                    0.02 * float(u_ref.norm()))
        assert d <= allow, (k, d, allow)

