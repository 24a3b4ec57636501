"""The fused pretraining step (stages 1-2 through K2/K3: ops/fused_block.py)
on a data mesh of two gloo ranks against the single-process fused step on
the global batch, with the harness of tests/test_torch_mesh.py (ranks as
processes, a file store, a timeout on everything; its ``launch``,
``reference``, ``agreement`` and tolerances), at its narrow resnet18
(widths 8/16/24/32, 16 px, global batch 8, drop rate 0.1), every rank
and the single process starting from the JAX package's initial
parameters carried as numpy (``jax_initial_state``).

The fused step computes in bf16 in production; here it runs in f32 (the
fused block's f32 twin: ``can_fuse`` without its bf16 condition), as the
JAX package holds its mesh in f32, with backend "xla" and backend
"pallas" (the kernels' plain versions on the CPU).  Held at
test_torch_mesh.py's tolerances: loss rtol 2e-5, running statistics rtol
1e-4 / atol 1e-5, each update's cosine >= 0.999 and norm within 1%; the
fused blocks' BN statistics (what each K2 prologue takes) at the
statistics' tolerances, and bit-identical across the ranks.  One
single-process bf16 fused step is held against JAX's
``make_train_step(fused=True)`` with JAX's draws injected, inside the
chaos-control envelope of tests/test_torch_pretrain.py.

This file is also the rank script of the distillation scenarios
(tests/test_torch_mesh_distill.py) and of chip_smoke.py's phase 17:
``run`` serves the scenario kinds "fused", "kd", "nce" and "crd" through
test_torch_mesh.py's rank entry.
"""

import contextlib
import functools
import json
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import test_torch_mesh as mh

# a scenario's ``kind``: "fused" (``backend`` "xla" or "pallas"), "kd"
# (``fused`` optional), "nce" or "crd" (``feat_dim`` and ``nce_k``
# optional); ``dtype``, ``mode`` and ``steps`` as in test_torch_mesh.py
NCE_FEAT, NCE_K, NCE_T, NCE_M = 8, 16, 0.07, 0.5


def _tx():
    from subspace_reg_tpu_torch.utils import optim
    return functools.partial(optim.sgd_torch, learning_rate=0.05,
                             momentum=0.9, weight_decay=5e-4)


def _teacher(cfg, device, dtype):
    """A seeded teacher of the student's geometry and class count:
    (module in eval mode, head weight, None)."""
    from subspace_reg_tpu_torch.models.resnet import ResNetRFS
    torch.manual_seed(mh.SEED + 1)
    bb = ResNetRFS(n_blocks=tuple(cfg["n_blocks"]), drop_rate=0.1,
                   no_dropblock=True, avg_pool=True,
                   widths=tuple(cfg["widths"]),
                   dtype=torch.bfloat16 if dtype == "bf16" else None)
    w = 0.1 * torch.randn((cfg["n_cls"], cfg["widths"][-1]),
                          generator=torch.Generator().manual_seed(
                              mh.SEED + 2))
    return bb.to(device).eval(), w.to(device), None


def jax_initial_state(cfg, path: str, contrastive: bool = False) -> str:
    """The JAX package's initial pretraining state at ``cfg``'s geometry
    (``init_pretrain_state``: the backbone's variables and the head; with
    ``contrastive``, ``init_nce_training``'s embed heads and banks at this
    file's NCE geometry), as numpy leaves in the JAX state's form, pickled
    at ``path``: ``cfg["init_state"]`` makes every rank, and the
    reference, start from it (``_state``).  Called where JAX is, never in
    a rank."""
    import pickle
    import jax
    from subspace_reg_tpu.engine import pretrain as jpt
    from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet
    from subspace_reg_tpu.utils import optim as joptim
    jbb = JaxResNet(n_blocks=tuple(cfg["n_blocks"]), drop_rate=0.1,
                    no_dropblock=True, avg_pool=True,
                    widths=tuple(cfg["widths"]))
    tx = joptim.sgd_torch(0.05, momentum=0.9, weight_decay=5e-4)
    js = jpt.init_pretrain_state(jbb, jax.random.PRNGKey(mh.SEED),
                                 cfg["n_cls"], cfg["img"], tx,
                                 with_bias=False)
    out = {"variables": {"params": js.params["backbone"],
                         "batch_stats": js.batch_stats,
                         "counters": js.counters},
           "head": js.params["head"]["w"]}
    if contrastive:
        d = cfg["widths"][-1]
        js, _, _, jnce = jpt.init_nce_training(
            jax.random.PRNGKey(mh.SEED + 5), js, tx, teacher_feat_dim=d,
            student_feat_dim=d, feat_dim=NCE_FEAT, n_data=cfg["n_store"],
            nce_k=NCE_K, nce_t=NCE_T, nce_m=NCE_M)
        out.update(embed_s=js.params["embed_s"], embed_t=js.params["embed_t"],
                   nce={f: getattr(jnce, f) for f in (
                       "memory_l", "memory_ab", "z_l", "z_ab", "params")})
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, out), f)
    return path


def _carried(cfg):
    """``cfg["init_state"]``'s pickle (``jax_initial_state``), or None."""
    import pickle
    if not cfg.get("init_state"):
        return None
    with open(cfg["init_state"], "rb") as f:
        return pickle.load(f)


def _state(cfg, device, dtype):
    """test_torch_mesh.py's seeded state, its backbone's parameters and
    statistics and its head then taken from ``cfg["init_state"]`` when
    the configuration carries one (the block counters stay the
    harness's)."""
    from subspace_reg_tpu_torch.weights import from_jax_variables
    state = PLAIN_STATE(cfg, device, dtype)
    init = _carried(cfg)
    if init is not None:
        sd = dict(state.backbone.state_dict())
        sd.update({k: v for k, v in from_jax_variables(
            init["variables"]).items()
            if not k.endswith("num_batches_tracked")})
        state.backbone.load_state_dict(sd)
        with torch.no_grad():
            state.head["w"].copy_(torch.from_numpy(init["head"]))
    return state


def can_fuse_any_dtype(backbone, img_size, train):
    """``can_fuse`` without its bf16 condition: the fused step's f32 twin
    (the kernels' plain versions on the CPU, backend "xla" on a card)."""
    from subspace_reg_tpu_torch.models.fused_forward import can_fuse
    dt = backbone.dtype
    backbone.dtype = torch.bfloat16
    try:
        return can_fuse(backbone, img_size, train)
    finally:
        backbone.dtype = dt


def _step_run(cfg, scenario, device, mesh):
    """test_torch_mesh.py's run of the fused or KD step, the fused blocks'
    statistics recorded call by call (each a list of 8 tensors: mean and
    variance of bn1, bn2, bn3 and the downsample's BN), and K2's and K3's
    launches in the run."""
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.models import fused_forward as ff
    from subspace_reg_tpu_torch.ops import conv_fused as cf
    kw = {}
    fused = scenario["kind"] == "fused" or scenario.get("fused", False)
    if fused:
        kw.update(fused=True, fused_backend=scenario.get("backend", "pallas"))
    if scenario["kind"] == "kd":
        kw["teacher"] = _teacher(cfg, device, scenario.get("dtype", "f32"))
    recorded = []
    apply = ff.fb.fused_block_apply

    def record(*args, **kwargs):
        out, st = apply(*args, **kwargs)
        recorded.append([t.detach().cpu().clone() for pair in st
                         for t in pair])
        return out, st

    kernels = (cf.conv3x3_fused, cf.block_tail)
    for k in kernels:
        k.launches = 0
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            pt, "make_train_step", functools.partial(pt.make_train_step,
                                                     **kw)))
        stack.enter_context(mock.patch.object(ff.fb, "fused_block_apply",
                                              record))
        stack.enter_context(mock.patch.object(mh, "_state", _state))
        if fused and scenario.get("dtype", "f32") == "f32":
            stack.enter_context(mock.patch.object(pt, "can_fuse",
                                                  can_fuse_any_dtype))
        res = PLAIN_RUN(cfg, scenario, device, mesh)
    res["block_stats"] = recorded
    # the kernels' launches in this process (their plain versions on CPU
    # tensors count none), printed as a JSON line
    res["launches"] = {k.__name__: k.launches for k in kernels}
    print(json.dumps({"rank": None if mesh is None else mesh.rank,
                      "scenario": scenario["name"],
                      "steps": scenario["steps"],
                      "launches": res["launches"]}), flush=True)
    return res


def contrastive_state(state, nce_state):
    """``mh.host_state`` of a contrastive state (its optimizer's momentum
    left out: the embed heads join its parameters), the embed heads, and
    the banks, Z and parameters of ``nce_state``, on the host."""
    out = {k: v for k, v in mh.host_state(state).items()
           if not k.startswith("momentum.")}
    for name, module in state.embeds().items():
        out.update({f"{name}.{k}": v.detach().cpu().clone()
                    for k, v in module.state_dict().items()})
    out.update({f"nce.{k}": torch.from_numpy(v)
                for k, v in nce_state.to_jax().items()})
    return out


def _contrastive_run(cfg, scenario, device, mesh):
    """NCE or CRD steps from a seeded state, teacher, embed heads and
    banks over the ``n_store`` items, on batches of distinct items (one
    writer a bank row, as JAX assumes)."""
    import time
    from subspace_reg_tpu_torch.data.transforms import transforms_options
    from subspace_reg_tpu_torch.engine import pretrain as pt
    from subspace_reg_tpu_torch.engine.draws import TorchDraws
    from subspace_reg_tpu_torch.parallel import mesh as mesh_lib
    from subspace_reg_tpu_torch.utils.device import resolve_device
    resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    dtype = scenario.get("dtype", "f32")
    store, labels, _ = mh._data(cfg, scenario.get("pixels", "random"))
    r = np.random.RandomState(mh.SEED + 7)
    batches = [r.permutation(cfg["n_store"])[:cfg["batch"]]
               for _ in range(scenario["steps"])]
    state = _state(cfg, device, dtype)
    teacher = _teacher(cfg, device, dtype)
    nce_k = scenario.get("nce_k", NCE_K)
    state, embed_s, embed_t, nce_state = pt.init_nce_training(
        torch.Generator().manual_seed(mh.SEED), state, _tx(),
        teacher_feat_dim=teacher[0].feature_dim,
        student_feat_dim=state.backbone.feature_dim,
        feat_dim=scenario.get("feat_dim", NCE_FEAT), n_data=cfg["n_store"],
        nce_k=nce_k, nce_t=NCE_T, nce_m=NCE_M, device=device)
    init = _carried(cfg)
    if init is not None:
        from subspace_reg_tpu_torch.distill.embed import embed_from_jax
        from subspace_reg_tpu_torch.distill.nce import NCEAverageState
        for module, name in ((embed_s, "embed_s"), (embed_t, "embed_t")):
            embed_from_jax(module, init[name])
        nce_state = NCEAverageState.from_jax(init["nce"], device)
    if mesh is not None:
        for tree in (state.backbone, state.head, embed_s, embed_t,
                     list(vars(nce_state).values())):
            mesh_lib.replicate_tree(mesh, tree)
    init = contrastive_state(state, nce_state)
    spec, _ = transforms_options["A"]
    step = pt.make_train_step_nce(
        state.backbone, None, spec, False, TorchDraws(mh.SEED, device),
        teacher, embed_s, embed_t, n_data=cfg["n_store"], nce_k=nce_k,
        mode=scenario["kind"], mesh=mesh)
    neg_table = tuple(torch.from_numpy(a).long().to(device) for a in
                      pt.build_negative_table(labels, cfg["n_cls"]))
    store_d = torch.from_numpy(store).to(device)
    labels_d = torch.from_numpy(labels).to(device)
    metrics, z = [], []
    t0 = time.time()
    for idx in batches:
        idx_d = torch.from_numpy(idx).to(device)
        if scenario["mode"] == "device_data":
            nce_state, m = step.device_data(state, nce_state, store_d,
                                            labels_d, neg_table, idx_d)
        else:
            if mesh is not None:
                idx_d = mesh_lib.shard_batch(mesh, idx_d)
            nce_state, m = step(state, nce_state, store_d[idx_d],
                                labels_d[idx_d], idx_d, neg_table)
        metrics.append({k: float(v) for k, v in m.items()})
        z.append((float(nce_state.z_l), float(nce_state.z_ab)))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dict(metrics=metrics, init=init,
                final=contrastive_state(state, nce_state), z=z,
                seconds=time.time() - t0)


def run(cfg, scenario, device, mesh=None) -> dict:
    """One scenario of kind "fused", "kd", "nce" or "crd" (this rank's
    part under ``mesh``); the plain step's scenarios (no kind) as
    test_torch_mesh.py runs them."""
    kind = scenario.get("kind")
    if kind in ("nce", "crd"):
        return _contrastive_run(cfg, scenario, device, mesh)
    if kind in ("fused", "kd"):
        return _step_run(cfg, scenario, device, mesh)
    return PLAIN_RUN(cfg, scenario, device, mesh)


PLAIN_RUN, PLAIN_STATE = mh._run, mh._state


def launch(cfg, world: int, workdir: str):
    """test_torch_mesh.launch with this file as the ranks' script."""
    with mock.patch.object(mh, "__file__", __file__):
        return mh.launch(cfg, world, workdir)


def reference(cfg):
    """test_torch_mesh.reference of these scenarios."""
    with mock.patch.object(mh, "_run", run):
        return mh.reference(cfg)


def stats_excess(ref, got) -> float:
    """The worst |got - ref| / (atol + rtol |ref|) over lists of tensors,
    at the running statistics' tolerances (at most 1 agrees)."""
    worst = 0.0
    for a, b in zip(ref, got):
        d = (b.double() - a.double()).abs()
        worst = max(worst, float((d / (mh.STATS_ATOL + mh.STATS_RTOL
                                       * a.double().abs())).max()))
    return worst


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
    cfg = dict(mh.SMALL, device="cpu", scenarios=SCENARIOS, timeout_s=90.0)
    cfg["init_state"] = jax_initial_state(cfg, str(work / "init.pickle"))
    ranks = launch(cfg, 2, str(work))
    return ranks, reference(cfg), cfg


def test_every_rank_starts_from_the_jax_state(runs):
    """The ranks' and the single process's initial backbone and head are
    the JAX package's ``init_pretrain_state``, carried as numpy."""
    from subspace_reg_tpu_torch.weights import from_jax_variables
    ranks, ref, cfg = runs
    init = _carried(cfg)
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
        rep = mh.agreement(ref[name], r[name])
        assert rep["ok"], rep
    assert mh.ranks_identical(ranks, name)


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


if __name__ == "__main__":
    # a rank of ``launch``: test_torch_mesh.py's entry, these scenarios
    mh._run = run
    sys.exit(mh.main())
