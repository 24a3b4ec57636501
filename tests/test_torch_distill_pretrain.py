"""Distillation pretraining in the port (engine/pretrain.py's KD term,
``init_nce_training``, ``make_train_step_nce``, ``build_negative_table``;
against the JAX package on the CPU, at
a narrow resnet18 (widths 8/16/24/32), 16 px, batch 8, ``nce_k`` 16,
``feat_dim`` 8, on the same weights, batch and draws (the JAX step's own
``jax.random`` draws, injected).

Tolerances, as tests/test_torch_pretrain.py:9-14 holds the plain step:
* f32 module-path steps (drop rate 0), two steps (the contrastive
  step's second from JAX's state after the first; see its test): loss,
  CE and contrast at rtol 1e-4;
  every updated parameter (the embed heads included) and the banks at
  rtol 1e-4 with atol 1e-4 of the leaf's largest value; Z at rtol 1e-4;
  running statistics at atol 1e-4; counters and accuracies exact; the
  teacher's weights, statistics and counters unchanged on both sides;
* the contrastive step's two steps run straight, each package from its
  own first step: the same, except the parameters and banks at atol
  ``STRAIGHT_PARAM_ATOL`` of the leaf's largest value and the running
  statistics at ``STRAIGHT_STAT_ATOL`` (the readings of
  ``python tests/test_torch_distill_pretrain.py``, below);
* the negative table and the negatives drawn from injected uniforms:
  equal exactly;
* the fused KD step against the module KD step: the chaos-control
  envelope (``torch_support.step_agreement``);
* a contrastive ``.ckpt`` read by the other package's loader: leaves
  equal.
The CLI's ``--distill kd|nce|crd`` is tests/test_torch_distill_cli.py.
"""

import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.data.transforms import transforms_options as jax_tf
from subspace_reg_tpu.engine import pretrain as jpt
from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet
from subspace_reg_tpu.utils import checkpoint as jckpt
from subspace_reg_tpu_torch.data.transforms import transforms_options
from subspace_reg_tpu_torch.distill.embed import (embed_from_jax,
                                                  embed_to_jax)
from subspace_reg_tpu_torch.distill.nce import NCEAverageState
from subspace_reg_tpu_torch.engine import pretrain as pt
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.ops.augment import AugmentDraws
from subspace_reg_tpu_torch.utils import checkpoint as ckpt
from subspace_reg_tpu_torch.utils import optim
from subspace_reg_tpu_torch.weights import from_jax_variables
from test_torch_pretrain import (BATCH, IMG, LR, N_CLS, SEED, SPE, WIDTHS,
                                 _jax_sd, _pair, _port_sd)
from torch_support import (ckpt_leaves, pretrain_backbone, pretrain_data,
                           pretrain_teacher, step_agreement)

NCE_K, FEAT, PER_CLASS = 16, 8, 4
N_DATA = N_CLS * PER_CLASS
# two contrastive steps run straight: the port's second step departs from
# JAX's by at most 7.8e-3 of a leaf's largest value (NCE; CRD 1.9e-3) and
# 5.6e-4 in a running statistic (CRD 6.9e-5), all in the student's BN
# layers; the bounds are 2.5x and 3.6x those readings
STRAIGHT_PARAM_ATOL, STRAIGHT_STAT_ATOL = 2e-2, 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for this module: the tier-1 lane runs six
    test processes at once, and their default thread pools (one thread per
    core each) oversubscribe the host by far more than these small
    operands gain from threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_augment(k_aug, n, spec):
    """augment_batch's draws from ``k_aug`` (JAX ops/augment.py)."""
    kcrop, kflip, kjit = jax.random.split(k_aug, 3)
    off = jax.random.randint(kcrop, (n, 2), 0, 2 * spec.padding + 1)
    flip = jax.random.bernoulli(kflip, shape=(n,))
    korder, kf = jax.random.split(kjit)
    lo, hi = 1.0 - spec.color_jitter, 1.0 + spec.color_jitter
    factors = jax.random.uniform(kf, (n, 3), minval=lo, maxval=hi)
    order = jnp.argsort(jax.random.uniform(korder, (n, 3)), axis=1)
    t = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt))  # noqa
    return AugmentDraws(offsets=t(off, np.int64), flip=t(flip, bool),
                        jitter_factors=t(factors, np.float32),
                        jitter_order=t(order, np.int64))


class JaxDistillDraws:
    """The JAX steps' draws: the plain (KD) step splits
    ``fold_in(PRNGKey(seed), step)`` in two, the contrastive step in three
    (augmentation, dropout, the negatives' uniforms); drop rate 0."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def pretrain_augment(self, step, n, spec):
        k_aug, _ = jax.random.split(jax.random.fold_in(self.key, step))
        return _jax_augment(k_aug, n, spec)

    def pretrain_dropout(self, step):
        return None

    def pretrain_contrastive(self, step, n, spec, nce_k):
        k_aug, _, k_neg = jax.random.split(
            jax.random.fold_in(self.key, step), 3)
        u = torch.from_numpy(np.array(jax.random.uniform(k_neg,
                                                         (n, nce_k))))
        return _jax_augment(k_aug, n, spec), None, u


def _teachers():
    """The same f32 narrow teacher in both packages, with non-trivial
    running statistics: (JAX teacher tuple, port teacher tuple)."""
    jt = JaxResNet(n_blocks=(1, 1, 2, 2), drop_rate=0.0, no_dropblock=True,
                   avg_pool=True, widths=WIDTHS)
    v = jax.tree.map(np.asarray, jt.init(
        jax.random.PRNGKey(7), jnp.zeros((2, IMG, IMG, 3)), train=False))
    r = np.random.RandomState(8)
    v["batch_stats"] = jax.tree.map(
        lambda a: (r.uniform(0.5, 1.5, a.shape) if a.min() == 1.0 else
                   0.1 * r.standard_normal(a.shape)).astype(np.float32),
        v["batch_stats"])
    w = (0.1 * r.standard_normal((N_CLS, WIDTHS[-1]))).astype(np.float32)
    module = ResNetRFS(n_blocks=(1, 1, 2, 2), drop_rate=0.0,
                       no_dropblock=True, avg_pool=True, widths=WIDTHS)
    module.load_state_dict(from_jax_variables(v))
    module.eval()
    return (jt, v, jnp.asarray(w), None), (module, torch.from_numpy(w), None)


def _data():
    r = np.random.RandomState(11)
    imgs = r.randint(0, 256, (N_DATA, IMG, IMG, 3)).astype(np.uint8)
    labels = np.repeat(np.arange(N_CLS), PER_CLASS).astype(np.int32)
    idxs = [r.choice(N_DATA, BATCH, replace=False) for _ in range(2)]
    return imgs, labels, idxs


def _assert_params(ref, got, steps=2, param_atol=1e-4, stat_atol=1e-4):
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(v) == steps, k
        elif "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=stat_atol, err_msg=k)
        else:
            np.testing.assert_allclose(
                got[k].numpy(), v.numpy(), rtol=1e-4,
                atol=param_atol * float(v.abs().max()), err_msg=k)


def test_negative_table_and_negatives_equal_jax():
    labels = np.random.RandomState(0).randint(0, 5, 60).astype(np.int32)
    want = jpt.build_negative_table(labels, 5)
    got = pt.build_negative_table(labels, 5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    # the JAX step's complement draw (engine/pretrain.py:282-292) on the
    # same uniforms
    y = labels[:16]
    u = jax.random.uniform(jax.random.PRNGKey(1), (16, 40))
    order, off, cnt = (jnp.asarray(a) for a in want)
    c = jnp.take(cnt, jnp.asarray(y))[:, None]
    o = jnp.take(off, jnp.asarray(y))[:, None]
    pos = jnp.minimum((u * (60 - c)).astype(jnp.int32), 60 - c - 1)
    pos = jnp.where(pos >= o, pos + c, pos)
    ref = np.asarray(jnp.take(order, pos, axis=0))
    table = tuple(torch.from_numpy(a).long() for a in got)
    negs = pt.draw_negatives(table, torch.from_numpy(y).long(),
                             torch.from_numpy(np.array(u)), 60)
    np.testing.assert_array_equal(negs.numpy(), ref)
    assert not (labels[negs.numpy()] == y[:, None]).any()


def _teacher_unchanged(port_teacher, jax_teacher, before):
    after = port_teacher[0].state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert all(int(b.num_batches_tracked) == 0
               for b in port_teacher[0].blocks())
    for k, v in from_jax_variables(jax_teacher[1]).items():
        assert torch.equal(after[k], v.reshape(after[k].shape)), k


def test_f32_kd_steps_match_jax():
    jbb, tx, js, bb, ts = _pair(torch.float32)
    jteacher, teacher = _teachers()
    before = {k: v.clone() for k, v in teacher[0].state_dict().items()}
    spec_j, _ = jax_tf["A"]
    spec, _ = transforms_options["A"]
    step_j = jpt.make_train_step(jbb, tx, spec_j, with_bias=False,
                                 teacher=jteacher, kd_temperature=4.0)
    step = pt.make_train_step(
        bb, optim.step_decay_schedule(LR, [60, 80], 0.1, SPE), spec, False,
        JaxDistillDraws(SEED), teacher=teacher, kd_temperature=4.0)
    imgs, labels, idxs = _data()
    key = jax.random.PRNGKey(SEED)
    for i in range(2):
        x, y = imgs[idxs[i]], labels[idxs[i]]
        js, mj = step_j(js, jnp.asarray(x), jnp.asarray(y), key)
        m = step(ts, torch.from_numpy(x), torch.from_numpy(y).long())
        assert float(m["loss"]) == pytest.approx(float(mj["loss"]),
                                                 rel=1e-4)
        assert float(m["acc1"]) == float(mj["acc1"])
    _assert_params(_jax_sd(js, False), _port_sd(ts))
    _teacher_unchanged(teacher, jteacher, before)


@pytest.mark.parametrize("mode,contrast", [("nce", "auto"),
                                           ("crd", "matmul")])
def test_f32_contrastive_steps_match_jax(mode, contrast, tmp_path):
    """Each of two steps from the same state in both packages: the
    first step's rounding grows in the second (through the student's
    train-mode BN, see ``rounding_report``), so the second step starts
    from JAX's state, carried over the ``.ckpt`` bridge."""
    _contrastive_steps(mode, contrast, tmp_path, carry=True)


@pytest.mark.parametrize("mode,contrast", [("nce", "auto"),
                                           ("crd", "matmul")])
def test_f32_contrastive_two_straight_steps_match_jax(mode, contrast,
                                                      tmp_path):
    """Two steps straight, each package from its own first step, at
    the parameter and statistic bounds set from the readings."""
    _contrastive_steps(mode, contrast, tmp_path, carry=False)


def _contrastive_setup(mode, contrast):
    """Both packages' contrastive state on the same weights, heads and
    banks, and their steps."""
    jbb, tx, js, bb, ts = _pair(torch.float32)
    jteacher, teacher = _teachers()
    before = {k: v.clone() for k, v in teacher[0].state_dict().items()}
    spec_j, _ = jax_tf["A"]
    spec, _ = transforms_options["A"]
    d = WIDTHS[-1]
    js, jes, jet, jnce = jpt.init_nce_training(
        jax.random.PRNGKey(5), js, tx, teacher_feat_dim=d,
        student_feat_dim=d, feat_dim=FEAT, n_data=N_DATA, nce_k=NCE_K,
        nce_t=0.07, nce_m=0.5)
    tx_t = functools.partial(optim.sgd_torch, learning_rate=LR,
                             momentum=0.9, weight_decay=5e-4)
    ts, es, et, pnce = pt.init_nce_training(
        torch.Generator().manual_seed(5), ts, tx_t, d, d, FEAT, N_DATA,
        NCE_K, 0.07, 0.5, device="cpu")
    order = (list(bb.parameters()) + list(es.parameters())
             + list(et.parameters()) + [ts.head["w"]])
    params = ts.optimizer.param_groups[0]["params"]
    assert len(params) == len(order)
    assert all(a is b for a, b in zip(params, order))
    for m, name in ((es, "embed_s"), (et, "embed_t")):
        embed_from_jax(m, jax.tree.map(np.asarray, js.params[name]))
    pnce = NCEAverageState.from_jax(jax.tree.map(np.asarray, {
        f: getattr(jnce, f) for f in ("memory_l", "memory_ab", "z_l",
                                      "z_ab", "params")}), "cpu")
    imgs, labels, idxs = _data()
    table = pt.build_negative_table(labels, N_CLS)
    step_j = jpt.make_train_step_nce(
        jbb, tx, spec_j, with_bias=False, teacher=jteacher, embed_s=jes,
        embed_t=jet, n_data=N_DATA, nce_k=NCE_K, mode=mode,
        contrast_mode=contrast)
    step = pt.make_train_step_nce(
        bb, optim.step_decay_schedule(LR, [60, 80], 0.1, SPE), spec, False,
        JaxDistillDraws(SEED), teacher, es, et, N_DATA, NCE_K, mode=mode,
        contrast_mode=contrast)
    return types.SimpleNamespace(
        js=js, jnce=jnce, ts=ts, pnce=pnce, es=es, et=et, bb=bb,
        teacher=teacher, jteacher=jteacher, before=before, step=step,
        step_j=step_j, imgs=imgs, labels=labels, idxs=idxs, table=table,
        spec=spec)


def _contrastive_steps(mode, contrast, tmp_path, carry):
    c = _contrastive_setup(mode, contrast)
    js, jnce, ts, pnce, es, et = c.js, c.jnce, c.ts, c.pnce, c.es, c.et
    imgs, labels, idxs, table = c.imgs, c.labels, c.idxs, c.table
    step, step_j = c.step, c.step_j
    key = jax.random.PRNGKey(SEED)
    data_j, labels_j = jnp.asarray(imgs), jnp.asarray(labels)
    table_j = tuple(jnp.asarray(a) for a in table)
    data_t = torch.from_numpy(imgs)
    labels_t = torch.from_numpy(labels).long()
    table_t = tuple(torch.from_numpy(a).long() for a in table)
    for i in range(2):
        if i == 1 and carry:
            # step 2 from JAX's state, carried over its .ckpt
            pnce = _carry_jax_state(ts, js, jnce, tmp_path)
        js, jnce, mj = step_j.device_data(js, jnce, data_j, labels_j,
                                          table_j, jnp.asarray(idxs[i]),
                                          key)
        pnce, m = step.device_data(ts, pnce, data_t, labels_t, table_t,
                                   torch.from_numpy(idxs[i]).long())
        for k in ("loss", "ce", "contrast"):
            assert float(m[k]) == pytest.approx(float(mj[k]), rel=1e-4), k
        assert float(m["acc1"]) == float(mj["acc1"])
        assert float(m["acc5"]) == float(mj["acc5"])
        ref, got = _jax_sd(js, False), _port_sd(ts)
        for name, module in (("embed_s", es), ("embed_t", et)):
            for layer, leaves in embed_to_jax(module).items():
                for leaf, v in leaves.items():
                    key_ = f"{name}.{layer}.{leaf}"
                    ref[key_] = torch.from_numpy(np.array(
                        js.params[name][layer][leaf]))
                    got[key_] = torch.from_numpy(v)
        for bank in ("memory_l", "memory_ab"):
            ref[bank] = torch.from_numpy(np.array(getattr(jnce, bank)))
            got[bank] = getattr(pnce, bank)
        if carry or i == 0:
            _assert_params(ref, got, steps=i + 1)
        else:
            _assert_params(ref, got, steps=i + 1,
                           param_atol=STRAIGHT_PARAM_ATOL,
                           stat_atol=STRAIGHT_STAT_ATOL)
        for z in ("z_l", "z_ab"):
            assert float(getattr(pnce, z)) == pytest.approx(
                float(getattr(jnce, z)), rel=1e-4)
    _teacher_unchanged(c.teacher, c.jteacher, c.before)


def _carry_jax_state(ts, js, jnce, tmp_path):
    """The JAX contrastive state written by the JAX package's
    ``save_checkpoint`` and restored into the port's ``ts`` as its CLI
    resumes (``restore_pretrain_state``, ``restore_contrastive``); returns
    the banks."""
    path = str(tmp_path / "carry.ckpt")
    extra = {"opt_state": js.opt_state, "step": js.step,
             "embed_s": js.params["embed_s"],
             "embed_t": js.params["embed_t"], "nce": jnce}
    jckpt.save_checkpoint(
        path, {"params": js.params["backbone"],
               "batch_stats": js.batch_stats, "counters": js.counters},
        types.SimpleNamespace(weight=js.params["head"]["w"], bias=None,
                              n_active=N_CLS), {"epoch": 1}, extra=extra)
    loaded = ckpt.load_checkpoint(path)
    pt.restore_pretrain_state(ts, *loaded, optimizer=False)
    nce_state = pt.restore_contrastive(ts, loaded[2], "cpu")
    assert ts.step == int(js.step)
    return nce_state


def test_fused_kd_step_agrees_with_module_kd_step():
    data, labels = pretrain_data("cpu", n_cls=N_CLS, per_class=4, img=IMG)
    idxs = torch.from_numpy(np.random.RandomState(0).randint(
        0, len(labels), BATCH))
    teacher = pretrain_teacher("cpu", widths=WIDTHS, n_cls=N_CLS)
    l_ref, l_fus, worst = step_agreement(
        "cpu", pretrain_backbone(widths=WIDTHS), data, labels, idxs,
        backend="pallas", n_cls=N_CLS, teacher=teacher)
    assert worst <= 1.0 and abs(l_fus - l_ref) <= 0.03 * abs(l_ref)


def test_contrastive_ckpt_across_packages(tmp_path):
    """A port contrastive ``.ckpt`` read by the JAX loader with the JAX
    CLI's second-phase ``extra_template`` (train_supervised.py:198-205),
    and a JAX one restored by the port (``restore_contrastive``): every
    leaf equal."""
    jbb, tx, js, bb, ts = _pair(torch.float32)
    d = WIDTHS[-1]
    js, _, _, jnce = jpt.init_nce_training(
        jax.random.PRNGKey(5), js, tx, teacher_feat_dim=d,
        student_feat_dim=d, feat_dim=FEAT, n_data=N_DATA, nce_k=NCE_K,
        nce_t=0.07, nce_m=0.5)
    tx_t = functools.partial(optim.sgd_torch, learning_rate=LR,
                             momentum=0.9, weight_decay=5e-4)
    ts, es, et, pnce = pt.init_nce_training(
        torch.Generator().manual_seed(5), ts, tx_t, d, d, FEAT, N_DATA,
        NCE_K, 0.07, 0.5, device="cpu")
    _, teacher = _teachers()
    imgs, labels, idxs = _data()
    table = tuple(torch.from_numpy(a).long() for a in
                  pt.build_negative_table(labels, N_CLS))
    spec, _ = transforms_options["A"]
    step = pt.make_train_step_nce(bb, None, spec, False,
                                  JaxDistillDraws(SEED), teacher, es, et,
                                  N_DATA, NCE_K)
    pnce, _ = step.device_data(ts, pnce, torch.from_numpy(imgs),
                               torch.from_numpy(labels).long(), table,
                               torch.from_numpy(idxs[0]).long())
    variables, head, extra = pt.checkpoint_parts(ts, pnce)
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, variables, head, {"epoch": 1}, extra=extra)
    template = {"opt_state": js.opt_state, "step": js.step,
                "embed_s": js.params["embed_s"],
                "embed_t": js.params["embed_t"], "nce": jnce}
    _, _, meta = jckpt.load_checkpoint(path, extra_template=template,
                                       device=False)
    got = meta["extra"]
    assert type(got["nce"]).__name__ == "NCEAverageState"
    assert int(got["step"]) == 1
    leaves = jax.tree_util.tree_leaves_with_path(got)
    flat = dict(ckpt_leaves(path))
    assert len(leaves) == sum(k.startswith("extra/") for k in flat)
    want_nce = pnce.to_jax()
    for f, v in want_nce.items():
        np.testing.assert_array_equal(np.asarray(getattr(got["nce"], f)), v)
    for name, module in (("embed_s", es), ("embed_t", et)):
        for layer, leaves_ in embed_to_jax(module).items():
            for leaf, v in leaves_.items():
                np.testing.assert_array_equal(
                    np.asarray(got[name][layer][leaf]), v)
    mom = jax.tree.leaves(got["opt_state"])
    assert any(np.abs(np.asarray(a)).sum() > 0 for a in mom)

    # the reverse: a JAX contrastive .ckpt into a fresh port state
    jpath = str(tmp_path / "jax.ckpt")
    jstate_extra = dict(template)
    jstate_extra["opt_state"] = jax.tree.map(
        lambda a: a + 0.25 if jnp.issubdtype(a.dtype, jnp.floating) else a,
        js.opt_state)
    jckpt.save_checkpoint(jpath, {"params": js.params["backbone"],
                                  "batch_stats": js.batch_stats,
                                  "counters": js.counters},
                          types.SimpleNamespace(weight=js.params["head"]["w"],
                                                bias=None, n_active=N_CLS),
                          {"epoch": 3}, extra=jstate_extra)
    _, _, _, bb2, ts2 = _pair(torch.float32)
    ts2, _, _, _ = pt.init_nce_training(None, ts2, tx_t, d, d, FEAT,
                                        N_DATA, NCE_K, 0.07, 0.5,
                                        device="cpu")
    loaded = ckpt.load_checkpoint(jpath)
    assert pt.restore_pretrain_state(ts2, *loaded, optimizer=False) == 4
    restored = pt.restore_contrastive(ts2, loaded[2], "cpu")
    _, _, back = pt.checkpoint_parts(ts2, restored)
    want = ckpt_leaves(jpath)
    for k, v in jax.tree_util.tree_flatten_with_path(back)[0]:
        name = "extra/" + "/".join(str(getattr(p, "key", p)) for p in k)
        np.testing.assert_array_equal(np.asarray(v), want[name], name)


def _worst(ref, got):
    """(worst parameter or bank difference over its leaf's largest value,
    its leaf; worst running-statistic difference, its leaf)."""
    worst = {"param": (0.0, ""), "stat": (0.0, "")}
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        kind = "stat" if "running" in k else "param"
        e = float((got[k] - v).abs().max())
        e /= 1.0 if kind == "stat" else float(v.abs().max())
        worst[kind] = max(worst[kind], (e, k))
    return worst["param"], worst["stat"]


def _step2_terms(c, tmp_path, carry):
    """Step 2's loss terms from the port's own first step or (``carry``)
    JAX's, each term's gradient over every trained parameter, and the
    student's block outputs."""
    key = jax.random.PRNGKey(SEED)
    table_t = tuple(torch.from_numpy(a).long() for a in c.table)
    c.js, c.jnce, _ = c.step_j.device_data(
        c.js, c.jnce, jnp.asarray(c.imgs), jnp.asarray(c.labels),
        tuple(jnp.asarray(a) for a in c.table), jnp.asarray(c.idxs[0]), key)
    pnce, _ = c.step.device_data(c.ts, c.pnce, torch.from_numpy(c.imgs),
                                 torch.from_numpy(c.labels).long(), table_t,
                                 torch.from_numpy(c.idxs[0]).long())
    if carry:
        pnce = _carry_jax_state(c.ts, c.js, c.jnce, tmp_path)
    from subspace_reg_tpu_torch.distill.criterion import nce_loss
    from subspace_reg_tpu_torch.distill.nce import nce_forward
    from subspace_reg_tpu_torch.ops import augment as aug_ops
    from subspace_reg_tpu_torch.ops import losses
    items = torch.from_numpy(c.idxs[1]).long()
    y = torch.from_numpy(c.labels).long()[items]
    aug, _, u = JaxDistillDraws(SEED).pretrain_contrastive(
        1, len(items), c.spec, NCE_K)
    x = aug_ops.augment_batch(torch.from_numpy(c.imgs)[items], c.spec,
                              aug).permute(0, 3, 1, 2)
    acts = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: acts.__setitem__(n, o.detach()))
        for n, m in c.bb.named_modules() if n.count(".") == 1]
    c.bb.train()
    feat_s = c.bb(x)
    for h in hooks:
        h.remove()
    ce = losses.cross_entropy(feat_s @ c.ts.head["w"].T, y)
    l = c.es(feat_s.float())
    ab = c.et(pt.teacher_features(c.teacher, x).float())
    idx = torch.cat([items[:, None], pt.draw_negatives(table_t, y, u,
                                                       N_DATA)], dim=1)
    out_l, out_ab, _ = nce_forward(pnce, l, ab, items, idx=idx)
    params = (list(c.bb.parameters()) + list(c.es.parameters())
              + list(c.et.parameters()) + [c.ts.head["w"]])
    grads = {}
    for k, term in (("CE", ce), ("NCE_l", nce_loss(out_l, N_DATA)),
                    ("NCE_ab", nce_loss(out_ab, N_DATA))):
        g = torch.autograd.grad(term, params, retain_graph=True,
                                allow_unused=True)
        grads[k] = torch.cat([torch.zeros(p.numel()) if q is None
                              else q.flatten() for p, q in zip(params, g)])
    theta = torch.cat([p.detach().flatten() for p in params])
    return grads, acts, theta


def rounding_report(tmp_path):
    """How far the port's contrastive step departs from JAX's when the two
    run straight, and which loss term carries the first step's rounding
    into the second: step 2's gradient of each term from the port's own
    first step against the same from JAX's, relative to its norm, and how
    the difference grows through the student's blocks."""
    for mode, contrast in (("nce", "auto"), ("crd", "matmul")):
        c = _contrastive_setup(mode, contrast)
        key = jax.random.PRNGKey(SEED)
        table_t = tuple(torch.from_numpy(a).long() for a in c.table)
        for i in range(2):
            c.js, c.jnce, _ = c.step_j.device_data(
                c.js, c.jnce, jnp.asarray(c.imgs), jnp.asarray(c.labels),
                tuple(jnp.asarray(a) for a in c.table),
                jnp.asarray(c.idxs[i]), key)
            c.pnce, _ = c.step.device_data(
                c.ts, c.pnce, torch.from_numpy(c.imgs),
                torch.from_numpy(c.labels).long(), table_t,
                torch.from_numpy(c.idxs[i]).long())
            ref, got = _jax_sd(c.js, False), _port_sd(c.ts)
            for bank in ("memory_l", "memory_ab"):
                ref[bank] = torch.from_numpy(np.array(getattr(c.jnce,
                                                              bank)))
                got[bank] = getattr(c.pnce, bank)
            (pe, pk), (se, sk) = _worst(ref, got)
            print(f"{mode} ({contrast}) straight, step {i + 1}: parameters "
                  f"{pe:.3e} of the leaf's largest value ({pk}); running "
                  f"statistics {se:.3e} ({sk})")
    own, own_acts, own_theta = _step2_terms(
        _contrastive_setup("nce", "auto"), tmp_path, carry=False)
    jax_, jax_acts, jax_theta = _step2_terms(
        _contrastive_setup("nce", "auto"), tmp_path, carry=True)
    rel_in = float((own_theta - jax_theta).norm() / jax_theta.norm())
    print(f"nce: parameters after step 1, port against JAX: {rel_in:.3e} "
          "of their norm")
    for k in own:
        n, d = float(jax_[k].norm()), float((own[k] - jax_[k]).norm())
        print(f"  step 2's gradient of {k}: norm {n:.4e}, port's own "
              f"against JAX's state {d / n:.3e} of it ({d / n / rel_in:.1f}"
              "x the parameters')")
    for k, v in jax_acts.items():
        d = float((own_acts[k] - v).norm() / v.norm())
        print(f"  student block {k}: port's own against JAX's state {d:.3e}")


if __name__ == "__main__":
    # python tests/test_torch_distill_pretrain.py (from the repository
    # root, JAX_PLATFORMS=cpu)
    import pathlib
    import sys
    import tempfile
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    torch.set_num_threads(1)
    rounding_report(pathlib.Path(tempfile.mkdtemp()))
