"""The port's pretraining engine (subspace_reg_tpu_torch/engine/pretrain.py
and what it runs) against the JAX package on the CPU, at a narrow resnet18
(widths 8/16/24/32, 16 px, batch 8), on the same weights, batch and
augmentation draws (the JAX step's own ``jax.random`` draws, injected).

Tolerances:
* bf16 elementwise rounding (LeakyReLU, the dropout scale, the folded BN in
  eval mode): bit-identical;
* f32 module-path steps (drop rate 0): loss at rtol 1e-4; every updated
  parameter at rtol 1e-4 with atol 1e-4 of the leaf's largest value, and
  the running statistics at atol 1e-4 (the single-pass BN variance
  E[x^2] - mean^2 cancels, which amplifies the different sum orders of the
  two convolution libraries in the BN gradients); counters exact;
* a bf16 step: loss within 1%; per parameter, the port-vs-JAX update
  difference at most 3x that of JAX's step from weights perturbed by 0.4%
  (bf16's half ulp), or 2% of the update -- the chaos control of
  tests/test_fused_forward.py, since bf16 rounds at other places in the
  two convolution libraries and this narrow geometry amplifies it;
* the port's fused step against its module step: the chaos-control
  envelope of tests/test_fused_forward.py (``torch_support.step_agreement``);
* schedules: rtol 1e-6 and atol 1e-8 (JAX evaluates them in f32);
* validation metrics: rtol 1e-5, accuracies exact.
"""

import contextlib
import copy
import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.data.transforms import transforms_options as jax_tf
from subspace_reg_tpu.engine import pretrain as jpt
from subspace_reg_tpu.models import layers as jlayers
from subspace_reg_tpu.models.fused_forward import _dropout as jax_dropout
from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet
from subspace_reg_tpu.utils import optim as joptim
from subspace_reg_tpu.utils.torch_import import import_checkpoint
from subspace_reg_tpu_torch.data.transforms import transforms_options
from subspace_reg_tpu_torch.engine import pretrain as pt
from subspace_reg_tpu_torch.engine.draws import TorchDraws
from subspace_reg_tpu_torch.models.layers import (TorchBatchNorm, dropout,
                                                  leaky_relu)
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.ops.augment import AugmentDraws
from subspace_reg_tpu_torch.utils import optim
from subspace_reg_tpu_torch.weights import (from_jax_variables,
                                            load_checkpoint,
                                            save_checkpoint)
from subspace_reg_tpu_torch.parallel.mesh import Mesh
from torch_support import (golden_tx, pretrain_backbone, pretrain_data,
                           pretrain_gaps, pretrain_run, pretrain_state,
                           pretrain_teacher, step_agreement)

WIDTHS = (8, 16, 24, 32)
N_CLS, IMG, BATCH, SEED = 12, 16, 8, 1
LR, SPE = 0.05, 10


class JaxPretrainDraws:
    """The JAX step's draws: ``split(fold_in(PRNGKey(seed), step))`` into
    the augmentation and dropout keys, then augment_batch's own calls."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def pretrain_augment(self, step, n, spec):
        k_aug, _ = jax.random.split(jax.random.fold_in(self.key, step))
        kcrop, kflip, kjit = jax.random.split(k_aug, 3)
        off = jax.random.randint(kcrop, (n, 2), 0, 2 * spec.padding + 1)
        flip = jax.random.bernoulli(kflip, shape=(n,))
        korder, kf = jax.random.split(kjit)
        lo, hi = 1.0 - spec.color_jitter, 1.0 + spec.color_jitter
        factors = jax.random.uniform(kf, (n, 3), minval=lo, maxval=hi)
        order = jnp.argsort(jax.random.uniform(korder, (n, 3)), axis=1)
        t = lambda a, dt: torch.from_numpy(np.asarray(a).astype(dt))
        return AugmentDraws(offsets=t(off, np.int64), flip=t(flip, bool),
                            jitter_factors=t(factors, np.float32),
                            jitter_order=t(order, np.int64))

    def pretrain_dropout(self, step):
        return None                  # drop rate 0 on both sides


def _batch(seed=0):
    r = np.random.RandomState(seed)
    x = r.randint(0, 256, size=(BATCH, IMG, IMG, 3)).astype(np.uint8)
    y = r.randint(0, N_CLS, size=(BATCH,)).astype(np.int32)
    return x, y


def _pair(dtype, with_bias=False):
    """A JAX state and the port's state holding the same weights."""
    jbb = JaxResNet(n_blocks=(1, 1, 2, 2), drop_rate=0.0, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS,
                    dtype=None if dtype == torch.float32 else jnp.bfloat16)
    sched_j = joptim.step_decay_schedule(LR, [60, 80], 0.1, SPE)
    tx = joptim.sgd_torch(sched_j, momentum=0.9, weight_decay=5e-4)
    js = jpt.init_pretrain_state(jbb, jax.random.PRNGKey(0), N_CLS, IMG, tx,
                                 with_bias=with_bias)
    bb = ResNetRFS(n_blocks=(1, 1, 2, 2), drop_rate=0.0, no_dropblock=True,
                   avg_pool=True, widths=WIDTHS,
                   dtype=None if dtype == torch.float32 else dtype)
    bb.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, {
        "params": js.params["backbone"], "batch_stats": js.batch_stats,
        "counters": js.counters})))
    tx_t = functools.partial(optim.sgd_torch, learning_rate=LR,
                             momentum=0.9, weight_decay=5e-4)
    ts = pt.init_pretrain_state(bb, N_CLS, tx_t, with_bias, device="cpu")
    with torch.no_grad():
        ts.head["w"].copy_(torch.from_numpy(np.array(js.params["head"]["w"])))
        if with_bias:
            ts.head["b"].copy_(torch.from_numpy(
                np.array(js.params["head"]["b"])))
    return jbb, tx, js, bb, ts


def _jax_sd(js, with_bias):
    """The JAX state as the port's state dict (plus the head)."""
    sd = from_jax_variables(jax.tree.map(np.asarray, {
        "params": js.params["backbone"], "batch_stats": js.batch_stats,
        "counters": js.counters}))
    sd["head.w"] = torch.from_numpy(np.array(js.params["head"]["w"]))
    if with_bias:
        sd["head.b"] = torch.from_numpy(np.array(js.params["head"]["b"]))
    return sd


def _port_sd(ts):
    sd = dict(ts.backbone.state_dict())
    sd.update({f"head.{k}": v.detach() for k, v in ts.head.items()})
    return sd


@pytest.mark.parametrize("with_bias,pull", [(False, None), (True, 0.5)])
def test_f32_module_steps_match_jax(with_bias, pull):
    jbb, tx, js, bb, ts = _pair(torch.float32, with_bias)
    spec_j, _ = jax_tf["A"]
    spec, _ = transforms_options["A"]
    embeds = None
    if pull is not None:
        embeds = np.random.RandomState(4).standard_normal(
            (N_CLS, 6)).astype(np.float32)
    step_j = jpt.make_train_step(jbb, tx, spec_j, with_bias=with_bias,
                                 label_pull=pull,
                                 pull_embeds=None if embeds is None
                                 else jnp.asarray(embeds))
    step = pt.make_train_step(bb, optim.step_decay_schedule(
        LR, [60, 80], 0.1, SPE), spec, with_bias, JaxPretrainDraws(SEED),
        label_pull=pull,
        pull_embeds=None if embeds is None else torch.from_numpy(embeds))
    key = jax.random.PRNGKey(SEED)
    for i in range(2):               # the second step runs on momentum
        x, y = _batch(i)
        js, mj = step_j(js, jnp.asarray(x), jnp.asarray(y), key)
        m = step(ts, torch.from_numpy(x), torch.from_numpy(y).long())
        assert float(m["loss"]) == pytest.approx(float(mj["loss"]),
                                                 rel=1e-4)
        assert float(m["acc1"]) == float(mj["acc1"])
    ref, got = _jax_sd(js, with_bias), _port_sd(ts)
    n = 0
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(v) == 2, k
        elif "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(
                got[k].numpy(), v.numpy(), rtol=1e-4,
                atol=1e-4 * float(v.abs().max()), err_msg=k)
            n += 1
    # 22 convolutions and 22 BNs' two vectors in 6 blocks, and the head
    assert n == 67 + (1 if with_bias else 0)


def test_bf16_step_inside_the_envelope():
    jbb, tx, js, bb, ts = _pair(torch.bfloat16)
    spec_j, _ = jax_tf["A"]
    spec, _ = transforms_options["A"]
    p0 = {k: v.clone() for k, v in _jax_sd(js, False).items()}
    # the control: JAX's step from half-ulp-perturbed weights
    r = np.random.RandomState(5)
    pert = jax.tree.map(lambda p: jnp.asarray(
        np.asarray(p) * (1.0 + 0.004 * r.standard_normal(p.shape)),
        jnp.float32), js.params)
    # a deep copy: the JAX step donates its state
    js_ctl = jax.tree.map(jnp.copy, js).replace(params=pert)
    p0_ctl = {k: v.clone() for k, v in _jax_sd(js_ctl, False).items()}
    step_j = jpt.make_train_step(jbb, tx, spec_j, with_bias=False)
    step = pt.make_train_step(bb, None, spec, False, JaxPretrainDraws(SEED))
    x, y = _batch()
    key = jax.random.PRNGKey(SEED)
    js_ctl, _ = step_j(js_ctl, jnp.asarray(x), jnp.asarray(y), key)
    js, mj = step_j(js, jnp.asarray(x), jnp.asarray(y), key)
    m = step(ts, torch.from_numpy(x), torch.from_numpy(y).long())
    assert float(m["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-2)
    ref, got = _jax_sd(js, False), _port_sd(ts)
    ctl = _jax_sd(js_ctl, False)
    for k, v0 in p0.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        u_ref, u_got = ref[k] - v0, got[k] - v0
        u_ctl = ctl[k] - p0_ctl[k]
        d = float((u_got - u_ref).norm())
        allow = max(3.0 * float((u_ctl - u_ref).norm()),
                    0.02 * float(u_ref.norm()))
        assert d <= allow, (k, d, allow)


def test_bf16_elementwise_rounding_is_bit_exact():
    r = np.random.RandomState(0)
    v = r.standard_normal((4, 16, 8, 8)).astype(np.float32)
    xj = jnp.asarray(v.transpose(0, 2, 3, 1), jnp.bfloat16)
    xt = torch.from_numpy(v).to(torch.bfloat16)
    nhwc = lambda t: t.float().permute(0, 2, 3, 1).numpy()
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    # LeakyReLU: jax.nn.leaky_relu on bf16
    np.testing.assert_array_equal(nhwc(leaky_relu(xt)),
                                  f32(jax.nn.leaky_relu(xj, 0.1)))
    # dropout: kept values divided by bf16(keep), as the JAX fused path's
    # dropout (and flax nn.Dropout) divide; the masks differ by generator,
    # so the values are compared where both kept
    out = nhwc(dropout(xt, 0.1, torch.Generator().manual_seed(0)))
    ref = f32(jax_dropout(jax.random.PRNGKey(0), xj, 0.1))
    both = (out != 0) & (ref != 0)
    assert both.mean() > 0.75
    np.testing.assert_array_equal(out[both], ref[both])
    # folded BN in eval mode: bf16 scale and shift, two roundings
    c = 16
    bn = TorchBatchNorm(c).eval()
    stats = {"mean": r.standard_normal(c).astype(np.float32),
             "var": r.uniform(0.5, 2.0, c).astype(np.float32)}
    params = {"scale": r.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": (0.1 * r.standard_normal(c)).astype(np.float32)}
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    ref = jlayers.TorchBatchNorm(c).apply(
        {"params": params, "batch_stats": stats}, xj, False)
    with torch.no_grad():
        got = bn(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(nhwc(got), f32(ref))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_fused_step_agrees_with_module_step(backend):
    data, labels = pretrain_data("cpu", n_cls=N_CLS, per_class=4, img=IMG)
    idxs = torch.from_numpy(np.random.RandomState(0).randint(
        0, len(labels), BATCH))
    l_ref, l_fus, worst = step_agreement(
        "cpu", pretrain_backbone(widths=WIDTHS), data, labels, idxs,
        backend=backend, n_cls=N_CLS)
    assert worst <= 1.0 and abs(l_fus - l_ref) <= 0.03 * abs(l_ref)


def test_fused_forward_counts_and_refuses_unfusable():
    bb = pretrain_backbone(widths=WIDTHS)
    ts = pt.init_pretrain_state(bb, N_CLS, functools.partial(
        optim.sgd_torch, learning_rate=LR), False, device="cpu")
    spec, _ = transforms_options["A"]
    draws = JaxPretrainDraws(SEED)
    draws.pretrain_dropout = lambda s: torch.Generator().manual_seed(s)
    step = pt.make_train_step(bb, None, spec, False, draws, fused=True,
                              fused_backend="pallas")
    x, y = _batch()
    step(ts, torch.from_numpy(x), torch.from_numpy(y).long())
    assert all(int(b.num_batches_tracked) == 1 for b in bb.blocks())
    bf32 = ResNetRFS(n_blocks=(1, 1, 2, 2), widths=WIDTHS)
    ts32 = pt.init_pretrain_state(bf32, N_CLS, functools.partial(
        optim.sgd_torch, learning_rate=LR), False, device="cpu")
    with pytest.raises(ValueError, match="bf16"):
        pt.make_train_step(bf32, None, spec, False, draws, fused=True)(
            ts32, torch.from_numpy(x), torch.from_numpy(y).long())
    # distillation: a KD teacher of another class count raises; the fused,
    # KD and contrastive steps build under a data mesh of two ranks (their
    # two-rank runs: tests/test_torch_mesh_{fused,distill}.py), and the
    # contrastive step refuses a class split it does not serve
    teacher = (pretrain_backbone(widths=WIDTHS, seed=3).eval(),
               torch.zeros(N_CLS + 1, WIDTHS[-1]), None)
    with pytest.raises(ValueError, match="KD teacher has 13 classes"):
        pt.make_train_step(bb, None, spec, False, draws, teacher=teacher)(
            ts, torch.from_numpy(x), torch.from_numpy(y).long())
    mesh = types.SimpleNamespace(world_size=2, n_data=2, n_model=1,
                                 data_group=None)
    assert callable(pt.make_train_step(bb, None, spec, False, draws,
                                       teacher=teacher, mesh=mesh,
                                       fused=True, fused_backend="pallas"))
    assert callable(pt.make_train_step_nce(
        bb, None, spec, False, draws, teacher, None, None, 10, 4,
        mesh=mesh).device_data)
    with pytest.raises(ValueError, match="one model rank"):
        pt.make_train_step_nce(bb, None, spec, False, draws, teacher, None,
                               None, 10, 4, mesh=types.SimpleNamespace(
                                   world_size=2, n_data=1, n_model=2))


@pytest.mark.parametrize("cosine", [False, True])
def test_schedules_match_jax_at_every_epoch_boundary(cosine):
    epochs, spe = 100, 7
    if cosine:
        ref = joptim.cosine_schedule(LR, 0.1, epochs, spe)
        got = optim.cosine_schedule(LR, 0.1, epochs, spe)
    else:
        ref = joptim.step_decay_schedule(LR, [60, 80], 0.1, spe)
        got = optim.step_decay_schedule(LR, [60, 80], 0.1, spe)
    steps = sorted({s for e in range(epochs + 1)
                    for s in (e * spe - 1, e * spe) if s >= 0})
    for s in steps:
        assert got(s) == pytest.approx(float(ref(s)), rel=1e-6, abs=1e-8), s


@pytest.mark.parametrize("faithful", [False, True])
def test_eval_step_and_validation_match_jax(faithful):
    jbb, _, js, bb, ts = _pair(torch.float32)
    _, spec_j = jax_tf["A"]
    _, spec = transforms_options["A"]
    r = np.random.RandomState(9)
    imgs = r.randint(0, 256, size=(10, IMG, IMG, 3)).astype(np.uint8)
    labels = r.randint(0, N_CLS, size=(10,)).astype(np.int32)
    ev_j = jpt.make_eval_step(jbb, spec_j, with_bias=False,
                              faithful_nbt=faithful)
    ev = pt.make_eval_step(bb, spec, with_bias=False, faithful_nbt=faithful)
    ref = jpt.run_validation(ev_j, js, imgs, labels, 4)
    got = pt.run_validation(ev, ts, imgs, labels, 4)
    if faithful:
        (ref, js), (got, ts) = ref, got
        counters = jax.tree_util.tree_leaves(js.counters)
        assert [int(c) for c in counters] == [
            int(b.num_batches_tracked) for b in bb.blocks()] == [3] * 6
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert got["acc1"] == ref["acc1"] and got["acc5"] == ref["acc5"]


def test_saved_pth_reads_back_in_both_packages(tmp_path):
    bb = pretrain_backbone(widths=WIDTHS)
    w = torch.randn(N_CLS, WIDTHS[-1])
    path = str(tmp_path / "resnet18_last.pth")
    save_checkpoint(path, bb, w, training_classes={3: 0, 7: 1},
                    label2human=["a", "b"], epoch=4)
    variables, head, meta = import_checkpoint(path, device=False)
    assert meta["epoch"] == 4 and meta["training_classes"] == {3: 0, 7: 1}
    assert meta["label2human"] == ["a", "b"] and not meta["has_bias"]
    np.testing.assert_array_equal(np.asarray(head.weight), w.numpy())
    sd = bb.state_dict()
    back = from_jax_variables(variables)
    assert set(back) == {k for k in sd if not k.endswith(
        "num_batches_tracked")}
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k].float().numpy(), k)
    sd_t, head_t, meta_t = load_checkpoint(path)
    assert meta_t["epoch"] == 4 and head_t.bias is None
    torch.testing.assert_close(head_t.weight, w, rtol=0, atol=0)
    again = ResNetRFS(n_blocks=(1, 1, 2, 2), widths=WIDTHS)
    again.load_state_dict(sd_t)
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k]), k


# ---------------------------------------------------------------------------
# the step's CUDA graph (engine/pretrain.py::StepRunner): what runs on the CPU
# ---------------------------------------------------------------------------
def test_drawn_ahead_uniforms_are_the_generators_own():
    """The dropout and DropBlock uniforms drawn ahead of a train-mode bf16
    forward (``DrawnAhead``, from the step's generator in the order and
    shapes the forward drew them, ``recording``) give the forward's
    output, running statistics and counters bit for bit; a draw of
    another shape, or one more, is refused."""
    bb = pretrain_backbone(widths=WIDTHS)
    x = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (BATCH, 3, IMG, IMG)).astype(np.float32))
    gen = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    eager, noted, ahead = (copy.deepcopy(bb).train() for _ in range(3))
    shapes = []
    out = [eager(x, generator=gen()),
           noted(x, generator=pt.recording(gen(), shapes))]
    # resnet18: a dropout in each of the 6 blocks, DropBlock's one-pixel
    # blocks in the last of stages 3 and 4
    assert len(shapes) == 6
    drawn = pt.DrawnAhead(shapes, "cpu").draw(gen())
    out.append(ahead(x, generator=drawn))
    assert drawn.spent()
    for o in out[1:]:
        assert torch.equal(o, out[0])
    for m in (noted, ahead):
        for (k, a), b in zip(eager.state_dict().items(),
                             m.state_dict().values()):
            assert torch.equal(a, b), k
    drawn.draw(gen())
    with pytest.raises(ValueError, match="drawn ahead"):
        drawn((1,) + shapes[0][1:], "cpu")
    for s in shapes:
        drawn(s, "cpu")
    with pytest.raises(ValueError, match="drawn ahead"):
        drawn(shapes[0], "cpu")


@pytest.mark.parametrize("cosine", [False, True])
def test_capture_key_follows_the_learning_rate(cosine):
    """The graph's key changes where the schedule's learning rate does (the
    step decay at its decay epochs, the cosine at every epoch) and nowhere
    else: not within an epoch, not as steps update the state in place."""
    epochs, spe = 6, 5
    sched = (optim.cosine_schedule(LR, 0.1, epochs, spe) if cosine
             else optim.step_decay_schedule(LR, [2, 4], 0.1, spe))
    data, labels = pretrain_data("cpu", n_cls=N_CLS, per_class=4, img=IMG)
    state = pretrain_state(pretrain_backbone(widths=WIDTHS), "cpu", N_CLS)
    step = pt.make_train_step(state.backbone, sched,
                              transforms_options["A"][0], False,
                              TorchDraws(1, "cpu"))
    x, y = data[:BATCH], labels[:BATCH]
    step(state, x, y)     # the momentum buffers
    runner = step.runner

    def key(s):
        optim.set_lr(state.optimizer, sched(s))
        return runner.capture_key(state, runner.warm_key(state, "inputs"))

    keys = [key(s) for s in range(epochs * spe)]
    for s in range(1, epochs * spe):
        moved = keys[s] != keys[s - 1]
        assert moved == (sched(s) != sched(s - 1)), s
        assert not moved or s % spe == 0, s
    assert len(set(keys)) == (epochs if cosine else 3)
    step(state, x, y)
    assert key(1) == keys[1]


def _mesh_of_one():
    return Mesh(n_data=1, n_model=1, rank=0, world_size=1, data_index=0,
                model_index=0, data_group=None, model_group=None,
                world_group=None, device=torch.device("cpu"))


def test_graph_stays_off_where_the_step_does_not_allow_it():
    """The module step's runner may replay a CUDA graph (on a card only),
    with DropBlock too; a mesh, the fused step, a KD teacher and the label
    pull never.  On the CPU every one runs its body eagerly: two steps of each
    equal its body's, run directly on the same draws, bit for bit, and
    none replays."""
    data, labels = pretrain_data("cpu", n_cls=N_CLS, per_class=4, img=IMG)
    spec = transforms_options["A"][0]
    bb = pretrain_backbone(widths=WIDTHS)
    variants = {
        "module": dict(), "mesh": dict(mesh=_mesh_of_one()),
        "fused": dict(fused=True),
        "teacher": dict(teacher=pretrain_teacher("cpu", WIDTHS, N_CLS)),
        "pull": dict(label_pull=0.5, pull_embeds=torch.randn(N_CLS, 4))}
    sched = optim.step_decay_schedule(LR, [60, 80], 0.1, SPE)
    replays = pt.StepRunner.graph_replays
    for name, kw in variants.items():
        states = [pretrain_state(bb, "cpu", N_CLS) for _ in range(2)]
        steps = [pt.make_train_step(s.backbone, sched, spec, False,
                                    TorchDraws(1, "cpu"), **kw)
                 for s in states]
        assert steps[0].runner.capturable == (name == "module"), name
        draws = TorchDraws(1, "cpu")
        steps_before = pt.StepRunner.graph_steps
        for t in range(2):
            idxs = torch.arange(t * BATCH, (t + 1) * BATCH)
            got = steps[0](states[0], data[idxs], labels[idxs])
            st = states[1]

            def draw(s=st.step, st=st):
                optim.set_lr(st.optimizer, sched(s))
                return (draws.pretrain_augment(s, BATCH, spec),
                        draws.pretrain_dropout(s))

            ref = steps[1].runner.body(st, data[idxs], labels[idxs], draw)
            st.step += 1
            for k in ("loss", "acc1", "acc5"):
                assert torch.equal(got[k], ref[k]), (name, k)
        assert pt.StepRunner.graph_steps - steps_before == 2
        for (k, a), b in zip(states[0].backbone.state_dict().items(),
                             states[1].backbone.state_dict().values()):
            assert torch.equal(a, b), (name, k)
    assert pt.StepRunner.graph_replays == replays
    dropblock = ResNetRFS(n_blocks=(1, 1, 2, 2), drop_rate=0.1,
                          dropblock_size=5, widths=WIDTHS,
                          dtype=torch.bfloat16)
    assert pt.make_train_step(dropblock, sched, spec, False,
                              TorchDraws(1, "cpu")).runner.capturable


@pytest.mark.parametrize("streamed", [False, True])
def test_replayed_steps_stage_each_steps_inputs(monkeypatch, streamed):
    """The graph path's staging, with the capture modelled on the CPU
    (capture records the body and runs nothing; a replay runs it on the
    staged buffers): 24 steps, the learning rate decayed at step 12, equal
    the eager steps bit for bit, with the batch gathered from the store or
    from the loader; the first step eager, captures at steps 1
    and 12, 23 replays, and each step's metrics its own."""
    captures = []

    def capture(self, state):
        captures.append(state.step)
        out = torch.empty(3)

        def replay():
            m = self.body(state, self._x, self._y,
                          lambda: (self._aug, self._drawn))
            out.copy_(torch.stack([m["loss"], m["acc1"], m["acc5"]]))
        self._graph, self._out = types.SimpleNamespace(replay=replay), out

    monkeypatch.setattr(pt.StepRunner, "_capture", capture)
    monkeypatch.setattr(pt.StepRunner, "engages",
                        lambda self, state: self.capturable)
    monkeypatch.setattr(pt, "_side_stream",
                        lambda dev: contextlib.nullcontext())
    data, labels = pretrain_data("cpu", n_cls=N_CLS, per_class=4, img=IMG)
    r = np.random.RandomState(3)
    batches = [torch.from_numpy(r.randint(0, len(labels), BATCH))
               for _ in range(24)]
    bb = pretrain_backbone(widths=WIDTHS)
    replays = pt.StepRunner.graph_replays
    start, graph, m_graph = pretrain_run(bb, "cpu", data, labels, batches,
                                         12, n_cls=N_CLS, streamed=streamed)
    assert pt.StepRunner.graph_replays - replays == 23
    assert captures == [1, 12]
    _, eager, m_eager = pretrain_run(bb, "cpu", data, labels, batches, 12,
                                     eager=True, n_cls=N_CLS,
                                     streamed=streamed)
    assert pt.StepRunner.graph_replays - replays == 23
    for a, b in zip(m_graph, m_eager):
        for k in ("loss", "acc1", "acc5"):
            assert torch.equal(a[k], b[k]), k
    assert len({float(m["loss"]) for m in m_graph}) == 24
    gaps = pretrain_gaps(start, graph, eager, m_graph, m_eager)
    assert all(v == 0 for v in gaps.values()), gaps


def test_graph_pool_is_shared_while_a_graph_holds_it(monkeypatch):
    """The graphs of one card share a memory pool while a graph holds it;
    once none does (the allocator would refuse it) the next capture gets a
    new pool, and another card a pool of its own."""
    tokens = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: ("pool", next(tokens)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(pt, "_graph_pools", {})

    class Graph:
        pass

    card = torch.device("cuda", 0)
    pool, holders = pt._graph_pool(card)
    graphs = [Graph(), Graph()]
    holders.update(graphs)
    assert pt._graph_pool(card) == (pool, holders)
    assert pt._graph_pool(torch.device("cuda", 1))[0] != pool
    graphs.pop()
    assert pt._graph_pool(card)[0] == pool
    graphs.pop()
    again, holders = pt._graph_pool(card)
    assert again != pool and not holders
