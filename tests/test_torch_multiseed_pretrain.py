"""The port's multi-seed pretraining (subspace_reg_tpu_torch/engine/
multiseed_pretrain.py and ``run_seeds --pretrain``) on the CPU.

* Each lane is bit-identical to the port's single-seed trainer
  (``train_supervised`` with the lane's ``--set_seed``), and a resumed
  fan-out to the uninterrupted one, through the CLI at its full width
  (resnet12, 16 px, synthetic continual miniImageNet cut to 1 training and
  1 validation image a base class through the loaders' per-class counts:
  60 images, 3 steps of 16 an epoch).
* The lanes against the JAX package's ``pretrain_multiseed`` (narrow
  resnet12, widths 8/16/24/32, f32, drop rate 0, batch 8 from splits cut
  to 8 rows, the JAX step's draws injected, the same initial weights):
  the state after one step at
  tests/test_torch_pretrain.py's f32 tolerances (loss rtol 1e-4, every
  parameter rtol 1e-4 with atol 1e-4 of the leaf's largest value, running
  statistics atol 1e-4, counters exact), and two epochs of train and
  validation metrics at loss rtol 1e-4 and accuracies within one image;
  the JAX engine's ``.ckpt`` of each lane read back by
  ``load_resume_states`` exactly.
* ``load_resume_states`` picks the highest epoch and refuses mixed epochs
  and checkpoints without an optimizer state; mismatched configurations
  are refused with the JAX engine's messages.
* CIFAR-FS continual as lazy rows equals a lane trained on the gathered
  split, and lanes spread over two devices (``shard_over_devices``) equal
  the unsharded run, bit for bit.
"""

import contextlib
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from subspace_reg_tpu.data.mini_imagenet import (
    load_mini_imagenet as jax_load_mini)
from subspace_reg_tpu.engine import multiseed_pretrain as jms
from subspace_reg_tpu.engine import pretrain as jpt
from subspace_reg_tpu.models.head import Head as JaxHead
from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet
from subspace_reg_tpu.utils.checkpoint import save_checkpoint as jax_save
from subspace_reg_tpu_torch import run_seeds, train_supervised
from subspace_reg_tpu_torch.data import cifar, mini_imagenet, synthetic
from subspace_reg_tpu_torch.engine import multiseed_pretrain as ms
from subspace_reg_tpu_torch.engine import pretrain as pt
from subspace_reg_tpu_torch.models.head import Head
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
from subspace_reg_tpu_torch.weights import from_jax_variables

from test_torch_pretrain import JaxPretrainDraws

WIDTHS = (8, 16, 24, 32)
SEEDS = (1, 2)
TRAIN_PER_CLASS, VAL_PER_CLASS = 3, 1


@contextlib.contextmanager
def cut_splits():
    """The CLIs' continual loaders at 1 training / 1 validation image a
    class (their 500/50 and 400/50 need hundreds a class)."""
    kw = dict(train_per_class=1, val_per_class=VAL_PER_CLASS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_supervised, "load_mini_imagenet", functools.partial(
            mini_imagenet.load_mini_imagenet, **kw))
        mp.setattr(train_supervised, "load_cifar_continual",
                   functools.partial(cifar.load_cifar_continual, **kw))
        yield


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ms_pretrain"))
    synthetic.make_mini_imagenet(os.path.join(root, "miniImageNet"),
                                 n_classes=100, per_class=6, img_size=16,
                                 seed=0)
    return root


def _flags(root, *extra):
    return ["--model", "resnet12", "--no_dropblock", "--no_linear_bias",
            "--classifier", "linear", "--continual", "--data_root", root,
            "--tb_path", os.path.join(root, "tb"), "--batch_size", "16",
            "--print_freq", "100", "--save_freq", "1", *extra]


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _ckpt(path):
    """Every leaf of a .ckpt: variables, head, optimizer state, step."""
    variables, head, meta = load_checkpoint(path)
    out = dict(_leaves(variables))
    out.update(_leaves(meta["extra"], "extra/"))
    out["head"] = np.asarray(head.weight)
    return out, meta


def _same_ckpt(a, b):
    la, ma = _ckpt(a)
    lb, mb = _ckpt(b)
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert ma["epoch"] == mb["epoch"]


@pytest.fixture(scope="module")
def fanout(root):
    """``run_seeds --pretrain --vmap`` 2 epochs, and ``--resume`` to 2
    from its epoch-1 checkpoints; the single-seed CLI for seed 1, 2
    epochs."""
    out = {}
    with cut_splits():
        common = ["--pretrain", "--vmap", "--seeds", *map(str, SEEDS),
                  "--device", "cpu", "--"]
        out["json"] = run_seeds.main(common + _flags(
            root, "--epochs", "2", "--model_path",
            os.path.join(root, "straight")))
        # the interrupted fan-out: each seed's epoch-1 checkpoint alone
        for seed in SEEDS:
            d = os.path.join(root, "resumed", f"seed_{seed}")
            os.makedirs(d)
            shutil.copy(os.path.join(root, "straight", f"seed_{seed}",
                                     "ckpt_epoch_1.ckpt"), d)
        out["resumed_json"] = run_seeds.main(
            ["--resume"] + common + _flags(
                root, "--epochs", "2", "--model_path",
                os.path.join(root, "resumed")))
        out["cli"] = train_supervised.main(_flags(
            root, "--epochs", "2", "--set_seed", "1", "--device", "cpu",
            "--model_path", os.path.join(root, "cli1")))
    return out


def test_lane_is_the_single_seed_trainer(root, fanout):
    """Seed 1's lane writes bit for bit the checkpoints of
    ``train_supervised --set_seed 1`` (weights, statistics, counters,
    head, momentum, step), at epoch 1 and at the end."""
    for name in ("ckpt_epoch_1.ckpt", "resnet12_last.ckpt"):
        _same_ckpt(os.path.join(root, "straight", "seed_1", name),
                   os.path.join(root, "cli1", name))
    assert fanout["cli"].step == 6


def test_resume_equals_the_uninterrupted_fanout(root, fanout):
    for seed in SEEDS:
        _same_ckpt(os.path.join(root, "straight", f"seed_{seed}",
                                "resnet12_last.ckpt"),
                   os.path.join(root, "resumed", f"seed_{seed}",
                                "resnet12_last.ckpt"))
    assert fanout["json"]["val_acc1"] == fanout["resumed_json"]["val_acc1"]


def test_vmap_layout_and_json(root, fanout, capsys):
    out = fanout["json"]
    assert out["seeds"] == list(SEEDS)
    assert sorted(out["val_acc1"]) == list(SEEDS)
    for seed in SEEDS:
        d = os.path.join(root, "straight", f"seed_{seed}")
        assert sorted(os.listdir(d)) == ["ckpt_epoch_1.ckpt",
                                         "ckpt_epoch_2.ckpt",
                                         "resnet12_last.ckpt", "tb"]
        _, meta = _ckpt(os.path.join(d, "resnet12_last.ckpt"))
        assert meta["epoch"] == 2 and int(meta["extra"]["step"]) == 6
        assert len(meta["training_classes"]) == 60
        with open(os.path.join(d, "tb", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert {(r["name"], r["step"]) for r in recs} >= {
            ("train_acc", 1), ("test_acc", 2), ("images_per_sec", 2)}
    # a nothing-to-do resume reports no validation and writes nothing
    with cut_splits():
        before = os.path.getmtime(os.path.join(
            root, "resumed", "seed_1", "resnet12_last.ckpt"))
        again = run_seeds.main(["--pretrain", "--vmap", "--resume",
                                "--seeds", "1", "2", "--device", "cpu",
                                "--"] + _flags(root, "--epochs", "2",
                                               "--model_path", os.path.join(
                                                   root, "resumed")))
    assert again["val_acc1"] == {}
    assert "==> nothing to do" in capsys.readouterr().out
    assert os.path.getmtime(os.path.join(
        root, "resumed", "seed_1", "resnet12_last.ckpt")) == before


def test_seed_groups_share_one_upload(root, fanout, tmp_path,
                                      monkeypatch):
    """``--seed_batch 1``: each seed trains in a group of its own, every
    group reads the one device store uploaded for the first (the fan-out's
    ``staged`` record, dropped when the fan-out returns), and each seed's
    checkpoint equals the 2-seed lockstep run's bit for bit."""
    from subspace_reg_tpu_torch.engine import multiseed_pretrain as msp
    uploads = []
    stage = msp.stage_shared

    def counting(full, device, staged=None):
        had = staged is not None and (id(full), str(device)) in staged
        out = stage(full, device, staged)
        if not had:
            uploads.append(out)
        return out

    monkeypatch.setattr(msp, "stage_shared", counting)
    with cut_splits():
        run_seeds.main(["--pretrain", "--vmap", "--seed_batch", "1",
                        "--seeds", *map(str, SEEDS), "--device", "cpu",
                        "--"] + _flags(root, "--epochs", "2",
                                       "--model_path", str(tmp_path)))
    assert len(uploads) == 1
    for seed in SEEDS:
        _same_ckpt(os.path.join(root, "straight", f"seed_{seed}",
                                "resnet12_last.ckpt"),
                   os.path.join(tmp_path, f"seed_{seed}",
                                "resnet12_last.ckpt"))


def test_sequential_pretrain_layout(root, tmp_path):
    """Without --vmap each seed runs the CLI into ``<model_path>/seed_<s>``;
    the JSON carries the seeds and no validation (as the JAX tool's)."""
    with cut_splits():
        out = run_seeds.main(["--pretrain", "--seeds", "1", "2",
                              "--device", "cpu", "--"] + _flags(
            root, "--epochs", "1", "--model_path", str(tmp_path)))
    assert out == {"seeds": [1, 2], "val_acc1": {}}
    for seed in SEEDS:
        assert os.path.exists(tmp_path / f"seed_{seed}" /
                              "resnet12_last.ckpt")
    _same_ckpt(str(tmp_path / "seed_1" / "resnet12_last.ckpt"),
               os.path.join(root, "cli1", "ckpt_epoch_1.ckpt"))


# ---------------------------------------------------------------------------
# the engine at narrow width
# ---------------------------------------------------------------------------
class Opt:
    model = "resnet12"
    dataset = "miniImageNet"
    transform = "A"
    continual = True
    use_trainval = False
    batch_size = 180
    epochs = 2
    learning_rate = 0.05
    lr_decay_rate = 0.1
    lr_decay_epochs_list = [60, 80]
    cosine = False
    adam = False
    weight_decay = 5e-4
    momentum = 0.9
    linear_bias = False
    no_dropblock = True
    label_pull = None
    distill = "none"
    faithful_nbt = False
    eval_only = False
    save_freq = 1

    def __init__(self, data_root, seed, **kw):
        self.data_root = data_root
        self.set_seed = seed
        self.__dict__.update(kw)


def _narrow(opt=None, drop_rate=0.0):
    return ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=drop_rate,
                     no_dropblock=True, avg_pool=True, widths=WIDTHS)


def _splits(load, opts, **kw):
    kw = dict(train_per_class=TRAIN_PER_CLASS, val_per_class=VAL_PER_CLASS,
              **kw)
    return ([load(o, split="train", phase="train", **kw) for o in opts],
            [load(o, split="train", phase="val", **kw) for o in opts])


def _port_state(state):
    out = dict(state.backbone.state_dict())
    out.update({f"head.{k}": v.detach() for k, v in state.head.items()})
    return out


def _jax_state(js):
    sd = from_jax_variables(jax.tree.map(np.asarray, {
        "params": js.params["backbone"], "batch_stats": js.batch_stats,
        "counters": js.counters}))
    sd["head.w"] = torch.from_numpy(np.array(js.params["head"]["w"]))
    return sd


def _first_rows(splits, n, lazy_rows, split_data):
    """Each split cut to its first ``n`` rows (a lazy view still)."""
    return [split_data(imgs=lazy_rows(s.imgs.full, s.imgs.sel[:n]),
                       labels=list(s.labels[:n]), cat2label=s.cat2label,
                       label2human=s.label2human, basec_map=s.basec_map)
            for s in splits]


def test_lanes_match_jax_pretrain_multiseed(root, tmp_path):
    """Two seeds, two epochs of one step (batch 8: the geometry of
    tests/test_torch_pretrain.py, where XLA's CPU convolutions hold f32
    accuracy), from the JAX engine's initial states, with the JAX step's
    draws."""
    from subspace_reg_tpu.data import mini_imagenet as jmini
    jroot = os.path.join(root, "miniImageNet")
    opts = [Opt(jroot, s, batch_size=8) for s in SEEDS]
    cut = functools.partial(_first_rows, n=8)
    jtr, jva = (cut(x, lazy_rows=jmini.LazyRows,
                    split_data=jmini.SplitData)
                for x in _splits(jax_load_mini, opts, lazy=True))
    tr, va = (cut(x, lazy_rows=mini_imagenet.LazyRows,
                  split_data=mini_imagenet.SplitData)
              for x in _splits(mini_imagenet.load_mini_imagenet, opts,
                               lazy=True))
    jbb = JaxResNet(n_blocks=(1, 1, 1, 1), drop_rate=0.0, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    tx = jms._make_tx(opts[0], 1)
    inits = [jpt.init_pretrain_state(jbb, jax.random.PRNGKey(s), 60, 16, tx,
                                     with_bias=False) for s in SEEDS]
    start = []
    for js in inits:
        variables = jax.tree.map(np.asarray, {
            "params": js.params["backbone"], "batch_stats": js.batch_stats,
            "counters": js.counters})
        start.append((variables, Head(weight=np.asarray(
            js.params["head"]["w"]), bias=None, n_active=60), {"epoch": 0}))

    after1 = {}

    def jax_save_fn(i, epoch, hs, final):
        if epoch != 1:
            return
        after1[("jax", i)] = hs
        variables = {"params": hs.params["backbone"],
                     "batch_stats": hs.batch_stats,
                     "counters": hs.counters}
        jax_save(str(tmp_path / f"seed_{SEEDS[i]}" /
                     f"ckpt_epoch_{epoch}.ckpt"), variables,
                 JaxHead(weight=hs.params["head"]["w"], bias=None,
                         n_active=np.int32(60)), {"epoch": epoch},
                 extra={"opt_state": hs.opt_state, "step": hs.step})

    def port_save_fn(i, epoch, state, final):
        if epoch == 1:
            after1[("port", i)] = {k: v.clone() for k, v in
                                   _port_state(state).items()}

    jres = jms.pretrain_multiseed(jbb, opts, jtr, jva, 60,
                                  save_fn=jax_save_fn, start_states=inits,
                                  verbose=False)
    res = ms.pretrain_multiseed(
        _narrow, opts, tr, va, 60, save_fn=port_save_fn,
        start_states=start, device="cpu", verbose=False,
        draws=[JaxPretrainDraws(s) for s in SEEDS])
    for i in range(len(SEEDS)):
        ref, got = _jax_state(after1[("jax", i)]), after1[("port", i)]
        for k, v in ref.items():
            if k.endswith("num_batches_tracked"):
                assert int(got[k]) == int(v) == 1, k
            elif "running" in k:
                np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                           rtol=0, atol=1e-4, err_msg=k)
            else:
                np.testing.assert_allclose(
                    got[k].numpy(), v.numpy(), rtol=1e-4,
                    atol=1e-4 * float(v.abs().max()), err_msg=k)
    for mj, mp in zip(jres.train_metrics + jres.val_metrics,
                      res.train_metrics + res.val_metrics):
        for dj, dp in zip(mj, mp):
            assert dp["loss"] == pytest.approx(dj["loss"], rel=1e-4)
            for k in ("acc1", "acc5"):
                assert abs(dp[k] - dj[k]) <= 100.0 / 8 + 1e-4, k
    # the JAX engine's checkpoints resume the port's lanes exactly
    paths = [[str(tmp_path / f"seed_{s}" / "ckpt_epoch_1.ckpt")]
             for s in SEEDS]
    per_seed, start_epoch = ms.load_resume_states(opts, 60, paths)
    assert start_epoch == 2
    lane = pt.init_pretrain_state(_narrow(), 60, pt.make_tx(opts[0]), False,
                                  device="cpu")
    pt.restore_pretrain_state(lane, *per_seed[0])
    assert lane.step == 1
    ref = _jax_state(after1[("jax", 0)])
    got = _port_state(lane)
    for k, v in ref.items():
        assert torch.equal(got[k], v.to(got[k].dtype).reshape(got[k].shape)), k


def _lane_run(opts, tr, va, **kw):
    res = ms.pretrain_multiseed(functools.partial(_narrow, drop_rate=0.1),
                                opts, tr, va, 60, device="cpu",
                                verbose=False, **kw)
    return res, [_port_state(s) for s in res.final_states]


def _all_equal(a, b):
    for sa, sb in zip(a, b):
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


def test_shard_over_devices_equals_unsharded(root):
    opts = [Opt(os.path.join(root, "miniImageNet"), s, batch_size=60,
                epochs=1) for s in (1, 2, 3, 4)]
    tr, va = _splits(mini_imagenet.load_mini_imagenet, opts, lazy=True)
    assert ms.lane_devices(4, ["cpu", "cpu", "cpu"], "cpu")[1] == [
        0, 0, 1, 1]
    res_a, a = _lane_run(opts, tr, va)
    res_b, b = _lane_run(opts, tr, va, shard_over_devices=["cpu", "cpu"])
    _all_equal(a, b)
    assert res_a.train_metrics == res_b.train_metrics
    assert res_a.val_metrics == res_b.val_metrics


def test_cifar_continual_lazy_rows(tmp_path):
    """CIFAR-FS continual through lazy rows of one staged store equals each
    seed trained alone on its gathered split."""
    croot = str(tmp_path / "CIFAR-FS")
    synthetic.make_cifar(croot, n_classes=100, per_class=6)
    opts = [Opt(croot, s, dataset="CIFAR-FS", transform="D", batch_size=90,
                epochs=1) for s in SEEDS]
    tr, va = _splits(cifar.load_cifar_continual, opts, lazy=True)
    assert tr[0].imgs.full is tr[1].imgs.full
    assert tr[0].imgs.shape[1:] == (32, 32, 3)
    _, lanes = _lane_run(opts, tr, va)
    for i, o in enumerate(opts):
        gtr, gva = _splits(cifar.load_cifar_continual, [o])
        _, alone = _lane_run([o], gtr, gva)
        _all_equal([lanes[i]], alone)


def test_load_resume_states_candidates(tmp_path):
    lane = pt.init_pretrain_state(_narrow(), 60, pt.make_tx(Opt("", 1)),
                                  False, device="cpu")
    variables, head, extra = pt.checkpoint_parts(lane)

    def write(name, epoch, with_extra=True):
        path = str(tmp_path / name)
        save_checkpoint(path, variables, head, {"epoch": epoch},
                        extra=extra if with_extra else None)
        return path
    a = [write("a_last.ckpt", 3), write("a_ckpt_epoch_5.ckpt", 5),
         write("a_ckpt_epoch_4.ckpt", 4)]
    b = write("b_ckpt_epoch_5.ckpt", 5)
    opts = [Opt("", 1), Opt("", 2)]
    per_seed, start = ms.load_resume_states(opts, 60, [a, b])
    assert start == 6 and per_seed[0][2]["epoch"] == 5
    with pytest.raises(ValueError, match="different epochs"):
        ms.load_resume_states(opts, 60, [a, write("c.ckpt", 4)])
    with pytest.raises(ValueError, match="no optimizer state"):
        ms.load_resume_states(opts, 60, [a, write("d.ckpt", 5, False)])


@pytest.mark.parametrize("field,value,match", [
    ("learning_rate", 0.1, "field 'learning_rate' differs"),
    ("label_pull", 1.0, "label_pull pretraining is single-seed only"),
    ("distill", "kd", "KD/NCE/CRD fan-out is single-seed only"),
    ("faithful_nbt", True, "--faithful_nbt"),
])
def test_mismatched_configurations_are_refused(root, field, value, match):
    opts = [Opt(os.path.join(root, "miniImageNet"), s) for s in SEEDS]
    setattr(opts[1] if field == "learning_rate" else opts[0], field, value)
    with pytest.raises(ValueError, match=match):
        ms.pretrain_multiseed(_narrow, opts, [None] * 2, [None] * 2, 60,
                              device="cpu")
    # the JAX engine refuses the same configurations
    with pytest.raises(AssertionError, match=match):
        jms._shared_fingerprint(opts)
