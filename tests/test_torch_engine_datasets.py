"""The port's incremental engine on tieredImageNet and CIFAR-FS continual
against the JAX engine, 8 sessions, with the JAX draws injected, as
tests/test_torch_engine.py holds them on miniImageNet: epoch counts exact,
per-session novel and base accuracies and the weighted averages within 0.5
(one moved query shifts a chunk by 5 points).  Tiered's weighted average
takes its base weight of 200 (reference language_eval.py:383), CIFAR's 60.

Fixtures, cut to the CPU: synthetic tieredImageNet at 16 px with 80
train_a classes (the head's base) and 40 class-disjoint ``val`` classes
for the 8 sessions of 5, 10 images a class; synthetic CIFAR-100 at 32 px,
20 images a class, its continual split at 10/2 images a base class.  The
backbones are narrow, their last stage wider than the base classes (96
over tiered's 80, 80 over CIFAR's 60), so the subspace pull is not
vacuous.  Also: the multi-seed engine on tiered against single-seed runs
(epochs exact, accuracies within 0.02, as tests/test_torch_multiseed.py),
and the eval CLI on tieredImageNet reading a JAX-written ``.ckpt`` into a
full-width resnet18 (engine stubbed)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.data import synthetic
from subspace_reg_tpu.data.cifar import load_cifar_continual as jax_cifar
from subspace_reg_tpu.data.episodes import EpisodeSampler as JaxSampler
from subspace_reg_tpu.data.tiered_imagenet import (
    load_tiered_imagenet as jax_tiered)
from subspace_reg_tpu.engine.incremental import (
    few_shot_finetune_incremental_test as jax_engine)
from subspace_reg_tpu.models import head as jax_head
from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet
from subspace_reg_tpu.models.resnet import resnet18 as jax_resnet18
from subspace_reg_tpu.utils import checkpoint as jckpt

from subspace_reg_tpu_torch.data.cifar import load_cifar_continual
from subspace_reg_tpu_torch.data.episodes import EpisodeSampler
from subspace_reg_tpu_torch.data.tiered_imagenet import load_tiered_imagenet
from subspace_reg_tpu_torch.engine.incremental import (
    few_shot_finetune_incremental_test)
from subspace_reg_tpu_torch.engine.multiseed import (
    few_shot_finetune_multiseed)
from subspace_reg_tpu_torch.models.head import Head
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.weights import from_jax_variables

from test_torch_engine import JaxDraws, Opt

# dataset: (last width, base classes, image size, transform)
SETS = {"tieredImageNet": (96, 80, 16, "A"),
        "CIFAR-FS": (80, 60, 32, "D")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in this module, as in tests/test_torch_engine.py:
    the tier-1 lane runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sets_torch"))
    synthetic.make_tiered(os.path.join(root, "tieredImageNet"), n_classes=80,
                          per_class=10, img_size=16, with_train_b=False)
    synthetic.make_cifar(os.path.join(root, "CIFAR-FS"), n_classes=100,
                         per_class=20)
    out = {"root": root}
    for i, (name, (width, n_base, img, _)) in enumerate(SETS.items()):
        kw = dict(n_blocks=(1, 1, 1, 1), drop_rate=0.0, no_dropblock=True,
                  avg_pool=True, widths=(8, 16, 24, width))
        jbb = JaxResNet(**kw)
        variables = dict(jbb.init(jax.random.PRNGKey(1 + i),
                                  jnp.zeros((2, img, img, 3)), train=False))
        head0 = jax_head.init_head(jax.random.PRNGKey(2 + i), n_base,
                                   in_dim=width, with_bias=False,
                                   max_classes=n_base + 40)
        tbb = ResNetRFS(**kw)
        tbb.load_state_dict(from_jax_variables(
            jax.tree_util.tree_map(np.asarray, variables)))
        thead = Head(weight=torch.from_numpy(np.array(head0.weight)),
                     bias=None, n_active=n_base)
        out[name] = dict(jbb=jbb, variables=variables, head0=head0, tbb=tbb,
                         thead=thead)
    return out


def _opt(env, dataset, seed=3):
    opt = Opt()
    opt.dataset = dataset
    opt.transform = SETS[dataset][3]
    opt.data_root = os.path.join(env["root"], dataset)
    opt.set_seed = seed
    return opt


def _splits(dataset, tiered_load, cifar_load, opt):
    if dataset == "tieredImageNet":
        return (tiered_load(opt, "train", "test"),
                tiered_load(opt, "train", "train"),
                tiered_load(opt, "val", pretrain=False))
    kw = dict(train_per_class=10, val_per_class=2)
    return (cifar_load(opt, "train", "test", **kw),
            cifar_load(opt, "train", "train", **kw),
            cifar_load(opt, "val", **kw))


def _inputs(dataset, opt, port=True):
    sampler = EpisodeSampler if port else JaxSampler
    base_test, base_train, novel = _splits(
        dataset, load_tiered_imagenet if port else jax_tiered,
        load_cifar_continual if port else jax_cifar, opt)
    return dict(meta_sampler=sampler(novel, opt, split="val",
                                     disjoint_classes=True),
                base_test_split=base_test,
                base_support_sampler=sampler(base_train, opt, split="train",
                                             phase="train"))


@pytest.mark.parametrize("dataset", sorted(SETS))
def test_eight_session_trace_matches_jax(env, dataset):
    e = env[dataset]
    opt = _opt(env, dataset)
    ref = jax_engine(e["jbb"], e["variables"], e["head0"], {}, opt,
                     **_inputs(dataset, opt, port=False), verbose=False,
                     pallas_mode="off")
    opt = _opt(env, dataset)
    got = few_shot_finetune_incremental_test(
        e["tbb"], e["thead"], {}, opt, **_inputs(dataset, opt),
        verbose=False, device="cpu", draws=JaxDraws(opt.set_seed))
    assert len(got.acc_novel_list) == 8
    assert got.epochs_per_session == ref.epochs_per_session
    for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   atol=0.5, err_msg=name)
    # the weighted average of a session (language_eval.py:383-385): base
    # weight 200 on tiered, 60 on CIFAR; novel weight the classes seen less
    # 60 (the reference's constant, whatever the base count), rounded to
    # two places
    w1 = 200 if dataset == "tieredImageNet" else 60
    n_base = SETS[dataset][1]
    for i, (nv, bs) in enumerate(zip(got.acc_novel_list,
                                     got.acc_base_list)):
        w2 = n_base + 5 * (i + 1) - 60
        assert got.weighted_avg_l[i + 1] == round(
            (w1 * bs + w2 * nv) / (w1 + w2), 2)


def test_multiseed_on_tiered_matches_single_seed_runs(env):
    e = env["tieredImageNet"]
    seeds = (3, 7)
    opts = [_opt(env, "tieredImageNet", s) for s in seeds]
    ins = [_inputs("tieredImageNet", o) for o in opts]
    ms = few_shot_finetune_multiseed(
        [e["tbb"]] * 2, [e["thead"]] * 2, [{}, {}], opts,
        [i["meta_sampler"] for i in ins], [i["base_test_split"] for i in ins],
        [i["base_support_sampler"] for i in ins], device="cpu")
    for seed, got in zip(seeds, ms.per_seed):
        opt = _opt(env, "tieredImageNet", seed)
        want = few_shot_finetune_incremental_test(
            e["tbb"], e["thead"], {}, opt, **_inputs("tieredImageNet", opt),
            verbose=False, device="cpu")
        assert got.epochs_per_session == want.epochs_per_session
        # the weighted averages differ by design: the multi-seed engine
        # weighs the novel accuracy as the JAX multi-seed engine does
        # (test_multiseed_weighted_average_on_tiered)
        for name in ("acc_novel_list", "acc_base_list"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), atol=0.02)
    assert ms.per_seed[0].acc_novel_list != ms.per_seed[1].acc_novel_list


def test_multiseed_weighted_average_on_tiered(env):
    """The multi-seed engine's weighted average on tieredImageNet: base
    weight 200, novel weight the classes added so far, 5(k+1), as the JAX
    multi-seed engine computes it (multiseed.py:477-480;
    tests/test_multiseed.py:172-179), not the single-seed engine's
    classes seen less 60."""
    e = env["tieredImageNet"]
    sessions = 3
    opt = _opt(env, "tieredImageNet", 5)
    opt.neval_episodes = sessions
    rows = SETS["tieredImageNet"][1] + 5 * sessions
    head = Head(weight=e["thead"].weight[:rows], bias=None,
                n_active=e["thead"].n_active)
    ins = _inputs("tieredImageNet", opt)
    res = few_shot_finetune_multiseed(
        [e["tbb"]], [head], [{}], [opt], [ins["meta_sampler"]],
        [ins["base_test_split"]], [ins["base_support_sampler"]],
        device="cpu").per_seed[0]
    assert len(res.acc_novel_list) == sessions
    for k, (nv, bs) in enumerate(zip(res.acc_novel_list,
                                     res.acc_base_list)):
        w2 = 5 * (k + 1)
        assert res.weighted_avg_l[k + 1] == round(
            (200 * bs + w2 * nv) / (200 + w2), 2)


def test_eval_cli_reads_a_jax_ckpt_on_tiered(env, tmp_path, monkeypatch):
    """``python -m subspace_reg_tpu_torch.eval_incremental --dataset
    tieredImageNet`` on a ``.ckpt`` written by the JAX package's
    save_checkpoint (full-width resnet18, a 351-class head): the base
    count, the head padded to 351 + 8 x 5 rows, the backbone's weights and
    counters, the transform."""
    from subspace_reg_tpu_torch import eval_incremental as cli
    root = str(tmp_path / "data")
    synthetic.make_tiered(os.path.join(root, "tieredImageNet"),
                          n_classes=80, per_class=10, img_size=8,
                          with_train_b=False)
    jbb = jax_resnet18(avg_pool=True, drop_rate=0.1, no_dropblock=True)
    variables = jax.tree_util.tree_map(np.asarray, dict(jbb.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)), train=False)))
    w = np.random.RandomState(1).randn(351, 640).astype(np.float32)
    path = str(tmp_path / "resnet18_last.ckpt")
    jckpt.save_checkpoint(path, variables,
                          jax_head.Head(weight=w, bias=None, n_active=351),
                          {"epoch": 100})
    captured = {}

    def fake_engine(backbone, head, meta, opt, **kw):
        captured.update(backbone=backbone, head=head, meta=meta, opt=opt)

        class R:
            acc_novel_avg, acc_base_avg, acc_average = 1.0, 2.0, 1.5
        return R()

    monkeypatch.setattr(cli, "few_shot_finetune_incremental_test",
                        fake_engine)
    cli.main(["--model_path", path, "--model", "resnet18", "--no_dropblock",
              "--dataset", "tieredImageNet", "--data_root", root,
              "--n_shots", "5", "--classifier", "linear", "--eval_mode",
              "few-shot-incremental-fine-tune", "--continual",
              "--n_queries", "4", "--n_base_support_samples", "1",
              "--device", "cpu"])
    head, opt = captured["head"], captured["opt"]
    # 40 val classes: 8 sessions of 5
    assert opt.neval_episodes == 8 and opt.transform == "A"
    assert head.n_active == 351 and tuple(head.weight.shape) == (391, 640)
    np.testing.assert_array_equal(head.weight[:351].numpy(), w)
    assert not head.weight[351:].any() and head.bias is None
    assert captured["meta"]["epoch"] == 100
    assert opt.linear_bias is False
    sd = captured["backbone"].state_dict()
    want = from_jax_variables(variables)
    assert torch.equal(sd["layer4.1.conv3.weight"],
                       want["layer4.1.conv3.weight"])
    assert torch.equal(sd["layer1.0.num_batches_tracked"],
                       want["layer1.0.num_batches_tracked"].reshape(()))
