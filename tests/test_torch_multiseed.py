"""The port's multi-seed engine (subspace_reg_tpu_torch/engine/multiseed.py)
on the synthetic miniImageNet fixture of tests/test_multiseed.py (16 px, 20
images a class), S = 2 seeds with their own backbone weights, the golden
subspace-reg + memory flags at 30 epochs at most, 8 sessions:

  * against the port's single-seed engine per seed (both with the port's
    own draws): epochs exact, accuracies within 0.02, as the JAX package's
    own test holds its vmapped engine (tests/test_multiseed.py:116-123);
  * against the JAX single-seed engine per seed, with the JAX draws
    injected (dropout masks included): epochs exact, accuracies within
    0.5, as tests/test_torch_engine.py holds the single-seed engines;
  * ``python -m subspace_reg_tpu_torch.run_seeds`` with the engine
    stubbed: seed groups, the confidence interval, the refusals;
  * ``shard_over_devices=True`` on one device bit-identical to the
    unsharded run, and the seed layout (``parallel.mesh.lane_devices``)
    against a JAX ``NamedSharding`` of the seed axis under JAX's rule.

The backbone's last stage is 80 wide (above the 60 base classes, so the
subspace pull is not vacuous) and keeps the golden drop rate 0.1.  On the
CPU the seed-batched K1 runs its plain loops.  The direct comparison with
the JAX vmapped engine is marked slow, as the JAX test is."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from subspace_reg_tpu.data import synthetic
from subspace_reg_tpu.data.episodes import EpisodeSampler as JaxSampler
from subspace_reg_tpu.data.mini_imagenet import load_mini_imagenet as jax_load
from subspace_reg_tpu.engine.incremental import (
    few_shot_finetune_incremental_test as jax_engine)
from subspace_reg_tpu.models import head as jax_head
from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet

from subspace_reg_tpu_torch import run_seeds
from subspace_reg_tpu_torch.data.episodes import EpisodeSampler
from subspace_reg_tpu_torch.data.mini_imagenet import load_mini_imagenet
from subspace_reg_tpu_torch.engine.incremental import (
    IncrementalResult, few_shot_finetune_incremental_test)
from subspace_reg_tpu_torch.engine.multiseed import (
    few_shot_finetune_multiseed)
from subspace_reg_tpu_torch.models.head import Head
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.ops.finetune import finetune_loop
from subspace_reg_tpu_torch.weights import from_jax_variables

from test_torch_engine import JaxDraws, Opt

WIDTHS = (8, 16, 24, 80)
SEEDS = (3, 6)
DROP = 0.1


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


def _backbone_kw():
    return dict(n_blocks=(1, 1, 1, 1), drop_rate=DROP, no_dropblock=True,
                avg_pool=True, widths=WIDTHS)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini_ms_torch"))
    synthetic.make_mini_imagenet(root, n_classes=100, per_class=20,
                                 img_size=16, seed=0)
    jbb = JaxResNet(**_backbone_kw())
    seeds = {}
    for i, seed in enumerate(SEEDS):
        variables = jax.tree_util.tree_map(np.asarray, dict(jbb.init(
            jax.random.PRNGKey(100 + i), jnp.zeros((2, 16, 16, 3)),
            train=False)))
        jhead = jax_head.init_head(jax.random.PRNGKey(150 + i), 60,
                                   in_dim=WIDTHS[-1], with_bias=False,
                                   max_classes=100)
        tbb = ResNetRFS(**_backbone_kw())
        tbb.load_state_dict(from_jax_variables(variables))
        thead = Head(weight=torch.from_numpy(np.array(jhead.weight)),
                     bias=None, n_active=60)
        seeds[seed] = dict(variables=variables, jhead=jhead, tbb=tbb,
                           thead=thead)
    return dict(root=root, jbb=jbb, seeds=seeds)


def _opt(root, seed):
    opt = Opt()
    opt.data_root = root
    opt.set_seed = seed
    return opt


def _inputs(load, sampler, opt):
    base_test = load(opt, split="train", phase="test", train_per_class=10,
                     val_per_class=2)
    base_train = load(opt, split="train", phase="train", train_per_class=10,
                      val_per_class=2)
    novel = load(opt, split="val")
    return dict(base_test=base_test,
                meta=sampler(novel, opt, split="val", disjoint_classes=True),
                support=sampler(base_train, opt, split="train",
                                phase="train"))


def _multi(env, draws=None, shard_over_devices=False):
    opts = [_opt(env["root"], s) for s in SEEDS]
    ins = [_inputs(load_mini_imagenet, EpisodeSampler, o) for o in opts]
    return few_shot_finetune_multiseed(
        [env["seeds"][s]["tbb"] for s in SEEDS],
        [env["seeds"][s]["thead"] for s in SEEDS], [{} for _ in SEEDS],
        opts, [i["meta"] for i in ins], [i["base_test"] for i in ins],
        [i["support"] for i in ins], device="cpu", draws=draws,
        shard_over_devices=shard_over_devices)


def _single(env, seed, draws=None):
    opt = _opt(env["root"], seed)
    i = _inputs(load_mini_imagenet, EpisodeSampler, opt)
    return few_shot_finetune_incremental_test(
        env["seeds"][seed]["tbb"], env["seeds"][seed]["thead"], {}, opt,
        meta_sampler=i["meta"], base_test_split=i["base_test"],
        base_support_sampler=i["support"], verbose=False, device="cpu",
        draws=draws)


def _jax_single(env, seed):
    opt = _opt(env["root"], seed)
    i = _inputs(jax_load, JaxSampler, opt)
    return jax_engine(
        env["jbb"], env["seeds"][seed]["variables"],
        env["seeds"][seed]["jhead"], {}, opt, meta_sampler=i["meta"],
        base_test_split=i["base_test"], base_support_sampler=i["support"],
        verbose=False, pallas_mode="off")


def _jax_draws(env):
    return [JaxDraws(s, env["jbb"], 16) for s in SEEDS]


@pytest.fixture(scope="module")
def multi_jax_draws(env):
    return _multi(env, draws=_jax_draws(env))


@pytest.fixture(scope="module")
def multi_plain(env):
    """The unsharded run with the port's draws, and the K1 launches it
    counted."""
    before = finetune_loop.launches
    ms = _multi(env)
    return ms, finetune_loop.launches - before


def test_multiseed_matches_single_seed_runs(env, multi_plain):
    ms, launched = multi_plain
    assert launched == 0    # CPU: the plain loops
    assert ms.seeds == list(SEEDS)
    for seed, got in zip(SEEDS, ms.per_seed):
        want = _single(env, seed)
        assert got.epochs_per_session == want.epochs_per_session
        for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), atol=0.02)
    # the seeds differ: their own weights, episodes and draws
    assert ms.per_seed[0].acc_novel_list != ms.per_seed[1].acc_novel_list


def test_multiseed_matches_the_jax_engine_per_seed(env, multi_jax_draws):
    epochs = []
    for seed, got in zip(SEEDS, multi_jax_draws.per_seed):
        ref = _jax_single(env, seed)
        assert got.epochs_per_session == ref.epochs_per_session
        for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(ref, name), atol=0.5)
        epochs.append(got.epochs_per_session)
    # the stop rule fires at other epochs in other sessions and seeds
    assert len({e for run in epochs for e in run}) > 1


@pytest.mark.slow
def test_multiseed_matches_the_jax_multiseed_engine(env, multi_jax_draws):
    from subspace_reg_tpu.engine.multiseed import (
        few_shot_finetune_multiseed as jax_multiseed)
    opts = [_opt(env["root"], s) for s in SEEDS]
    ins = [_inputs(jax_load, JaxSampler, o) for o in opts]
    ref = jax_multiseed(
        env["jbb"], [env["seeds"][s]["variables"] for s in SEEDS],
        [env["seeds"][s]["jhead"] for s in SEEDS], [{} for _ in SEEDS],
        opts, [i["meta"] for i in ins], [i["base_test"] for i in ins],
        [i["support"] for i in ins], pallas_mode="off")
    for got, want in zip(multi_jax_draws.per_seed, ref.per_seed):
        assert got.epochs_per_session == want.epochs_per_session
        for name in ("acc_novel_list", "acc_base_list", "weighted_avg_l"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), atol=0.5)


def test_multiseed_refusals(env):
    opts = [_opt(env["root"], s) for s in SEEDS]
    bbs = [env["seeds"][s]["tbb"] for s in SEEDS]
    heads = [env["seeds"][s]["thead"] for s in SEEDS]
    args = (bbs, heads, [{}, {}], opts, [None, None], [None, None])
    opts[1].learning_rate = 0.5
    for shard in (False, True):
        with pytest.raises(ValueError, match="learning_rate"):
            few_shot_finetune_multiseed(*args, device="cpu",
                                        shard_over_devices=shard)
    # what the JAX multi-seed engine does not serve either: the tracked
    # modes and the general freeze
    for over, match in ((dict(track_weights=True), "track_weights"),
                        (dict(track_label_inspired_weights=True),
                         "track_label_inspired_weights"),
                        (dict(freeze_backbone_at=3), "freeze_backbone_at")):
        opts = [_opt(env["root"], s) for s in SEEDS]
        for o in opts:
            for k, v in over.items():
                setattr(o, k, v)
        with pytest.raises(NotImplementedError, match=match):
            few_shot_finetune_multiseed(bbs, heads, [{}, {}], opts,
                                        [None] * 2, [None] * 2,
                                        device="cpu")


RESULT_FIELDS = ("acc_novel_avg", "acc_base_avg", "weighted_avg_l",
                 "acc_novel_list", "acc_base_list", "novel_session_traces",
                 "epochs_per_session")


def test_shard_over_devices_on_one_device_is_the_unsharded_run(
        env, multi_plain):
    """JAX lays the seeds over the largest divisor of S that fits the
    visible devices: on the CPU (one device) that is one, and the sharded
    run is the unsharded one, bit for bit."""
    got = _multi(env, shard_over_devices=True)
    assert got.seeds == multi_plain[0].seeds
    for a, b in zip(got.per_seed, multi_plain[0].per_seed):
        for name in RESULT_FIELDS:
            assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("n_dev", range(1, 9))
def test_seed_layout_matches_jax(n_dev):
    """``lane_devices`` against the JAX engine's layout of the seed axis
    (engine/multiseed.py:74-86): over the largest divisor of S that fits
    ``n_dev`` devices, the seeds that a ``NamedSharding(Mesh(devices,
    ("seed",)), P("seed"))`` places on each device, for S = 1..10."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from subspace_reg_tpu_torch.parallel.mesh import lane_devices
    assert jax.device_count() >= n_dev
    for s in range(1, 11):
        n_used = max(d for d in range(1, n_dev + 1) if s % d == 0)
        mesh = Mesh(np.asarray(jax.devices()[:n_used]), ("seed",))
        arr = jax.device_put(jnp.arange(s), NamedSharding(mesh, P("seed")))
        where = {d: i for i, d in enumerate(mesh.devices.tolist())}
        want = [None] * s
        for shard in arr.addressable_shards:
            for seed in np.asarray(shard.data).tolist():
                want[seed] = where[shard.device]
        devs, slot = lane_devices(s, [f"cpu:{i}" for i in range(n_dev)],
                                  "cpu")
        assert len(devs) == n_used and slot == want, (s, n_dev)
    # True lays the seeds over the visible devices: the CPU is one
    assert lane_devices(6, True, "cpu") == ([torch.device("cpu")], [0] * 6)


def _fake_result(seed):
    return IncrementalResult(
        acc_novel_avg=50.0 + seed, acc_base_avg=60.0 + 2 * seed,
        weighted_avg_l=[70.0 + seed], acc_novel_list=[50.0 + seed],
        acc_base_list=[60.0 + 2 * seed], novel_session_traces=[[50.0]],
        epochs_per_session=[seed])


def test_run_seeds_groups_and_aggregates(monkeypatch, capsys):
    """``--vmap --seed_batch 2`` runs seeds 1..5 as groups [1, 2], [3, 4],
    [5] through the multi-seed engine; without ``--vmap`` one engine call
    a seed; both print the mean and the 95% CI of the seeds."""
    from subspace_reg_tpu.utils.artifacts import mean_confidence_interval
    groups, singles = [], []

    def fake_vmapped(args, rest, seeds, draws=None):
        groups.append(list(seeds))
        assert rest == ["--model", "resnet18"]
        assert args.device == "cpu"
        return [_fake_result(s) for s in seeds]

    def fake_one(args, rest, seed, draws=None):
        singles.append(seed)
        return _fake_result(seed)

    monkeypatch.setattr(run_seeds, "_run_vmapped", fake_vmapped)
    monkeypatch.setattr(run_seeds, "_run_one", fake_one)
    argv = ["--seeds", "1", "2", "3", "4", "5", "--device", "cpu"]
    out = run_seeds.main(argv + ["--vmap", "--seed_batch", "2", "--",
                                 "--model", "resnet18"])
    assert groups == [[1, 2], [3, 4], [5]] and singles == []
    m, h = mean_confidence_interval([51.0, 52.0, 53.0, 54.0, 55.0])
    assert out["novel"]["mean"] == pytest.approx(m)
    assert out["novel"]["ci95"] == pytest.approx(h)
    assert out["base"]["mean"] == pytest.approx(66.0)
    assert out["epochs"] == [[1], [2], [3], [4], [5]]
    assert '"ci95"' in capsys.readouterr().out
    out1 = run_seeds.main(argv + ["--", "--model", "resnet18"])
    assert singles == [1, 2, 3, 4, 5] and len(groups) == 3
    assert out1["novel"] == out["novel"]
    one = run_seeds.main(["--seeds", "7", "--device", "cpu"])
    assert one["novel"] == {"mean": 57.0}


def test_run_seeds_argv_per_seed():
    args, rest = run_seeds.parse_args(
        ["--model_path_pattern", "/ck/s{seed}/m.pth", "--", "--model", "x"])
    assert args.seeds == list(range(1, 11)) and args.device == "cuda"
    assert run_seeds._seed_argv(args, rest, 4) == [
        "--model", "x", "--set_seed", "4", "--model_path", "/ck/s4/m.pth"]


@pytest.mark.parametrize("flags,error,match", [
    # sequential pretraining needs a folder a seed
    (["--pretrain"], SystemExit, "--model_path"),
    (["--shard_seeds"], ValueError, "--pretrain --vmap"),
    (["--resume"], ValueError, "--pretrain --vmap"),
    (["--pallas", "off"], ValueError, "hand-written"),
    (["--pallas", "interpret"], ValueError, "hand-written"),
])
def test_run_seeds_refusals(flags, error, match):
    with pytest.raises(error, match=match):
        run_seeds.main(flags + ["--seeds", "1"])


def test_run_seeds_plain_pallas_flag_is_fine_on_the_cpu(monkeypatch):
    monkeypatch.setattr(run_seeds, "_run_one",
                        lambda args, rest, seed, draws=None:
                        _fake_result(seed))
    out = run_seeds.main(["--pallas", "off", "--device", "cpu", "--seeds",
                          "2"])
    assert out["novel"]["mean"] == 52.0
