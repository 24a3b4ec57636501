"""The port's incremental engine against the JAX engine, end to end, on the
synthetic miniImageNet fixture of tests/test_engine_e2e.py (16 px, 20 images
a class, 30 epochs at most), 8 sessions.

The backbone is narrow, but its last stage is 80 wide: below the 60 base
classes the subspace projector I - QQ^T is zero and the pull would be
vacuous.  lr 0.01 and a convergence epsilon of 1e-2 make the stable-epoch
stop fire at different epochs in different sessions.

Both engines get the same backbone weights (through
``weights.from_jax_variables``), the same head, ``drop_rate=0`` and the same
random numbers: the port's draw provider here returns what ``jax.random``
draws on the JAX engine's own keys.  The JAX engine runs its XLA loop
(``pallas_mode="off"``), the port its plain K1 twin.  Epoch counts must be
identical; per-session novel and base accuracies and the weighted averages
agree within 0.5 points: the two run f32 convolutions and reductions in
different orders, so only a logit near-tie can move a prediction, and one
moved query already shifts a chunk by 5 points.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.data import synthetic
from subspace_reg_tpu.data.episodes import EpisodeSampler as JaxSampler
from subspace_reg_tpu.data.mini_imagenet import load_mini_imagenet as jax_load
from subspace_reg_tpu.engine.incremental import (
    few_shot_finetune_incremental_test as jax_engine)
from subspace_reg_tpu.models import head as jax_head
from subspace_reg_tpu.models.head import _torch_linear_init
from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet

from subspace_reg_tpu_torch.data.episodes import EpisodeSampler
from subspace_reg_tpu_torch.data.mini_imagenet import load_mini_imagenet
from subspace_reg_tpu_torch.engine.incremental import (
    few_shot_finetune_incremental_test)
from subspace_reg_tpu_torch.models.head import Head
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.ops.augment import AugmentDraws
from subspace_reg_tpu_torch.weights import from_jax_variables

WIDTHS = (8, 16, 24, 80)


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


class Opt:
    model = "resnet12"
    dataset = "miniImageNet"
    transform = "A"
    continual = True
    set_seed = 3
    n_ways = 5
    n_shots = 5
    n_queries = 4
    n_test_runs = 10
    eval_mode = "few-shot-incremental-fine-tune"
    n_aug_support_samples = 5
    n_base_aug_support_samples = 0
    n_base_support_samples = 1
    test_base_batch_size = 200
    neval_episodes = 8
    memory_replay = 1
    lmbd_reg_transform_w = 0.2
    lmbd_reg_novel = 0.1
    label_pull = 1.0
    pulling = "regularize"
    attraction_override = "distance2subspace"
    target_train_loss = 0.0
    stable_epochs = 3
    convergence_epsilon = 1e-2
    min_novel_epochs = 5
    max_novel_epochs = 30
    learning_rate = 0.01
    weight_decay = 5e-3
    momentum = 0.9
    adam = False
    freeze_backbone_at = 1
    no_dropblock = True
    use_episodes = False
    verbose = False
    word_embed_size = 500
    use_synonyms = False
    glove = False
    use_descriptions = False
    temperature = 1.0


_KEY_FNS = {}


def dropout_keys(jbb, img_size, key):
    """The keys that a train-mode forward of the JAX backbone ``jbb`` hands
    ``jax.random.bernoulli`` from the root ``key`` (dropout and DropBlock),
    in the order of its layers: a forward at ``img_size`` px records them
    (they depend on the module tree, not on the weights or the input).
    The recording forward is traced once per backbone and compiled."""
    entry = _KEY_FNS.get(id(jbb))
    if entry is None:
        x = jnp.zeros((1, img_size, img_size, 3))
        variables = jbb.init(jax.random.PRNGKey(0), x, train=False)

        def keys_of(variables, root):
            seen = []
            orig = jax.random.bernoulli

            def record(rng, p=0.5, shape=None, **kw):
                seen.append(rng)
                return orig(rng, p, shape, **kw)

            jax.random.bernoulli = record
            try:
                jbb.apply(variables, x, train=True,
                          mutable=["batch_stats", "counters"],
                          rngs={"dropout": root})
            finally:
                jax.random.bernoulli = orig
            return seen

        entry = _KEY_FNS[id(jbb)] = (jbb, variables, jax.jit(keys_of))
    _, variables, keys_of = entry
    return list(keys_of(variables, key))


class JaxDropout:
    """Uniforms for the port's dropout and DropBlock
    (models/layers.py::uniform) that reproduce the JAX engine's masks: the
    n-th call gets the uniforms of the n-th recorded key, the support
    forward's keys then the memory forward's (incremental.py:882-890).
    ``jax.random.bernoulli(key, p, shape)`` is ``uniform(key, shape) < p``
    in f32, and the port compares the same uniforms with its own p."""

    def __init__(self, keys):
        self.keys = list(keys)

    def __call__(self, shape, device):
        b, c, h, w = shape
        u = np.asarray(jax.random.uniform(self.keys.pop(0), (b, h, w, c),
                                          jnp.float32))
        return torch.from_numpy(np.ascontiguousarray(
            u.transpose(0, 3, 1, 2))).to(device)


class JaxDraws:
    """The port's draw provider returning the JAX engine's own draws:
    the same ``jax.random`` calls on the same keys as
    ops/augment.py::augment_batch and models/head.py::augment.  With the
    JAX backbone ``jbb`` (and its input size), also its dropout masks."""

    def __init__(self, set_seed, jbb=None, img_size=None):
        self.set_seed = set_seed
        self.jbb, self.img_size = jbb, img_size

    @staticmethod
    def _augment(seed, n, spec):
        kcrop, kflip, kjit = jax.random.split(jax.random.PRNGKey(seed), 3)
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

    def base_augment(self, n, spec):
        return self._augment(self.set_seed * 7919 + 17, n, spec)

    def support_augment(self, idx, n, spec):
        return self._augment(self.set_seed * 100003 + idx, n, spec)

    def head_growth(self, idx, n_rows, in_dim, with_bias):
        w, b = _torch_linear_init(
            jax.random.PRNGKey(self.set_seed * 61 + 1000 + idx), n_rows,
            in_dim, with_bias)
        return (torch.from_numpy(np.array(w)),
                None if b is None else torch.from_numpy(np.array(b)))

    def dropout(self, idx):
        if self.jbb is None:
            return None             # drop_rate = 0 on both sides
        k_sup, k_mem = jax.random.split(
            jax.random.PRNGKey(self.set_seed * 31 + idx))
        return JaxDropout(dropout_keys(self.jbb, self.img_size, k_sup)
                          + dropout_keys(self.jbb, self.img_size, k_mem))

    def dropout_full(self, idx):
        """The general-freeze epoch 1: k_sup's keys for the support and
        again for the memory forward (incremental.py:1025-1030)."""
        if self.jbb is None:
            return None, None
        k_sup, _ = jax.random.split(
            jax.random.PRNGKey(self.set_seed * 31 + idx))
        keys = dropout_keys(self.jbb, self.img_size, k_sup)
        return JaxDropout(keys), JaxDropout(keys)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mini_torch"))
    synthetic.make_mini_imagenet(root, n_classes=100, per_class=20,
                                 img_size=16, seed=0)
    synthetic.make_word_embeds(os.path.join(root, "word_embeds"))
    jbb = JaxResNet(n_blocks=(1, 1, 1, 1), drop_rate=0.0, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    variables = dict(jbb.init(jax.random.PRNGKey(1),
                              jnp.zeros((2, 16, 16, 3)), train=False))
    head0 = jax_head.init_head(jax.random.PRNGKey(2), 60, in_dim=WIDTHS[-1],
                               with_bias=False, max_classes=100)
    tbb = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.0, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    tbb.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)))
    thead = Head(weight=torch.from_numpy(np.array(head0.weight)),
                 bias=None, n_active=60)
    head0_b = jax_head.init_head(jax.random.PRNGKey(9), 60,
                                 in_dim=WIDTHS[-1], with_bias=True,
                                 max_classes=100)
    thead_b = Head(weight=torch.from_numpy(np.array(head0_b.weight)),
                   bias=torch.from_numpy(np.array(head0_b.bias)), n_active=60)
    return dict(root=root, jbb=jbb, variables=variables, tbb=tbb,
                heads={False: (head0, thead), True: (head0_b, thead_b)})


def _opt(root, **over):
    opt = Opt()
    opt.data_root = root
    opt.word_embed_path = os.path.join(root, "word_embeds")
    for k, v in over.items():
        setattr(opt, k, v)
    return opt


def _splits(load, opt):
    base_test = load(opt, split="train", phase="test", train_per_class=10,
                     val_per_class=2)
    base_train = load(opt, split="train", phase="train", train_per_class=10,
                      val_per_class=2)
    novel = load(opt, split="val")
    return base_test, base_train, novel


def _run_jax(env, opt, bias=False, meta=None):
    base_test, base_train, novel = _splits(jax_load, opt)
    return jax_engine(
        env["jbb"], env["variables"], env["heads"][bias][0], meta or {}, opt,
        meta_sampler=JaxSampler(novel, opt, split="val",
                                disjoint_classes=True),
        base_test_split=base_test,
        base_support_sampler=JaxSampler(base_train, opt, split="train",
                                        phase="train"),
        verbose=False, pallas_mode="off")


def _run_torch(env, opt, device="cpu", bias=False, meta=None, **kw):
    base_test, base_train, novel = _splits(load_mini_imagenet, opt)
    return few_shot_finetune_incremental_test(
        env["tbb"], env["heads"][bias][1], meta or {}, opt,
        meta_sampler=EpisodeSampler(novel, opt, split="val",
                                    disjoint_classes=True),
        base_test_split=base_test,
        base_support_sampler=EpisodeSampler(base_train, opt, split="train",
                                            phase="train"),
        device=device, draws=JaxDraws(opt.set_seed), **kw)


SUBSPACE = dict(label_pull=1.0, attraction_override="distance2subspace")
FINETUNE = dict(label_pull=None, attraction_override=None)
# the semantic subspace regularizer: --label_pull with the override unset
# pulls to softmax(E_novel E_base^T / T) W_base of the word embeddings
SEMANTIC = dict(label_pull=1.0, attraction_override=None)
# the linear label->image mapping on the 300-d GloVe slice
MAPPING = dict(label_pull=1.0,
               attraction_override="mapping_linear_label2image", glove=True)


def linear_map(out_dim, in_dim=300, seed=4):
    """A seeded LinearMap as a checkpoint's ``meta`` carries it."""
    r = np.random.RandomState(seed)
    return {"mapping_linear_label2image": {
        "weight": (0.05 * r.randn(out_dim, in_dim)).astype(np.float32),
        "bias": (0.01 * r.randn(out_dim)).astype(np.float32)}}


@pytest.mark.parametrize("over,bias", [
    (SUBSPACE, False),
    (FINETUNE, False),
    (dict(FINETUNE, adam=True), False),
    # a bias head: [W | b] layout in K1, squared bias anchor; the JAX
    # engine refuses the novel anchor with a bias (reference crash)
    (dict(SUBSPACE, lmbd_reg_novel=None), True),
    (SEMANTIC, False),
    (MAPPING, False),
], ids=["subspace_reg_memory", "finetune_memory", "adam_finetune_memory",
        "bias_head_subspace_reg_memory", "semantic_subspace_reg_memory",
        "mapping_memory"])
def test_eight_session_trace_matches_jax(env, over, bias):
    meta = (linear_map(WIDTHS[-1]) if over.get("attraction_override")
            == "mapping_linear_label2image" else None)
    ref = _run_jax(env, _opt(env["root"], **over), bias=bias, meta=meta)
    got = _run_torch(env, _opt(env["root"], **over), bias=bias, meta=meta,
                     verbose=False)
    assert got.epochs_per_session == ref.epochs_per_session
    assert len(got.acc_novel_list) == 8
    np.testing.assert_allclose(got.acc_novel_list, ref.acc_novel_list,
                               atol=0.5)
    np.testing.assert_allclose(got.acc_base_list, ref.acc_base_list,
                               atol=0.5)
    np.testing.assert_allclose(got.weighted_avg_l, ref.weighted_avg_l,
                               atol=0.5)
    for a, b in zip(got.novel_session_traces, ref.novel_session_traces):
        assert len(a) == len(b)


def test_reference_print_lines(env, capsys):
    opt = _opt(env["root"], verbose=True, min_novel_epochs=20,
               stable_epochs=50, max_novel_epochs=25)
    _run_torch(env, opt, verbose=True)
    out = capsys.readouterr().out
    assert out.count("Novel Epoch   10") == 8
    assert out.count("Novel Epoch   20") == 8
    for line in ("**** Iteration 8/8 ****", "Overall continual accuracies: ",
                 "Novel only incremental: ", "Base only incremental: ",
                 "Fine-tuning epochs:", "Runnning Base Avg:"):
        assert line in out


def test_unported_options_are_refused(env):
    """What stays refused, as in the JAX engine (incremental.py:1313-1317):
    the vis frames with freeze_backbone_at != 1."""
    with pytest.raises(NotImplementedError, match="vis frames"):
        _run_torch(env, _opt(env["root"], freeze_backbone_at=3),
                   verbose=False, vis=True)


def test_cuda_request_without_card_raises(env):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        _run_torch(env, _opt(env["root"]), verbose=False, device="cuda")


def test_eval_cli_wiring(tmp_path_factory, monkeypatch):
    """``python -m subspace_reg_tpu_torch.eval_incremental`` on the 8 px
    synthetic set of tests/test_cli.py: flags parsed as the JAX CLI parses
    them, a reference .pth loaded into a full-width resnet18, the head
    padded for 8 sessions, ``--device`` handed to the engine (stubbed)."""
    from subspace_reg_tpu_torch import eval_incremental as cli
    from subspace_reg_tpu_torch.models.factory import create_model

    root = str(tmp_path_factory.mktemp("mini_cli_torch"))
    # enough images per class for the reference's 500/50 continual split
    synthetic.make_mini_imagenet(os.path.join(root, "miniImageNet"),
                                 n_classes=100, per_class=560, img_size=8,
                                 seed=0)

    class O:
        no_dropblock = True
    torch.manual_seed(0)
    sd = create_model("resnet18", O()).state_dict()
    sd["classifier.weight"] = torch.randn(60, 640)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "resnet18_last.pth")
    torch.save({"model": sd, "training_classes": {i: i for i in range(60)},
                "label2human": [f"synthetic {i}" for i in range(100)]}, ckpt)

    captured = {}

    def fake_engine(backbone, head, meta, opt, **kw):
        captured.update(backbone=backbone, head=head, opt=opt, kw=kw)

        class R:
            acc_novel_avg, acc_base_avg, acc_average = 1.0, 2.0, 1.5
        return R()

    monkeypatch.setattr(cli, "few_shot_finetune_incremental_test",
                        fake_engine)
    res = cli.main([
        "--model_path", ckpt, "--model", "resnet18", "--no_dropblock",
        "--data_root", root, "--n_shots", "5", "--classifier", "linear",
        "--eval_mode", "few-shot-incremental-fine-tune", "--continual",
        "--n_queries", "4", "--test_base_batch_size", "100",
        "--set_seed", "5", "--memory_replay", "1",
        "--n_base_support_samples", "1", "--lmbd_reg_transform_w", "0.2",
        "--device", "cpu"])
    assert res.acc_average == 1.5
    head = captured["head"]
    assert head.n_active == 60 and head.weight.shape == (100, 640)
    assert torch.equal(head.weight[:60], sd["classifier.weight"])
    assert captured["opt"].linear_bias is False
    assert captured["kw"]["device"] == "cpu"
    assert captured["kw"]["base_support_sampler"] is not None
    loaded = captured["backbone"].state_dict()
    assert torch.equal(loaded["layer4.1.conv3.weight"],
                       sd["layer4.1.conv3.weight"])
