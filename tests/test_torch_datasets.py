"""The port's CIFAR-FS/FC100 and tieredImageNet data layer against the JAX
package's, on the CPU, on the JAX synthetic fixtures:

* the loaders return the JAX loaders' image bytes, labels, ``label2human``
  and ``basec_map``: CIFAR partitions with sparse labels, CIFAR continual
  (eager and lazy), tiered with and without ``train_b`` pooled;
* ``load_eval_splits`` per dataset: the splits, ``n_cls``, the transform
  mutation (CIFAR -> D) and the class-budget clamp;
* the port's generators write the JAX generators' bytes (pickles byte for
  byte; npz archives, whose zip headers carry a time stamp, array for
  array);
* the 32 px backbone (``dropblock_size=2`` for CIFAR) matches the JAX
  backbone's train-mode forward with the JAX DropBlock masks (atol 1e-4,
  as tests/test_torch_backbone.py holds the f32 forwards).  Exact checks
  otherwise."""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from subspace_reg_tpu.data import cifar as jcifar
from subspace_reg_tpu.data import eval_splits as jsplits
from subspace_reg_tpu.data import synthetic as jsyn
from subspace_reg_tpu.data import tiered_imagenet as jtiered
from subspace_reg_tpu.models.factory import create_model as jax_create
from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet
from subspace_reg_tpu_torch.data import cifar, eval_splits, synthetic
from subspace_reg_tpu_torch.data import tiered_imagenet as tiered
from subspace_reg_tpu_torch.models.factory import create_model
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.weights import from_jax_variables
from torch_support import write_continual_mini

from test_torch_engine import JaxDropout, dropout_keys


class Opt:
    set_seed = 4
    continual = True
    use_trainval = False
    n_ways = 5
    neval_episodes = 2000
    n_base_support_samples = 1
    transform = "A"
    augment_pretrain_wtrainb = False
    no_dropblock = False

    def __init__(self, data_root, **kw):
        self.data_root = data_root
        for k, v in kw.items():
            setattr(self, k, v)


def _same_split(a, b):
    np.testing.assert_array_equal(np.asarray(a.imgs), np.asarray(b.imgs))
    assert list(a.labels) == list(b.labels)
    assert list(a.label2human) == list(b.label2human)
    assert a.basec_map == b.basec_map
    assert dict(a.cat2label) == dict(b.cat2label)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    jsyn.make_cifar(os.path.join(root, "cifar_sparse"), n_classes=12,
                    per_class=6, sparse_labels=True)
    jsyn.make_cifar(os.path.join(root, "cifar"), n_classes=100, per_class=8)
    jsyn.make_tiered(os.path.join(root, "tiered"), n_classes=20,
                     per_class=6, img_size=8)
    # the continual splits' 500/50 (mini) and 400/50 (CIFAR) images a base
    # class, at 4 px
    write_continual_mini(os.path.join(root, "continual"), per_class=551,
                         img=4)
    return root


@pytest.mark.parametrize("partition", ["train", "val", "test"])
def test_cifar_partitions_remap_sparse_labels(roots, partition):
    opt = Opt(os.path.join(roots, "cifar_sparse"))
    got = cifar.load_cifar(opt, partition)
    _same_split(got, jcifar.load_cifar(opt, partition))
    assert sorted(set(got.labels)) == list(range(4))


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("split,phase", [("train", "train"),
                                         ("train", "val"),
                                         ("train", "test"), ("val", None)])
def test_cifar_continual_matches_jax(roots, split, phase, lazy):
    opt = Opt(os.path.join(roots, "cifar"))
    kw = dict(train_per_class=4, val_per_class=2, lazy=lazy)
    got = cifar.load_cifar_continual(opt, split, phase, **kw)
    _same_split(got, jcifar.load_cifar_continual(opt, split, phase, **kw))
    if split == "train":
        assert len(got.basec_map) == 60


@pytest.mark.parametrize("trainb", [False, True])
@pytest.mark.parametrize("partition,phase,pretrain", [
    ("train", "train", True), ("train", "val", True), ("train", "test", True),
    ("val", None, False), ("test", None, False)])
def test_tiered_matches_jax(roots, partition, phase, pretrain, trainb):
    opt = Opt(os.path.join(roots, "tiered"), augment_pretrain_wtrainb=trainb)
    got = tiered.load_tiered_imagenet(opt, partition, phase, pretrain)
    _same_split(got, jtiered.load_tiered_imagenet(opt, partition, phase,
                                                  pretrain))
    pooled = trainb and phase == "train"
    assert len(set(got.labels)) == {True: 30, False: 20}[pooled] \
        if pretrain else len(set(got.labels)) == 10


@pytest.mark.parametrize("dataset,sessions,want", [
    ("miniImageNet", 2000, (60, 8, "A")),
    ("CIFAR-FS", 2000, (60, 8, "D")),
    ("FC100", 10, (60, 8, "D")),                # clamped to 40 / 5
    ("tieredImageNet", 2000, (351, 2, "A")),    # clamped to 10 / 5
])
def test_load_eval_splits_per_dataset(roots, dataset, sessions, want):
    root = os.path.join(roots, "tiered" if dataset == "tieredImageNet"
                        else "continual")
    opts = [Opt(root, dataset=dataset, neval_episodes=sessions)
            for _ in range(2)]
    got = eval_splits.load_eval_splits(opts[0])
    ref = jsplits.load_eval_splits(opts[1])
    for a, b in zip(got[:3], ref[:3]):
        _same_split(a, b)
    assert got[3] == ref[3] == want[0]
    assert opts[0].neval_episodes == opts[1].neval_episodes == want[1]
    assert opts[0].transform == opts[1].transform == want[2]
    # no base exemplars: the base-train split is not read
    opt = Opt(root, dataset=dataset, n_base_support_samples=0)
    assert eval_splits.load_eval_splits(opt)[1] is None


def test_load_eval_splits_lazy_views(roots):
    opt = Opt(os.path.join(roots, "continual"), dataset="CIFAR-FS")
    lazy = eval_splits.load_eval_splits(opt, lazy=True)
    eager = eval_splits.load_eval_splits(
        Opt(os.path.join(roots, "continual"), dataset="CIFAR-FS"))
    for a, b in zip(lazy[:3], eager[:3]):
        assert type(a.imgs).__name__ == "LazyRows"
        _same_split(a, b)


def _files(root):
    return sorted(os.listdir(root))


def test_generators_write_the_jax_bytes(tmp_path):
    for name, kw in (("cifar", dict(n_classes=9, per_class=3)),
                     ("cifar_sparse", dict(n_classes=9, per_class=3,
                                           sparse_labels=True))):
        a, b = str(tmp_path / f"j_{name}"), str(tmp_path / f"p_{name}")
        jsyn.make_cifar(a, **kw)
        synthetic.make_cifar(b, **kw)
        assert _files(a) == _files(b)
        for f in _files(a):
            with open(os.path.join(a, f), "rb") as fa, \
                    open(os.path.join(b, f), "rb") as fb:
                assert fa.read() == fb.read(), f
    for trainb in (True, False):
        a, b = str(tmp_path / f"j_t{trainb}"), str(tmp_path / f"p_t{trainb}")
        kw = dict(n_classes=6, per_class=3, img_size=8, with_train_b=trainb)
        jsyn.make_tiered(a, **kw)
        synthetic.make_tiered(b, **kw)
        assert _files(a) == _files(b)
        for f in _files(a):
            pa, pb = os.path.join(a, f), os.path.join(b, f)
            if f.endswith(".npz"):
                np.testing.assert_array_equal(np.load(pa)["images"],
                                              np.load(pb)["images"])
            else:
                with open(pa, "rb") as fa, open(pb, "rb") as fb:
                    assert fa.read() == fb.read(), f
    a = jsyn.make_description_embeds(str(tmp_path / "jd"), n_classes=7)
    b = synthetic.make_description_embeds(str(tmp_path / "pd"), n_classes=7)
    assert os.path.basename(a) == os.path.basename(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with open(b, "rb") as f:
        assert sorted(pickle.load(f))[:2] == ["synthetic 0", "synthetic 1"]


class _NoDropblock:
    no_dropblock = False


@pytest.mark.parametrize("dataset,size", [
    ("miniImageNet", 5), ("tieredImageNet", 5), ("CIFAR-FS", 2),
    ("FC100", 2)])
def test_factory_dropblock_size_per_dataset(dataset, size):
    bb = create_model("resnet12", _NoDropblock(), dataset=dataset)
    jbb = jax_create("resnet12", 64, _NoDropblock(), dataset=dataset)
    assert jbb.dropblock_size == size
    assert {blk.block_size for blk in bb.blocks()} == {size}
    assert bb.feature_dim == 640


def test_factory_refuses_an_unknown_dataset():
    with pytest.raises(NotImplementedError, match="dataset"):
        create_model("resnet12", _NoDropblock(), dataset="CUB")


def test_32px_backbone_matches_jax_with_its_dropblock_masks():
    """A resnet12-layout backbone at 32 px with drop rate 0.1 and
    DropBlock 2 (CIFAR's), two train-mode forwards: features, running
    statistics and counters against flax's with the masks flax draws."""
    kw = dict(n_blocks=(1, 1, 1, 1), drop_rate=0.1, dropblock_size=2,
              no_dropblock=False, avg_pool=True, widths=(8, 16, 24, 32))
    jbb = JaxResNet(**kw)
    variables = jax.tree_util.tree_map(np.asarray, dict(jbb.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)))
    tbb = ResNetRFS(**kw)
    tbb.load_state_dict(from_jax_variables(variables))
    tbb.train()
    assert {b.block_size for b in tbb.blocks()} == {2}
    x = np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        ref, mut = jbb.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats", "counters"],
                             rngs={"dropout": key})
        variables = {**variables, **jax.tree_util.tree_map(np.asarray,
                                                           dict(mut))}
        got = tbb(xt, generator=JaxDropout(dropout_keys(jbb, 32, key)))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=0)
    sd = tbb.state_dict()
    for k, v in from_jax_variables(variables).items():
        if k.endswith("num_batches_tracked"):
            assert int(sd[k]) == int(v) == 2, k
        else:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-4,
                                       rtol=0, err_msg=k)
