"""The port's orbax directory checkpoints (subspace_reg_tpu_torch/utils/
checkpoint.py::save_orbax, load_orbax) held against the JAX package's
(subspace_reg_tpu/utils/checkpoint.py, orbax 0.11.32) on the CPU:

* JAX ``save_orbax`` -> port ``load_orbax`` and port ``save_orbax`` -> JAX
  ``load_orbax``, with and without a head bias, on a narrow resnet with SE
  blocks and non-trivial statistics and counters (the pattern of
  tests/test_torch_checkpoint.py's fixture; the JAX-form tree comes from
  ``to_jax_variables``, which that file holds against JAX's, so that the
  fixture costs no flax init of 20 s): every leaf
  bit-identical (dtype, shape, bytes), ``n_active``, ``has_bias`` and
  ``meta`` equal; the port's directory holds orbax's files, ``_METADATA``
  byte for byte as orbax writes it for the same tree, and a second save
  replaces it;
* the evaluation engine's first session from the orbax-loaded weights
  prints and returns what the run from the ``.ckpt`` of the same state
  does;
* a full-width resnet18 (26.27 M values, 105 MB, its largest leaf 14.7 MB
  in one chunk) in each direction, bit-identical, with its seconds
  printed;
* the committed directory that JAX ``save_orbax`` wrote
  (tests/fixtures/orbax_resnet, which chip_smoke.py's phase 18 loads on
  the card): its frames hold what orbax's zstd writes (compressed blocks,
  Huffman literals in 1 and 4 streams, FSE-coded sequence tables, frames
  of two blocks), it holds the state that tests/fixtures/
  make_orbax_fixture.py makes, and the port's ``load_orbax`` and JAX's
  read it bit-identical to its ``.ckpt`` twin.
"""

import collections
import contextlib
import importlib.util
import io
import os
import time

import numpy as np
import pytest
import torch

import jax
from subspace_reg_tpu.models.head import Head as JaxHead
from subspace_reg_tpu.utils import checkpoint as jckpt
from subspace_reg_tpu_torch.data import synthetic
from subspace_reg_tpu_torch.data.episodes import EpisodeSampler
from subspace_reg_tpu_torch.data.mini_imagenet import load_mini_imagenet
from subspace_reg_tpu_torch.engine.incremental import (
    few_shot_finetune_incremental_test)
from subspace_reg_tpu_torch.models.factory import create_model
from subspace_reg_tpu_torch.models.head import Head, init_head
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.utils import checkpoint as ckpt
from subspace_reg_tpu_torch.weights import (from_jax_variables,
                                            to_jax_variables)
from test_torch_checkpoint import META, N_CLS, WIDTHS
from test_torch_engine import Opt

ORBAX_FILES = {"_CHECKPOINT_METADATA", "_METADATA", "d", "manifest.ocdbt",
               "meta.pkl", "ocdbt.process_0"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread for this module: the tier-1 lane runs six
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: np.asarray(tree)}


def _narrow():
    return ResNetRFS(n_blocks=(1, 1, 2, 1), drop_rate=0.0,
                     no_dropblock=True, use_se=True, avg_pool=True,
                     widths=WIDTHS)


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX-form tree of a narrow resnet with SE blocks, its running
    statistics perturbed and its counters at 5."""
    torch.manual_seed(0)
    variables = to_jax_variables(_narrow().state_dict())
    r = np.random.RandomState(1)

    def walk(tree, fn):
        return {k: walk(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}
    variables["batch_stats"] = walk(
        variables["batch_stats"],
        lambda v: (v + 0.1 * r.rand(*v.shape)).astype(np.float32))
    variables["counters"] = walk(variables["counters"],
                                 lambda v: np.asarray(5, np.int32))
    return variables


def _same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _head(with_bias, n=N_CLS, d=WIDTHS[-1], seed=3):
    r = np.random.RandomState(seed)
    w = r.randn(n + 4, d).astype(np.float32)
    b = r.randn(n + 4).astype(np.float32) if with_bias else None
    return w, b


@pytest.mark.parametrize("bias", [False, True])
def test_jax_orbax_loads_in_the_port(jax_tree, tmp_path, bias):
    variables = jax_tree
    w, b = _head(bias)
    path = str(tmp_path / "jax_orbax")
    jckpt.save_orbax(path, variables,
                     JaxHead(weight=w, bias=b, n_active=N_CLS), META)
    pvars, head, meta = ckpt.load_orbax(path)
    _same_tree(pvars, variables)
    assert head.weight.dtype == np.float32
    assert head.weight.tobytes() == w.tobytes()
    assert (head.bias is None) is (not bias)
    if bias:
        assert head.bias.tobytes() == b.tobytes()
    assert type(head.n_active) is int and head.n_active == N_CLS
    assert meta == META


@pytest.mark.parametrize("bias", [False, True])
def test_port_orbax_loads_in_jax(jax_tree, tmp_path, bias):
    variables = jax_tree
    w, b = _head(bias, seed=5)
    model = _narrow()
    model.load_state_dict(from_jax_variables(variables))
    path = str(tmp_path / "port_orbax")
    head = Head(weight=torch.from_numpy(w),
                bias=None if b is None else torch.from_numpy(b),
                n_active=N_CLS)
    ckpt.save_orbax(path, to_jax_variables(model.state_dict()), head, META)
    assert set(os.listdir(path)) == ORBAX_FILES
    jvars, jhead, jmeta = jckpt.load_orbax(path)
    _same_tree(jax.tree_util.tree_map(np.asarray, jvars), variables)
    assert np.asarray(jhead.weight).tobytes() == w.tobytes()
    assert (jhead.bias is None) is (not bias)
    if bias:
        assert np.asarray(jhead.bias).tobytes() == b.tobytes()
    assert int(jhead.n_active) == N_CLS
    assert jmeta == META
    # orbax's _METADATA for the same tree is byte for byte the port's
    ref = str(tmp_path / "ref")
    jckpt.save_orbax(ref, variables, JaxHead(weight=w, bias=b,
                                             n_active=N_CLS), META)
    for name in ("_METADATA", "meta.pkl"):
        with open(os.path.join(path, name), "rb") as f1, \
                open(os.path.join(ref, name), "rb") as f2:
            assert f1.read() == f2.read(), name
    # a second save replaces the directory (JAX saves with force=True)
    ckpt.save_orbax(path, variables, Head(weight=w[:2], bias=None,
                                          n_active=1), {"epoch": 9})
    _, head2, meta2 = ckpt.load_orbax(path)
    assert head2.weight.shape == (2, WIDTHS[-1]) and head2.bias is None
    assert meta2 == {"epoch": 9}
    assert not [d for d in os.listdir(tmp_path) if "tmp" in d]
    # a zarr v3 layout is refused by name
    meta_path = os.path.join(path, "_METADATA")
    with open(meta_path) as f:
        text = f.read()
    with open(meta_path, "w") as f:
        f.write(text.replace('"use_zarr3": false', '"use_zarr3": true'))
    with pytest.raises(ValueError, match="zarr v2"):
        ckpt.load_orbax(path)


# --------------------------------------------------------------------------
# the evaluation engine from orbax-loaded weights
# --------------------------------------------------------------------------
ENGINE_WIDTHS = (8, 16, 24, 80)


def _engine(root, backbone, head):
    opt = Opt()
    opt.data_root = root
    opt.word_embed_path = os.path.join(root, "word_embeds")
    opt.neval_episodes = 1

    def split(**kw):
        return load_mini_imagenet(opt, train_per_class=10, val_per_class=2,
                                  **kw)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = few_shot_finetune_incremental_test(
            backbone, head, {}, opt,
            meta_sampler=EpisodeSampler(split(split="val"), opt,
                                        split="val", disjoint_classes=True),
            base_test_split=split(split="train", phase="test"),
            base_support_sampler=EpisodeSampler(
                split(split="train", phase="train"), opt, split="train",
                phase="train"),
            verbose=True, device="cpu")
    return res, buf.getvalue()


def _backbone(sd):
    model = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.0,
                      no_dropblock=True, avg_pool=True,
                      widths=ENGINE_WIDTHS)
    model.load_state_dict(sd)
    return model


def test_engine_from_orbax_equals_engine_from_ckpt(tmp_path):
    root = str(tmp_path / "data")
    synthetic.make_mini_imagenet(root, n_classes=100, per_class=20,
                                 img_size=16, seed=0)
    synthetic.make_word_embeds(os.path.join(root, "word_embeds"))
    torch.manual_seed(1)
    state = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.0,
                      no_dropblock=True, avg_pool=True,
                      widths=ENGINE_WIDTHS).state_dict()
    head0 = init_head(60, ENGINE_WIDTHS[-1], with_bias=False,
                      max_classes=65,
                      generator=torch.Generator().manual_seed(2))
    variables = to_jax_variables(state)
    jhead = JaxHead(weight=head0.weight.numpy(), bias=None, n_active=60)
    jckpt.save_orbax(str(tmp_path / "orbax"), variables, jhead, {})
    ckpt.save_checkpoint(str(tmp_path / "m.ckpt"), variables, head0, {})
    runs = []
    for loaded in (ckpt.load_orbax(str(tmp_path / "orbax")),
                   ckpt.load_checkpoint(str(tmp_path / "m.ckpt"))):
        v, h, _ = loaded
        head = Head(weight=torch.from_numpy(np.array(h.weight)), bias=None,
                    n_active=h.n_active)
        runs.append(_engine(root, _backbone(from_jax_variables(v)), head))
    (r1, out1), (r2, out2) = runs
    assert "Fine-tuning epochs:" in out1 and out1 == out2
    assert r1.epochs_per_session == r2.epochs_per_session
    assert r1.acc_novel_list == r2.acc_novel_list
    assert r1.acc_base_list == r2.acc_base_list


# --------------------------------------------------------------------------
# full width
# --------------------------------------------------------------------------
class _ModelOpt:
    no_dropblock = True


def _resnet18():
    torch.manual_seed(0)
    variables = to_jax_variables(
        create_model("resnet18", _ModelOpt()).state_dict())
    leaves = _flat(variables)
    n = sum(a.size for a in leaves.values())
    big = max(leaves.values(), key=lambda a: a.nbytes)
    assert n > 26e6 and big.nbytes == 640 * 640 * 9 * 4
    return variables


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_full_width_resnet18(tmp_path, direction):
    variables = _resnet18()
    w, b = _head(True, n=64, d=640, seed=7)
    path = str(tmp_path / direction)
    t0 = time.time()
    if direction == "jax_to_port":
        jckpt.save_orbax(path, variables,
                         JaxHead(weight=w, bias=b, n_active=64), {"e": 1})
        t1 = time.time()
        got, head, meta = ckpt.load_orbax(path)
    else:
        ckpt.save_orbax(path, variables, Head(
            weight=torch.from_numpy(w), bias=torch.from_numpy(b),
            n_active=64), {"e": 1})
        t1 = time.time()
        got, head, meta = jckpt.load_orbax(path)
        got = jax.tree_util.tree_map(np.asarray, got)
    t2 = time.time()
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)
    print(f"\n{direction}: save {t1 - t0:.2f} s, load {t2 - t1:.2f} s, "
          f"{size / 1e6:.1f} MB on disk")
    _same_tree(got, variables)
    assert np.asarray(head.weight).tobytes() == w.tobytes()
    assert np.asarray(head.bias).tobytes() == b.tobytes()
    assert int(head.n_active) == 64 and meta == {"e": 1}


# --------------------------------------------------------------------------
# the committed directory JAX save_orbax wrote
# --------------------------------------------------------------------------
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "orbax_resnet")


def _zstd_features(buf):
    """Counts of the block and section kinds in the zstd frames of
    ``buf``, from their headers (RFC 8878 3.1.1)."""
    out = collections.Counter()
    i = 0
    while i < len(buf):
        assert int.from_bytes(buf[i:i + 4], "little") == 0xFD2FB528
        d = buf[i + 4]
        single = (d >> 5) & 1
        i += 5 + (not single) + [0, 1, 2, 4][d & 3] + [
            single, 2, 4, 8][d >> 6]
        n_blocks, last = 0, 0
        while not last:
            h = int.from_bytes(buf[i:i + 3], "little")
            last, kind, size = h & 1, (h >> 1) & 3, h >> 3
            i += 3
            n_blocks += 1
            out[("raw", "rle", "compressed")[kind]] += 1
            if kind == 1:
                i += 1
                continue
            if kind == 2:
                block = buf[i:i + size]
                lt, sf = block[0] & 3, (block[0] >> 2) & 3
                if lt < 2:
                    hs = (1, 2, 1, 3)[sf]
                    regen = int.from_bytes(block[:hs], "little") >> (
                        3 if sf in (0, 2) else 4)
                    j = hs + (regen if lt == 0 else 1)
                else:
                    hs, bits = ((3, 10), (3, 10), (4, 14), (5, 18))[sf]
                    h2 = int.from_bytes(block[:hs], "little")
                    j = hs + ((h2 >> (4 + bits)) & ((1 << bits) - 1))
                    out[("huffman", "treeless")[lt - 2]
                        + ("_1_stream" if sf == 0 else "_4_streams")] += 1
                n = block[j]
                if n:
                    modes = block[j + (1 if n < 128 else 2 if n < 255
                                       else 3)]
                    for shift in (6, 4, 2):
                        out["sequences_" + ("predefined", "rle", "fse",
                                            "repeat")[(modes >> shift) & 3]
                            ] += 1
            i += size
        out[f"frames_of_{n_blocks}_blocks"] += 1
        i += 4 * ((d >> 2) & 1)
    return out


def test_committed_fixture_is_what_orbax_writes():
    from subspace_reg_tpu_torch.utils import ocdbt
    root = os.path.join(FIXTURE, "orbax")
    got = collections.Counter()
    for k, v in ocdbt.read_store(root).items():
        if not k.endswith(b".zarray"):
            got.update(_zstd_features(v))
    # the b-tree leaves tensorstore wrote
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                obj = fh.read()
            if obj[:4] == ocdbt.BTREE_MAGIC.to_bytes(4, "big"):
                assert obj[12:14] == b"\x00\x01"  # version 0, zstd
                got.update(_zstd_features(obj[14:-4]))
    for kind in ("compressed", "huffman_1_stream", "huffman_4_streams",
                 "sequences_fse", "sequences_predefined",
                 "frames_of_2_blocks"):
        assert got[kind], (kind, dict(got))


def test_committed_fixture_loads_bit_identical():
    spec = importlib.util.spec_from_file_location(
        "make_orbax_fixture", os.path.join(FIXTURE, os.pardir,
                                           "make_orbax_fixture.py"))
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    variables, want = maker.state()
    pvars, head, meta = ckpt.load_orbax(os.path.join(FIXTURE, "orbax"))
    cvars, chead, cmeta = ckpt.load_checkpoint(os.path.join(FIXTURE,
                                                            "state.ckpt"))
    jvars, jhead, jmeta = jckpt.load_orbax(os.path.join(FIXTURE, "orbax"))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    for tree in (pvars, cvars, jvars):
        _same_tree(tree, variables)
    for h in (head, chead, jhead):
        assert np.asarray(h.weight).tobytes() == want.weight.tobytes()
        assert np.asarray(h.bias).tobytes() == want.bias.tobytes()
        assert int(h.n_active) == maker.N_ACTIVE
    assert type(head.n_active) is int
    assert meta == cmeta == jmeta == maker.META
