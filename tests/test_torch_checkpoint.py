"""The JAX package's ``.ckpt`` format in the port
(subspace_reg_tpu_torch/utils/{msgpack_codec,checkpoint}.py and the
weights/optimizer bridge in weights.py), held against flax and the JAX
package's utils/checkpoint.py on the CPU:

* the codec's bytes equal ``flax.serialization.msgpack_serialize``'s for the
  same tree (nested and empty dicts, 0-d arrays, f32/i32/i64/bool/bf16
  leaves, numpy scalars, Python primitives, the chunked form with
  ``MAX_CHUNK_SIZE`` patched small on both sides), and each side restores
  the other's bytes to equal leaves;
* a JAX-written ``.ckpt`` (with ``extra``) loads in the port: features equal
  the JAX model's to rtol 1e-5 (f32, a narrow resnet with SE blocks), meta
  and ``has_bias`` equal, the ``max_classes`` padding bit-equal to JAX
  ``load_any``'s;
* a port-written ``.ckpt`` loads in JAX ``load_checkpoint``/``load_any``
  with bit-equal leaves;
* SGD (with and without decay or momentum) and Adam states survive
  JAX -> port -> JAX bit-equal, and one step from a restored state matches
  JAX's f32 step (loss rtol 1e-4; parameters as tests/test_torch_pretrain.py
  holds them: rtol 1e-4 with atol 1e-4 of the leaf's largest value).
"""

import functools

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization as fser

from subspace_reg_tpu.data.transforms import transforms_options as jax_tf
from subspace_reg_tpu.engine import pretrain as jpt
from subspace_reg_tpu.models.head import Head as JaxHead
from subspace_reg_tpu.models.resnet import ResNetRFS as JaxResNet
from subspace_reg_tpu.utils import checkpoint as jckpt
from subspace_reg_tpu.utils import optim as joptim
from subspace_reg_tpu_torch.data.transforms import transforms_options
from subspace_reg_tpu_torch.engine import pretrain as pt
from subspace_reg_tpu_torch.models.head import Head
from subspace_reg_tpu_torch.models.resnet import ResNetRFS
from subspace_reg_tpu_torch.utils import checkpoint as ckpt
from subspace_reg_tpu_torch.utils import msgpack_codec as codec
from subspace_reg_tpu_torch.utils import optim
from subspace_reg_tpu_torch.weights import (from_jax_variables,
                                            load_checkpoint,
                                            to_jax_variables)
from test_torch_pretrain import JaxPretrainDraws

WIDTHS = (8, 16, 24, 32)
N_CLS, IMG, BATCH, SEED, LR, SPE = 12, 16, 8, 1, 0.05, 10


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _same_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        x, y = la[k], lb[k]
        if isinstance(x, torch.Tensor):
            x = x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        if isinstance(y, torch.Tensor):
            y = y.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _trees():
    r = np.random.RandomState(0)
    return {
        "nested": {"b": {"z": r.randn(3, 4).astype(np.float32),
                         "a": {"k": np.arange(5, dtype=np.int32)}},
                   "a": np.zeros((0,), np.float32), "e": {}},
        "zero_d": {"count": np.asarray(7, np.int32),
                   "n": np.asarray(60), "x": np.asarray(2.5, np.float32)},
        "dtypes": {"f32": r.randn(2, 3).astype(np.float32),
                   "i32": r.randint(-9, 9, (4,)).astype(np.int32),
                   "i64": np.arange(3, dtype=np.int64) - 2 ** 40,
                   "bool": np.asarray([True, False, True]),
                   "bf16": r.randn(4, 2).astype(ml_dtypes.bfloat16),
                   "big": r.randn(70).astype(np.float32)},
        "scalars": {"f": np.float32(1.25), "i": np.int64(-7),
                    "b": np.bool_(True)},
        "primitives": {"ints": [0, 127, 128, 255, 256, 65536, 2 ** 33, -1,
                                -32, -33, -129, -40000, -2 ** 40],
                       "floats": [0.5, -1e300], "s": "x" * 40,
                       "none": None, "t": True, "bytes": b"ab" * 200,
                       "c": 3 - 4j, "many": {f"k{i}": i for i in range(20)}},
    }


@pytest.mark.parametrize("name", sorted(_trees()))
def test_codec_bytes_equal_flax(name):
    tree = _trees()[name]
    ours, theirs = codec.msgpack_serialize(tree), fser.msgpack_serialize(tree)
    assert ours == theirs
    _same_leaves(codec.msgpack_restore(theirs), fser.msgpack_restore(ours))
    _same_leaves(codec.msgpack_restore(ours), tree)


def test_codec_writes_torch_leaves_as_flax_writes_numpy():
    r = np.random.RandomState(1)
    a = r.randn(3, 5).astype(np.float32)
    b = r.randn(4).astype(ml_dtypes.bfloat16)
    tb = torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16)
    assert (codec.msgpack_serialize({"a": torch.from_numpy(a), "b": tb})
            == fser.msgpack_serialize({"a": a, "b": b}))
    back = codec.msgpack_restore(fser.msgpack_serialize({"b": b}))["b"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, tb)


def test_codec_chunked_form(monkeypatch):
    """Leaves above MAX_CHUNK_SIZE bytes go into flax's chunked form, the
    same bytes on both sides; nested and top-level leaves."""
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    r = np.random.RandomState(2)
    tree = {"w": r.randn(7, 9).astype(np.float32),
            "inner": {"i": np.arange(33, dtype=np.int64),
                      "small": np.arange(3, dtype=np.int32)},
            "bf": r.randn(40).astype(ml_dtypes.bfloat16)}
    ours, theirs = codec.msgpack_serialize(tree), fser.msgpack_serialize(tree)
    assert ours == theirs and b"__msgpack_chunked_array__" in ours
    _same_leaves(codec.msgpack_restore(ours), tree)
    _same_leaves(fser.msgpack_restore(ours), tree)
    top = r.randn(50).astype(np.float32)
    assert codec.msgpack_serialize(top) == fser.msgpack_serialize(top)
    np.testing.assert_array_equal(
        codec.msgpack_restore(fser.msgpack_serialize(top)), top)


def test_codec_refuses_what_flax_refuses():
    for bad in ({"t": (1, 2)}, {"o": object()}):
        with pytest.raises(TypeError):
            codec.msgpack_serialize(bad)
        with pytest.raises(TypeError):
            fser.msgpack_serialize(bad)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_model():
    """A narrow resnet with SE blocks and non-trivial statistics and
    counters."""
    jbb = JaxResNet(n_blocks=(1, 1, 2, 1), drop_rate=0.0, no_dropblock=True,
                    use_se=True, avg_pool=True, widths=WIDTHS)
    variables = jax.tree_util.tree_map(np.asarray, dict(jbb.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False)))
    r = np.random.RandomState(1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda v: (v + 0.1 * r.rand(*v.shape)).astype(np.float32),
        variables["batch_stats"])
    variables["counters"] = jax.tree_util.tree_map(
        lambda v: np.asarray(5, np.int32), variables["counters"])
    return jbb, variables


def _port_model(**kw):
    return ResNetRFS(n_blocks=(1, 1, 2, 1), drop_rate=0.0, no_dropblock=True,
                     use_se=True, avg_pool=True, widths=WIDTHS, **kw)


def test_to_jax_variables_inverts_from_jax_variables(jax_model):
    _, variables = jax_model
    back = to_jax_variables(from_jax_variables(variables))
    _same_leaves(back, variables)


META = {"epoch": 3, "training_classes": {4: 0, 9: 1},
        "label2human": ["a b", "c"], "lr": np.float32(0.05)}


@pytest.mark.parametrize("bias", [False, True])
def test_jax_ckpt_loads_in_the_port(jax_model, tmp_path, bias):
    jbb, variables = jax_model
    r = np.random.RandomState(3)
    w = r.randn(N_CLS, WIDTHS[-1]).astype(np.float32)
    b = r.randn(N_CLS).astype(np.float32) if bias else None
    path = str(tmp_path / "resnet12_last.ckpt")
    extra = {"opt_state": ({}, {"trace": {"w": w}}), "step": np.int32(4)}
    jckpt.save_checkpoint(path, variables, JaxHead(weight=w, bias=b,
                                                   n_active=N_CLS),
                          META, extra=extra)
    sd, head, meta = load_checkpoint(path, max_classes=20)
    _, jhead, jmeta = jckpt.load_any(path, max_classes=20, device=False)
    np.testing.assert_array_equal(head.weight.numpy(), jhead.weight)
    assert head.n_active == int(jhead.n_active) == N_CLS
    assert meta["has_bias"] is bias and (head.bias is None) is (not bias)
    if bias:
        np.testing.assert_array_equal(head.bias.numpy(), jhead.bias)
    for k, v in META.items():
        assert meta[k] == jmeta[k] == v, k
    _same_leaves(meta["extra"], jmeta["extra"])
    model = _port_model()
    model.load_state_dict(sd)
    x = np.random.RandomState(4).randn(3, IMG, IMG, 3).astype(np.float32)
    ref = np.asarray(jbb.apply(variables, jnp.asarray(x), train=False))
    got = model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-6)
    assert all(int(blk.num_batches_tracked) == 5 for blk in model.blocks())


def test_port_ckpt_loads_in_jax(jax_model, tmp_path):
    """The port's save_checkpoint: JAX load_checkpoint and load_any read
    bit-equal leaves (variables, head, extra), meta and has_bias."""
    _, variables = jax_model
    model = _port_model()
    model.load_state_dict(from_jax_variables(variables))
    r = np.random.RandomState(5)
    w = torch.from_numpy(r.randn(N_CLS, WIDTHS[-1]).astype(np.float32))
    b = torch.from_numpy(r.randn(N_CLS).astype(np.float32))
    extra = {"opt_state": {"0": {}, "1": {"count": np.asarray(4, np.int32)}},
             "step": np.asarray(4, np.int32)}
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, to_jax_variables(model.state_dict()),
                         Head(weight=w, bias=b, n_active=N_CLS), META,
                         extra=extra)
    jvars, jhead, jmeta = jckpt.load_checkpoint(path, device=False)
    _same_leaves(jvars, variables)
    np.testing.assert_array_equal(np.asarray(jhead.weight), w.numpy())
    np.testing.assert_array_equal(np.asarray(jhead.bias), b.numpy())
    assert int(jhead.n_active) == N_CLS
    _same_leaves(jmeta.pop("extra"), extra)
    assert jmeta == META
    _, jpad, _ = jckpt.load_any(path, max_classes=20, device=False)
    _, pad, meta = ckpt.load_any(path, max_classes=20)
    np.testing.assert_array_equal(pad.weight.numpy(), jpad.weight)
    np.testing.assert_array_equal(pad.bias.numpy(), jpad.bias)
    assert meta["has_bias"]
    # the port reads its own file back leaf for leaf
    pvars, phead, pmeta = ckpt.load_checkpoint(path)
    _same_leaves(pvars, variables)
    _same_leaves(pmeta["extra"], extra)


# --------------------------------------------------------------------------
# optimizer state and resume
# --------------------------------------------------------------------------
OPTIMIZERS = {
    "sgd": dict(adam=False, momentum=0.9, wd=5e-4),
    "sgd_no_decay": dict(adam=False, momentum=0.9, wd=0.0),
    "sgd_no_momentum": dict(adam=False, momentum=0.0, wd=5e-4),
    "adam": dict(adam=True, wd=5e-4),
    "adam_no_decay": dict(adam=True, wd=0.0),
}


def _txs(adam, wd, momentum=0.0):
    sched = joptim.step_decay_schedule(LR, [60, 80], 0.1, SPE)
    if adam:
        return (joptim.adam_torch(sched, weight_decay=wd),
                functools.partial(optim.adam_torch, learning_rate=LR,
                                  weight_decay=wd))
    return (joptim.sgd_torch(sched, momentum=momentum, weight_decay=wd),
            functools.partial(optim.sgd_torch, learning_rate=LR,
                              momentum=momentum, weight_decay=wd))


def _batch(i):
    r = np.random.RandomState(10 + i)
    return (r.randint(0, 256, size=(BATCH, IMG, IMG, 3)).astype(np.uint8),
            r.randint(0, N_CLS, size=(BATCH,)).astype(np.int32))


def _jax_trained(tx, with_bias, steps=2):
    jbb = JaxResNet(n_blocks=(1, 1, 1, 1), drop_rate=0.0, no_dropblock=True,
                    avg_pool=True, widths=WIDTHS)
    js = jpt.init_pretrain_state(jbb, jax.random.PRNGKey(0), N_CLS, IMG, tx,
                                 with_bias=with_bias)
    step_j = jpt.make_train_step(jbb, tx, jax_tf["A"][0],
                                 with_bias=with_bias)
    key = jax.random.PRNGKey(SEED)
    for i in range(steps):
        x, y = _batch(i)
        js, _ = step_j(js, jnp.asarray(x), jnp.asarray(y), key)
    return jbb, step_j, js


def _jax_save(js, path, with_bias, epoch=1):
    w = np.asarray(js.params["head"]["w"])
    b = np.asarray(js.params["head"]["b"]) if with_bias else None
    jckpt.save_checkpoint(
        path, {"params": js.params["backbone"],
               "batch_stats": js.batch_stats, "counters": js.counters},
        JaxHead(weight=w, bias=b, n_active=N_CLS), {"epoch": epoch},
        extra={"opt_state": js.opt_state, "step": js.step})


def _port_state(tx_t, with_bias):
    bb = ResNetRFS(n_blocks=(1, 1, 1, 1), drop_rate=0.0, no_dropblock=True,
                   avg_pool=True, widths=WIDTHS)
    return pt.init_pretrain_state(bb, N_CLS, tx_t, with_bias, device="cpu")


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_state_survives_jax_port_jax(name, tmp_path):
    """A JAX state two steps in -> JAX .ckpt -> the port's state ->
    the port's .ckpt -> JAX load_checkpoint with the state's template:
    every leaf of params, statistics, counters, optimizer state and step
    bit-equal."""
    o = OPTIMIZERS[name]
    tx, tx_t = _txs(o["adam"], o["wd"], o.get("momentum", 0.0))
    with_bias = name == "sgd"
    _, _, js = _jax_trained(tx, with_bias)
    a, b = str(tmp_path / "jax.ckpt"), str(tmp_path / "port.ckpt")
    _jax_save(js, a, with_bias, epoch=7)
    ts = _port_state(tx_t, with_bias)
    assert pt.restore_pretrain_state(ts, *ckpt.load_checkpoint(a)) == 8
    assert ts.step == 2
    variables, head, extra = pt.checkpoint_parts(ts)
    ckpt.save_checkpoint(b, variables, head, {"epoch": 7}, extra=extra)
    template = {"opt_state": js.opt_state, "step": js.step}
    jvars, jhead, jmeta = jckpt.load_checkpoint(b, extra_template=template,
                                                device=False)
    _same_leaves(jvars, jax.tree_util.tree_map(np.asarray, {
        "params": js.params["backbone"], "batch_stats": js.batch_stats,
        "counters": js.counters}))
    np.testing.assert_array_equal(np.asarray(jhead.weight),
                                  np.asarray(js.params["head"]["w"]))
    _same_leaves(jax.tree_util.tree_map(np.asarray, jmeta["extra"]),
                 jax.tree_util.tree_map(np.asarray, template))
    assert jax.tree_util.tree_structure(jmeta["extra"]["opt_state"]) == \
        jax.tree_util.tree_structure(js.opt_state)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_step_from_a_restored_state_matches_jax(name, tmp_path):
    """One f32 step from a JAX state restored in the port against JAX's
    step from the same state, on the same batch and draws."""
    o = OPTIMIZERS[name]
    tx, tx_t = _txs(o["adam"], o["wd"], o.get("momentum", 0.0))
    jbb, step_j, js = _jax_trained(tx, False)
    path = str(tmp_path / "jax.ckpt")
    _jax_save(js, path, False)
    ts = _port_state(tx_t, False)
    pt.restore_pretrain_state(ts, *ckpt.load_checkpoint(path))
    step = pt.make_train_step(
        ts.backbone, optim.step_decay_schedule(LR, [60, 80], 0.1, SPE),
        transforms_options["A"][0], False, JaxPretrainDraws(SEED))
    x, y = _batch(5)
    js, mj = step_j(js, jnp.asarray(x), jnp.asarray(y),
                    jax.random.PRNGKey(SEED))
    m = step(ts, torch.from_numpy(x), torch.from_numpy(y).long())
    assert float(m["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-4)
    assert ts.step == int(js.step) == 3
    ref = from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        "params": js.params["backbone"], "batch_stats": js.batch_stats,
        "counters": js.counters}))
    got = ts.backbone.state_dict()
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(v) == 3, k
        elif "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(
                got[k].numpy(), v.numpy(), rtol=1e-4,
                atol=1e-4 * float(v.abs().max()), err_msg=k)
    wj = np.asarray(js.params["head"]["w"])
    np.testing.assert_allclose(ts.head["w"].detach().numpy(), wj, rtol=1e-4,
                               atol=1e-4 * np.abs(wj).max())


def test_restore_refuses_another_optimizer(tmp_path):
    """An Adam state does not restore into an SGD optimizer."""
    tx, _ = _txs(True, 5e-4)
    _, _, js = _jax_trained(tx, False, steps=1)
    path = str(tmp_path / "adam.ckpt")
    _jax_save(js, path, False)
    ts = _port_state(_txs(False, 5e-4, 0.9)[1], False)
    with pytest.raises((ValueError, KeyError)):
        pt.restore_pretrain_state(ts, *ckpt.load_checkpoint(path))
