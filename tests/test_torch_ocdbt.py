"""The port's OCDBT store (subspace_reg_tpu_torch/utils/ocdbt.py) and zarr
v2 arrays (utils/zarr2.py), held against tensorstore on the CPU, in both
directions (the port never imports tensorstore):

* stores the port writes in orbax's two-level layout, with values above
  and below the 1024-byte inline limit and the empty key, or inline
  values only, read in tensorstore's ``ocdbt`` kvstore to the same keys
  and bytes (the top-level store and the process's), and an empty store;
* stores tensorstore writes read in the port: orbax's config, an
  uncompressed config with a small node limit and inline limit (interior
  b-tree nodes, indirect values), and 40 commits (version-tree nodes);
  the port's version list equals tensorstore's generations;
* arrays the port writes read by tensorstore's zarr driver over the
  port's store, and arrays tensorstore's zarr driver writes with chunks
  smaller than the array (edge chunks, a missing chunk) read in the port;
* a corrupted node or manifest, a truncated data file and a data file
  outside the store raise.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import tensorstore as ts
from subspace_reg_tpu_torch.utils import ocdbt, zarr2


def _kv(path, **config):
    spec = {"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}/"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _ts_items(path):
    kv = _kv(path)
    return {k: kv[k] for k in kv.list().result()}


def _items(seed=0, n=120, largest=2500):
    r = np.random.RandomState(seed)
    sizes = [0, 1, 1023, 1024, 1025, 3000] + list(r.randint(0, largest, n))
    sizes = [s for s in sizes if s <= largest]
    items = {f"leaf/{i:04d}".encode(): r.bytes(s)
             for i, s in enumerate(sizes)}
    items[b""] = b"the empty key"
    items[b"a.b/.zarray"] = b"{}"
    return items


@pytest.mark.parametrize("largest", [3000, 1024])
def test_port_store_reads_in_tensorstore(tmp_path, largest):
    items = _items(largest=largest)
    ocdbt.write_store(str(tmp_path), items)
    assert _ts_items(tmp_path) == items
    assert ocdbt.read_store(str(tmp_path)) == items
    manifest = ocdbt.Store(str(tmp_path)).manifest
    assert manifest.config.max_inline_value_bytes == 1024
    assert manifest.config.max_decoded_node_bytes == 100_000_000
    assert manifest.config.compression == "zstd"
    # the values and a b-tree of their own under the process's store
    inner = os.path.join(str(tmp_path), ocdbt.PROCESS_DIR)
    assert _ts_items(inner) == items
    # values (when some exceed the inline limit) + leaf there, the
    # top-level leaf alone here
    indirect = any(len(v) > 1024 for v in items.values())
    assert indirect is (largest > 1024)
    assert len(os.listdir(os.path.join(inner, "d"))) == 1 + indirect
    assert len(os.listdir(os.path.join(str(tmp_path), "d"))) == 1


def test_empty_store(tmp_path):
    ocdbt.write_store(str(tmp_path), {})
    assert _ts_items(tmp_path) == {}
    assert ocdbt.read_store(str(tmp_path)) == {}


@pytest.mark.parametrize("config", ["orbax", "uncompressed_small_nodes"])
def test_tensorstore_store_reads_in_the_port(tmp_path, config):
    if config == "orbax":
        cfg = dict(max_inline_value_bytes=1024,
                   max_decoded_node_bytes=100_000_000,
                   compression={"id": "zstd"})
    else:
        cfg = dict(max_inline_value_bytes=8, max_decoded_node_bytes=600,
                   compression=None)
    kv = _kv(tmp_path, **cfg)
    items = _items(seed=1, n=300)
    with ts.Transaction() as txn:
        for k, v in items.items():
            kv.with_transaction(txn)[k] = v
    store = ocdbt.Store(str(tmp_path))
    assert store.items() == items
    if config != "orbax":
        assert store.latest().root_height >= 2  # interior nodes
        assert store.manifest.config.compression is None


def test_version_tree(tmp_path):
    kv = _kv(tmp_path)
    for i in range(40):
        kv[f"v{i:03d}"] = b"x" * (3 * i)
    kv["v005"] = b"rewritten"
    store = ocdbt.Store(str(tmp_path))
    assert store.manifest.version_nodes  # older versions left the manifest
    want = ts.ocdbt.dump(kv.base).result()
    gens = [v.generation for v in store.versions()]
    assert gens == list(range(1, len(gens) + 1))
    assert gens[-1] == want["versions"][-1]["generation_number"]
    items = store.items()
    assert items == _ts_items(tmp_path) and items[b"v005"] == b"rewritten"
    # an old version, read from a version-tree node
    v10 = next(v for v in store.versions() if v.generation == 12)
    assert sorted(store.items(v10)) == [f"v{i:03d}".encode()
                                        for i in range(11)]


ARRAYS = {
    "variables.params.conv.kernel": np.random.RandomState(0).randn(
        3, 3, 4, 8).astype(np.float32),
    "head_weight": np.random.RandomState(1).randn(5, 300).astype(np.float32),
    "variables.counters.c": np.asarray(7, np.int32),
    "head_n_active": np.asarray(60, np.int64),
    "vec": np.arange(1000, dtype=np.int32),
    "bf16": torch.from_numpy(np.random.RandomState(2).randn(4, 6).astype(
        np.float32)).to(torch.bfloat16),
}


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else a


def test_port_arrays_read_in_tensorstore_zarr(tmp_path):
    items = {}
    for name, a in ARRAYS.items():
        items.update(zarr2.encode_array(name, a))
    assert items[b"head_weight/.zarray"] == (
        b'{"chunks":[5,300],"compressor":{"id":"zstd","level":1},'
        b'"dimension_separator":".","dtype":"<f4","fill_value":null,'
        b'"filters":null,"order":"C","shape":[5,300],"zarr_format":2}')
    assert b"head_n_active/0" in items and b"vec/0" in items
    ocdbt.write_store(str(tmp_path), items)
    for name, a in ARRAYS.items():
        arr = ts.open({"driver": "zarr", "kvstore": {
            "driver": "ocdbt", "base": f"file://{tmp_path}/",
            "path": f"{name}/"}}, open=True).result()
        got = arr.read().result()
        assert got.shape == tuple(a.shape), name
        if isinstance(a, torch.Tensor):
            assert arr.dtype.name == "bfloat16"
            got = got.astype(np.float32)
        else:
            assert got.dtype == a.dtype, name
        np.testing.assert_array_equal(got, _f32(a))
        back = zarr2.read_array(ocdbt.read_store(str(tmp_path)), name)
        assert type(back) is type(a) and back.dtype == a.dtype
        np.testing.assert_array_equal(_f32(back), _f32(a))


@pytest.mark.parametrize("dtype", ["<f4", "<i8", "bfloat16"])
def test_tensorstore_chunked_arrays_read_in_the_port(tmp_path, dtype):
    r = np.random.RandomState(2)
    a = (100 * r.randn(10, 7)).astype(np.float32)
    if dtype == "<i8":
        a = a.astype(np.int64)
    arr = ts.open({"driver": "zarr", "kvstore": {
        "driver": "ocdbt", "base": f"file://{tmp_path}/", "path": "x/"},
        "metadata": {"shape": [10, 7], "chunks": [4, 3], "dtype": dtype,
                     "compressor": {"id": "zstd", "level": 3}},
        "create": True}).result()
    if dtype == "bfloat16":
        arr[...] = a.astype(arr.dtype.numpy_dtype)
    else:
        arr[...] = a
    want = arr.read().result()
    items = ocdbt.read_store(str(tmp_path))
    assert b"x/2.2" in items  # edge chunks, stored whole
    got = zarr2.read_array(items, "x")
    if dtype == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # a chunk missing from the store reads as zeros (fill_value null)
    del items[b"x/0.0"]
    got = zarr2.read_array(items, "x")
    got = got.float().numpy() if dtype == "bfloat16" else got
    assert not got[:4, :3].any()


def _head(path):
    with open(path, "rb") as f:
        return f.read(4)


def _corrupt(path, offset=None):
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        i = len(data) // 2 if offset is None else offset
        data[i] ^= 0x10
        f.seek(0)
        f.write(data)


def test_corrupt_stores_raise(tmp_path):
    items = _items(seed=3, n=20)
    good = str(tmp_path / "good")
    ocdbt.write_store(good, items)
    root = good + "_node"
    shutil.copytree(good, root)
    (node,) = [f for f in os.listdir(os.path.join(root, "d"))
               if _head(os.path.join(root, "d", f))
               == ocdbt.BTREE_MAGIC.to_bytes(4, "big")]
    _corrupt(os.path.join(root, "d", node))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.read_store(root)
    root = good + "_manifest"
    shutil.copytree(good, root)
    _corrupt(os.path.join(root, "manifest.ocdbt"))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.read_store(root)
    root = good + "_magic"
    shutil.copytree(good, root)
    _corrupt(os.path.join(root, "manifest.ocdbt"), offset=0)
    with pytest.raises(ocdbt.OcdbtError, match="magic"):
        ocdbt.read_store(root)
    root = good + "_short"
    shutil.copytree(good, root)
    inner = os.path.join(root, ocdbt.PROCESS_DIR, "d")
    (values,) = [f for f in os.listdir(inner)
                 if _head(os.path.join(inner, f))
                 != ocdbt.BTREE_MAGIC.to_bytes(4, "big")]
    path = os.path.join(inner, values)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 10)
    with pytest.raises(ocdbt.OcdbtError, match="ends before"):
        ocdbt.read_store(root)
    # the good copy still reads
    assert ocdbt.read_store(good) == items


def test_data_file_outside_the_store_raises(tmp_path):
    store = ocdbt.Store.__new__(ocdbt.Store)
    store.root = str(tmp_path)
    with pytest.raises(ocdbt.OcdbtError, match="outside"):
        store.read(ocdbt.Ref(("../", "d/x"), 0, 1))
