"""The OCDBT key-value store (tensorstore's "Optionally-Cooperative
Distributed B+Tree"), read and written without tensorstore: the store
inside an orbax directory checkpoint (utils/checkpoint.py::save_orbax,
load_orbax; its keys are zarr v2 arrays, utils/zarr2.py).

A store under a directory holds ``manifest.ocdbt`` and data files
``d/<32 hex digits>``.  Every manifest, b-tree node and version-tree node
is framed the same way::

    magic        u32 big-endian (manifest 0x0cdb3a2a, b-tree node
                 0x0cdb20de, version-tree node 0x0cdb1234)
    length       u64 little-endian, of the whole framed object
    version      varint, 0
    compression  varint, 0 none, 1 zstd
    body         the payload, a zstd frame when compressed
    crc32c       u32 little-endian, CRC-32C of every byte before it

Nodes sit at (offset, length) inside a data file; values longer than the
config's ``max_inline_value_bytes`` sit there too, shorter ones inline in
their b-tree leaf.  Arrays in a body are stored column by column: all
entries' first field, then all entries' second field, and so on.  The
manifest body is the config (uuid, manifest kind, inline limit, node
limit, version-tree arity, compression), a data-file table, the newest
versions inline and references to version-tree nodes holding older ones.

orbax 0.11.32 writes two stores: each process's values and b-tree under
``ocdbt.process_0/``, and a top-level store whose leaf refers to the same
values through the data-file table's base path ``ocdbt.process_0/``.
Restoring reads the top-level store.  ``write_store`` writes that
layout; ``read_store`` reads the newest version of any store, inline or
indirect values, leaf or interior b-tree nodes, and the version tree.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time
from typing import Dict, List, Optional, Tuple

from . import zstd
from .crc32c import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
FORMAT_VERSION = 0
COMPRESSION_NONE, COMPRESSION_ZSTD = 0, 1
# an absent reference (the root of an empty tree)
MISSING = (1 << 64) - 1

# orbax 0.11.32's config
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
PROCESS_DIR = "ocdbt.process_0"


class OcdbtError(ValueError):
    """A malformed or unsupported OCDBT store."""


@dataclasses.dataclass
class Config:
    uuid: bytes
    max_inline_value_bytes: int = MAX_INLINE_VALUE_BYTES
    max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES
    version_tree_arity_log2: int = VERSION_TREE_ARITY_LOG2
    compression: Optional[str] = "zstd"
    zstd_level: int = 0


@dataclasses.dataclass
class Ref:
    """A framed object or value at [offset, offset + length) of data file
    ``file`` (its base path and relative path)."""
    file: Tuple[str, str]
    offset: int
    length: int

    @property
    def missing(self) -> bool:
        return self.offset == MISSING and self.length == MISSING


@dataclasses.dataclass
class Version:
    generation: int
    root: Ref
    root_height: int
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int


@dataclasses.dataclass
class VersionNodeRef:
    generation: int
    ref: Ref
    num_generations: int
    commit_time: int
    height: int


@dataclasses.dataclass
class Manifest:
    config: Config
    versions: List[Version]
    version_nodes: List[VersionNodeRef]


# ---------------------------------------------------------------- reading

class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def _need(self, n: int):
        if self.pos + n > len(self.buf):
            raise OcdbtError(f"truncated {self.what}")

    def varint(self) -> int:
        v = shift = 0
        while True:
            self._need(1)
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OcdbtError(f"varint too long in {self.what}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.buf[self.pos - 1]

    def u64s(self, n: int) -> List[int]:
        self._need(8 * n)
        out = list(struct.unpack_from(f"<{n}Q", self.buf, self.pos))
        self.pos += 8 * n
        return out

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def done(self):
        if self.pos != len(self.buf):
            raise OcdbtError(f"{len(self.buf) - self.pos} stray bytes after "
                             f"the {self.what}")


def unframe(buf: bytes, magic: int, what: str) -> bytes:
    """The body of a framed object, its magic, length, version and CRC-32C
    checked and its compression undone."""
    if len(buf) < 18:
        raise OcdbtError(f"truncated {what}")
    got = int.from_bytes(buf[:4], "big")
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(buf[4:12], "little")
    if length != len(buf):
        raise OcdbtError(f"{what}: length field {length}, object is "
                         f"{len(buf)} bytes")
    want = int.from_bytes(buf[-4:], "little")
    if crc32c(buf[:-4]) != want:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(buf[:-4], what)
    r.pos = 12
    if r.varint() != FORMAT_VERSION:
        raise OcdbtError(f"{what}: unknown format version")
    comp = r.varint()
    body = buf[r.pos:-4]
    if comp == COMPRESSION_ZSTD:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from None
    if comp != COMPRESSION_NONE:
        raise OcdbtError(f"{what}: unknown compression {comp}")
    return body


def _read_config(r: _Reader) -> Config:
    uuid = r.take(16)
    kind = r.varint()
    if kind != 0:
        raise OcdbtError("numbered manifests are not supported")
    cfg = Config(uuid=uuid, max_inline_value_bytes=r.varint(),
                 max_decoded_node_bytes=r.varint(),
                 version_tree_arity_log2=r.u8())
    method = r.varint()
    if method == COMPRESSION_ZSTD:
        cfg.zstd_level = struct.unpack("<i", r.take(4))[0]
    elif method == COMPRESSION_NONE:
        cfg.compression = None
    else:
        raise OcdbtError(f"unknown compression method {method}")
    return cfg


def _read_files(r: _Reader) -> List[Tuple[str, str]]:
    """A data-file table: each path prefix-coded against the previous one,
    the first ``base_length`` bytes of a path its base path."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise OcdbtError("data-file path prefix longer than the previous "
                             "path")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(path):
            raise OcdbtError("data-file base path longer than the path")
        files.append((path[:base[i]].decode(), path[base[i]:].decode()))
        prev = path
    return files


def _read_refs(r: _Reader, n: int, files) -> List[Ref]:
    ids = r.varints(n)
    offsets = r.varints(n)
    lengths = r.varints(n)
    if any(i >= len(files) for i in ids):
        raise OcdbtError("data-file id outside the table")
    return [Ref(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _read_versions(r: _Reader, files) -> List[Version]:
    n = r.varint()
    gens = r.varints(n)
    heights = [r.u8() for _ in range(n)]
    roots = _read_refs(r, n, files)
    keys, tree, indirect = r.varints(n), r.varints(n), r.varints(n)
    times = r.u64s(n)
    return [Version(*v) for v in zip(gens, roots, heights, keys, tree,
                                     indirect, times)]


def _read_version_nodes(r: _Reader, files, height: Optional[int] = None):
    """References to version-tree nodes: the manifest stores each one's
    height, an interior node's children are all one level down."""
    n = r.varint()
    gens = r.varints(n)
    refs = _read_refs(r, n, files)
    counts = r.varints(n)
    times = r.u64s(n)
    heights = ([r.u8() for _ in range(n)] if height is None
               else [height] * n)
    return [VersionNodeRef(*v) for v in zip(gens, refs, counts, times,
                                            heights)]


def _safe_path(root: str, rel: str) -> str:
    path = os.path.normpath(os.path.join(root, rel))
    if os.path.commonpath([os.path.abspath(root),
                           os.path.abspath(path)]) != os.path.abspath(root):
        raise OcdbtError(f"data file {rel!r} lies outside the store")
    return path


class Store:
    """An OCDBT store on disk, read-only."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
            body = unframe(f.read(), MANIFEST_MAGIC, "manifest")
        r = _Reader(body, "manifest")
        config = _read_config(r)
        files = _read_files(r)
        versions = _read_versions(r, files)
        nodes = _read_version_nodes(r, files)
        r.done()
        self.manifest = Manifest(config, versions, nodes)

    def read(self, ref: Ref) -> bytes:
        if ref.missing:
            raise OcdbtError("read of an absent reference")
        path = _safe_path(self.root, ref.file[0] + ref.file[1])
        with open(path, "rb") as f:
            f.seek(ref.offset)
            buf = f.read(ref.length)
        if len(buf) != ref.length:
            raise OcdbtError(f"data file {ref.file[1]} ends before "
                             f"{ref.offset} + {ref.length}")
        return buf

    def _node(self, ref: Ref, magic: int, what: str) -> _Reader:
        body = unframe(self.read(ref), magic, what)
        if len(body) > self.manifest.config.max_decoded_node_bytes:
            raise OcdbtError(f"{what} above max_decoded_node_bytes")
        return _Reader(body, what)

    def versions(self) -> List[Version]:
        """Every version, from the version-tree nodes and the manifest."""
        out: List[Version] = []

        def walk(node: VersionNodeRef):
            r = self._node(node.ref, VERSION_MAGIC, "version-tree node")
            r.u8()  # arity log2
            height = r.u8()
            if height != node.height:
                raise OcdbtError("version-tree node height mismatch")
            files = _read_files(r)
            if height == 0:
                out.extend(_read_versions(r, files))
                r.done()
                return
            children = _read_version_nodes(r, files, height - 1)
            r.done()
            for child in children:
                walk(child)

        for node in self.manifest.version_nodes:
            walk(node)
        out.extend(self.manifest.versions)
        return sorted(out, key=lambda v: v.generation)

    def latest(self) -> Version:
        """The newest version, which a manifest always holds inline."""
        if not self.manifest.versions:
            raise OcdbtError("the manifest holds no version")
        return max(self.manifest.versions, key=lambda v: v.generation)

    def items(self, version: Optional[Version] = None) -> Dict[bytes, bytes]:
        """{key: value} of ``version`` (default: the newest)."""
        v = version or self.latest()
        out: Dict[bytes, bytes] = {}
        if not v.root.missing:
            self._walk(v.root, v.root_height, b"", out)
        return out

    def _walk(self, ref: Ref, height: int, prefix: bytes, out):
        r = self._node(ref, BTREE_MAGIC, "b-tree node")
        if r.u8() != height:
            raise OcdbtError("b-tree node height mismatch")
        files = _read_files(r)
        n = r.varint()
        shared = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                raise OcdbtError("b-tree key prefix longer than the previous "
                                 "key")
            prev = prev[:shared[i]] + r.take(suffix[i])
            keys.append(prev)
        if height:
            children = _read_refs(r, n, files)
            r.varints(3 * n)  # statistics
            r.done()
            for key, c, child in zip(keys, common, children):
                if c > len(key):
                    raise OcdbtError("subtree prefix longer than its key")
                self._walk(child, height - 1, prefix + key[:c], out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise OcdbtError("unknown value kind")
        n_ind = sum(kinds)
        ids, offsets = r.varints(n_ind), r.varints(n_ind)
        if any(i >= len(files) for i in ids):
            raise OcdbtError("data-file id outside the table")
        j = 0
        for key, length, kind in zip(keys, lengths, kinds):
            if kind:
                out[prefix + key] = self.read(
                    Ref(files[ids[j]], offsets[j], length))
                j += 1
            else:
                out[prefix + key] = r.take(length)
        r.done()


def read_store(root: str) -> Dict[bytes, bytes]:
    """{key: value} of the newest version of the store under ``root``."""
    return Store(root).items()


# ---------------------------------------------------------------- writing

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vals) -> bytes:
    return b"".join(_varint(v) for v in vals)


def frame(body: bytes, magic: int) -> bytes:
    """``body`` framed as a zstd-declared object (raw zstd blocks)."""
    payload = (_varint(FORMAT_VERSION) + _varint(COMPRESSION_ZSTD)
               + zstd.compress_raw(body))
    head = magic.to_bytes(4, "big") + (12 + len(payload) + 4).to_bytes(
        8, "little")
    obj = head + payload
    return obj + crc32c(obj).to_bytes(4, "little")


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _files(files: List[Tuple[str, str]]) -> bytes:
    paths = [(b + r).encode() for b, r in files]
    prefix = [_common(paths[i - 1], paths[i]) for i in range(1, len(paths))]
    shared = [0] + prefix
    return (_varint(len(paths)) + _varints(prefix)
            + _varints(len(p) - s for p, s in zip(paths, shared))
            + _varints(len(b.encode()) for b, _ in files)
            + b"".join(p[s:] for p, s in zip(paths, shared)))


def _config(cfg: Config) -> bytes:
    """A single-manifest, zstd config (the only one written)."""
    return (cfg.uuid + _varint(0) + _varint(cfg.max_inline_value_bytes)
            + _varint(cfg.max_decoded_node_bytes)
            + bytes([cfg.version_tree_arity_log2]) + _varint(COMPRESSION_ZSTD)
            + struct.pack("<i", cfg.zstd_level))


def _leaf(keys: List[bytes], values: List[bytes], indirect: Dict[int, int],
          file: Optional[Tuple[str, str]]) -> bytes:
    """A b-tree leaf; ``indirect`` maps an entry to its value's offset in
    ``file``."""
    shared = [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    starts = [0] + shared
    ind = sorted(indirect)
    return b"".join([
        bytes([0]), _files([file] if file else []), _varint(len(keys)),
        _varints(shared), _varints(len(k) - s for k, s in zip(keys, starts)),
        b"".join(k[s:] for k, s in zip(keys, starts)),
        _varints(len(v) for v in values),
        _varints(int(i in indirect) for i in range(len(keys))),
        _varints(0 for _ in ind), _varints(indirect[i] for i in ind),
        b"".join(v for i, v in enumerate(values) if i not in indirect)])


def _manifest(cfg: Config, files, version: Version) -> bytes:
    v, root = version, version.root
    body = b"".join([
        _config(cfg), _files(files), _varint(1), _varint(v.generation),
        bytes([v.root_height]), _varint(files.index(root.file)),
        _varint(root.offset), _varint(root.length), _varint(v.num_keys),
        _varint(v.num_tree_bytes), _varint(v.num_indirect_value_bytes),
        struct.pack("<Q", v.commit_time), _varint(0)])
    return frame(body, MANIFEST_MAGIC)


def _write(path: str, *parts: bytes):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        for part in parts:
            f.write(part)


def _data_name() -> str:
    return "d/" + os.urandom(16).hex()


def _write_tree(root: str, cfg: Config, keys, values, indirect,
                value_file, num_indirect: int, base: str = ""):
    """One leaf (its indirect values in ``value_file``, seen from this
    store under base path ``base``) in a new data file of ``root``, and
    the manifest of the one version that holds it."""
    now = time.time_ns()
    if not keys:
        files = [("", "")]
        root_ref = Ref(files[0], MISSING, MISSING)
        tree_bytes = 0
    else:
        node = frame(_leaf(keys, values, indirect,
                           (base, value_file) if indirect else None),
                     BTREE_MAGIC)
        name = _data_name()
        _write(os.path.join(root, name), node)
        files = [("", name)]
        root_ref = Ref(files[0], 0, len(node))
        tree_bytes = len(node)
    version = Version(1, root_ref, 0, len(keys), tree_bytes, num_indirect,
                      now)
    _write(os.path.join(root, "manifest.ocdbt"),
           _manifest(cfg, files, version))


def write_store(root: str, items: Dict[bytes, bytes]) -> None:
    """Write ``items`` under ``root`` (which must not hold a store yet) as
    orbax lays out one process's checkpoint: the values and a b-tree of
    one version in a store of their own under ``root/PROCESS_DIR``, and a
    top-level store whose leaf refers to the same values there.  Values
    longer than the config's inline limit go, in key order, into one data
    file.  The config is orbax's."""
    cfg = Config(uuid=os.urandom(16))
    keys = sorted(items)
    values = [bytes(items[k]) for k in keys]
    indirect: Dict[int, int] = {}
    blobs, offset = [], 0
    for i, v in enumerate(values):
        if len(v) > cfg.max_inline_value_bytes:
            indirect[i] = offset
            blobs.append(v)
            offset += len(v)
    leaf_bytes = sum(len(k) + 12 for k in keys) + sum(
        len(v) for i, v in enumerate(values) if i not in indirect)
    if leaf_bytes > cfg.max_decoded_node_bytes:
        raise OcdbtError("the items need more than one b-tree leaf; only "
                         "single-leaf stores are written")
    store = os.path.join(root, PROCESS_DIR)
    value_file = _data_name() if blobs else None
    if blobs:
        _write(os.path.join(store, value_file), *blobs)
    _write_tree(store, dataclasses.replace(cfg, uuid=os.urandom(16)),
                keys, values, indirect, value_file, offset)
    _write_tree(root, cfg, keys, values, indirect, value_file, offset,
                base=PROCESS_DIR + "/")
