"""msgpack with flax's extensions, in plain Python.

The JAX package's ``.ckpt`` checkpoints hold a tree packed by
``flax.serialization.msgpack_serialize`` (flax 0.12).  The port reads and
writes them without flax or the ``msgpack`` package, so this module is a
small msgpack encoder and decoder with flax's three extension types:

* ext 1, an array: the msgpack array ``(shape, dtype name, C-order
  bytes)``, itself packed with bin types;
* ext 2, a Python complex: the msgpack array ``(real, imag)``;
* ext 3, a numpy scalar: packed as a 0-d array, restored as the scalar.

Leaves larger than ``MAX_CHUNK_SIZE`` bytes go into flax's chunked form
``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
{"0": ...}}``.  ``msgpack_serialize`` copies the tree as flax's
``jax.tree_util.tree_map`` copy does, which orders every dict by key;
integers take msgpack's smallest encoding and floats are float64, so for
the same tree the bytes equal flax's.

Leaves may be numpy arrays or torch tensors.  A ``bfloat16`` leaf (a torch
tensor, or a numpy array of a bfloat16 extension dtype) is written under
the dtype name ``bfloat16``; the decoder returns it as a torch bfloat16
tensor through a ``uint16`` view, every other array as a numpy array.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------
def _pack_int(n: int, out: List[bytes]) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(struct.pack("B", n))
        elif n <= 0xFF:
            out.append(struct.pack(">BB", 0xCC, n))
        elif n <= 0xFFFF:
            out.append(struct.pack(">BH", 0xCD, n))
        elif n <= 0xFFFFFFFF:
            out.append(struct.pack(">BI", 0xCE, n))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(struct.pack(">BQ", 0xCF, n))
        else:
            raise OverflowError(f"integer {n} does not fit msgpack")
    elif n >= -32:
        out.append(struct.pack("b", n))
    elif n >= -0x80:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif n >= -0x8000:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif n >= -0x80000000:
        out.append(struct.pack(">Bi", 0xD2, n))
    elif n >= -0x8000000000000000:
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple, out) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32
    bit forms in ``codes`` (``None`` where the type has no such form)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, limit in zip(codes, ("B", "H", "I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    if n in _FIXEXT_CODE:
        out.append(struct.pack(">Bb", _FIXEXT_CODE[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _array_parts(x) -> Tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return (tuple(x.shape), "bfloat16",
                    x.view(torch.int16).numpy().tobytes())
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    return tuple(x.shape), x.dtype.name, x.tobytes("C")


def _ndarray_bytes(x) -> bytes:
    shape, name, buf = _array_parts(x)
    out: List[bytes] = []
    _pack(list(shape), out)
    _pack(name, out)
    _pack(buf, out)
    # the (shape, name, bytes) triple is itself a msgpack array
    return b"".join([struct.pack("B", 0x93)] + out)


def _pack(obj: Any, out: List[bytes]) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif t is list:
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif t is complex:
        inner: List[bytes] = [b"\x92"]
        _pack(obj.real, inner)
        _pack(obj.imag, inner)
        _pack_ext(EXT_COMPLEX, b"".join(inner), out)
    else:
        # flax packs with strict types: tuples and subclasses of the
        # primitive types are refused too
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's ``_chunk``: a flat array cut into MAX_CHUNK_SIZE pieces."""
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in
                       enumerate(range(0, n, size))}}


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _copy_sorted(tree):
    """The tree copy of flax's ``tree_map(lambda x: x, ...)``: every dict
    rebuilt in key order, lists and tuples kept, leaves shared."""
    if isinstance(tree, dict):
        return {k: _copy_sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_copy_sorted(v) for v in tree)
    return tree


def _chunk_leaves(d):
    """flax's ``_chunk_array_leaves_in_place`` (dict values and a bare
    array leaf; lists are not searched)."""
    if isinstance(d, dict):
        for k, v in d.items():
            if _is_array(v):
                if _nbytes(v) > MAX_CHUNK_SIZE:
                    d[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_leaves(v)
    elif _is_array(d) and _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def msgpack_serialize(pytree) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(pytree)``."""
    out: List[bytes] = []
    _pack(_chunk_leaves(_copy_sorted(pytree)), out)
    return b"".join(out)


# --------------------------------------------------------------------------
# decoder
# --------------------------------------------------------------------------
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# the length field of bin 8/16/32, ext 8/16/32, str 8/16/32, array 16/32
# and map 16/32
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H",
            0xC9: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
            0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_FIXEXT_CODE = {n: b for b, n in _FIXEXT.items()}


class _Reader:
    def __init__(self, data: bytes, raw: bool, ext_hook):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def string(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return self.ext_hook(code, bytes(self.take(n)))

    def read(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _LENGTHS:
            n = self.unpack(_LENGTHS[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.string(n)
            if b <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map(n)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unpackb(data: bytes, raw: bool = False, ext_hook=None):
    r = _Reader(data, raw, ext_hook or (lambda code, d: (code, d)))
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError("extra bytes after the msgpack object")
    return obj


def _ndarray_from_bytes(data: bytes):
    shape, name, buf = _unpackb(data, raw=True)
    if name == b"bfloat16":
        a = np.frombuffer(buf, np.uint16).reshape(shape, order="C")
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name.decode()), count=-1,
                         offset=0).reshape(shape, order="C")


def _ext_unpack(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_COMPLEX:
        re, im = _unpackb(data)
        return complex(re, im)
    if code == EXT_NPSCALAR:
        a = _ndarray_from_bytes(data)
        return a[()] if isinstance(a, np.ndarray) else a
    raise ValueError(f"unknown msgpack extension type {code}")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d):
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_leaves(v)
    return d


def msgpack_restore(encoded: bytes):
    """The tree of ``flax.serialization.msgpack_restore(encoded)``: numpy
    array leaves (read-only views of ``encoded``'s copy), bfloat16 leaves
    as torch tensors."""
    return _unchunk_leaves(_unpackb(encoded, raw=False,
                                    ext_hook=_ext_unpack))
