"""zarr v2 arrays in a key-value store, as orbax writes each leaf of a
checkpoint into its OCDBT store (utils/ocdbt.py).

An array ``name`` is the key ``name/.zarray``, compact JSON with sorted
keys::

    {"chunks":[5,8],"compressor":{"id":"zstd","level":1},
     "dimension_separator":".","dtype":"<f4","fill_value":null,
     "filters":null,"order":"C","shape":[5,8],"zarr_format":2}

and its chunks ``name/0.0`` (``name/0`` for 1-d and 0-d arrays), each a
zstd frame of the chunk's bytes in C order.  orbax writes one chunk per
array; ``read_array`` also reads a grid of smaller chunks (edge chunks are
stored whole, as zarr stores them) and fills missing ones with zeros.
``encode_array`` writes one chunk, as a frame of raw zstd blocks
(utils/zstd.py::compress_raw) that still matches the declared compressor.

Dtypes are numpy's little-endian strings (``<f4``, ``<i4``, ``<i8``, ...)
and ``bfloat16``, which numpy lacks: such a leaf comes and goes as a torch
bfloat16 tensor, as in utils/msgpack_codec.py.
"""

from __future__ import annotations

import itertools
import json
from typing import Dict

import numpy as np
import torch

from . import zstd

COMPRESSOR = {"id": "zstd", "level": 1}


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.bfloat16:
            raise TypeError(f"torch leaf of {a.dtype}: pass numpy arrays "
                            "or bfloat16 tensors")
        return "bfloat16"
    return a.dtype.str


def _as_bytes(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous().view(torch.int16).numpy() \
            .tobytes()
    return np.ascontiguousarray(a).tobytes()


def zarray(shape, dtype: str) -> bytes:
    """The ``.zarray`` of a one-chunk array, as orbax writes it."""
    meta = {"chunks": list(shape), "compressor": COMPRESSOR,
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": list(shape),
            "zarr_format": 2}
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


def chunk_key(index, sep: str = ".") -> str:
    return sep.join(str(i) for i in index) if index else "0"


def encode_array(name: str, a) -> Dict[bytes, bytes]:
    """``{name/.zarray, name/<chunk>}`` of array ``a`` (numpy, or a torch
    bfloat16 tensor) in one chunk."""
    shape = tuple(a.shape)
    key = chunk_key((0,) * len(shape))
    return {f"{name}/.zarray".encode(): zarray(shape, _dtype_name(a)),
            f"{name}/{key}".encode(): zstd.compress_raw(_as_bytes(a))}


def _decode(name: str, meta: dict, raw: bytes) -> bytes:
    if meta.get("compressor") is None:
        return raw
    cid = meta["compressor"].get("id")
    if cid != "zstd":
        raise ValueError(f"{name}: compressor {cid!r} is not supported")
    return zstd.decompress(raw)


def read_array(items: Dict[bytes, bytes], name: str):
    """Array ``name`` of ``items`` as numpy (bfloat16: a torch tensor)."""
    meta = json.loads(items[f"{name}/.zarray".encode()])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: not a zarr v2 array")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters are not supported")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{name}: chunk shape {chunks} for shape {shape}")
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    out = np.zeros(shape, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    n_chunk = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for index in itertools.product(*grid):
        raw = items.get(f"{name}/{chunk_key(index, sep)}".encode())
        if raw is None:
            continue  # fill_value null: zeros
        data = _decode(name, meta, raw)
        if len(data) != n_chunk:
            raise ValueError(f"{name}: chunk {index} holds {len(data)} "
                             f"bytes, expected {n_chunk}")
        block = np.frombuffer(data, dtype).reshape(chunks, order=order)
        dst = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(index, chunks, shape))
        out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
    if dtype.byteorder == ">":
        out = out.astype(dtype.newbyteorder("<"))
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out
