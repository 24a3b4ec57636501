"""zstd frames without a zstd library: the reader and writer of the frames
inside orbax directory checkpoints (utils/ocdbt.py, utils/zarr2.py).

``decompress`` calls the hand-written decoder ``csrc/zstd_decode.cpp``
(RFC 8878: every block and table type, repeat offsets, skippable and
concatenated frames, the XXH64 content checksum), built with ``g++`` into
``subspace_reg_tpu_torch/_build/`` at first use and bound with ``ctypes``.
A failed build raises; there is no decoder in Python.  Malformed input
raises ``ZstdError``.

``compress_raw`` writes a valid zstd frame of raw (stored) blocks: no
compression, but any zstd reader takes it, so a store that declares zstd
(as orbax's does) stays what it declares.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Optional

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
# window descriptor of 128 KiB (exponent 7, mantissa 0): every raw block
# fits it, whatever the content's size
_WINDOW_128K = 7 << 3

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class ZstdError(ValueError):
    """Malformed or unsupported zstd input."""


def get_lib() -> ctypes.CDLL:
    """The decoder library, built first if needed; raises if the build
    fails."""
    global _lib
    with _lock:
        if _lib is None:
            from . import cuda_build
            lib = cuda_build.load("zstd_decode")
            lib.zstd_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
                ctypes.c_size_t]
            lib.zstd_decompress.restype = ctypes.c_int
            lib.zstd_free.argtypes = [ctypes.c_void_p]
            lib.zstd_free.restype = None
            _lib = lib
        return _lib


def decompress(data) -> bytes:
    """Every frame of ``data`` (bytes-like) decoded and concatenated."""
    lib = get_lib()
    src = bytes(data)
    out = ctypes.c_void_p()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(512)
    if lib.zstd_decompress(src, len(src), ctypes.byref(out), ctypes.byref(n),
                           err, len(err)):
        raise ZstdError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(out.value, n.value) if n.value else b""
    finally:
        lib.zstd_free(out)


def compress_raw(data) -> bytes:
    """One zstd frame holding ``data`` in raw blocks of at most 128 KiB,
    with its content size and a 128 KiB window."""
    view = memoryview(data).cast("B")
    n = len(view)
    fcs = 2 if n < 1 << 32 else 3  # 4- or 8-byte content size
    parts = [struct.pack("<IBB", MAGIC, fcs << 6, _WINDOW_128K),
             n.to_bytes(1 << fcs, "little")]
    for start in range(0, max(n, 1), BLOCK_MAX):
        size = min(BLOCK_MAX, n - start)
        last = start + BLOCK_MAX >= n
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))
        parts.append(view[start:start + size])
    return b"".join(parts)
