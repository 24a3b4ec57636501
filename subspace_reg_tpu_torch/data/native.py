"""ctypes bindings of the port's host staging library (csrc/staging.cpp).

Counterpart of the JAX package's ``data/native.py``: a parallel row gather
(``gather_u8``) and a gather + normalize (``gather_normalize``) over a
C-contiguous uint8 image store.  The library is built with ``g++`` into
``subspace_reg_tpu_torch/_build/`` at first use (utils/cuda_build.py).

Unlike the JAX module, nothing falls back to numpy behind the caller's
back: a failed build raises, and a source that is not C-contiguous is an
error.  ``backend="numpy"`` asks for the plain version by name (the tests
hold the library against it).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

BACKENDS = ("native", "numpy")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """The staging library, built first if needed; raises if the build
    fails."""
    global _lib
    with _lock:
        if _lib is None:
            from ..utils import cuda_build
            lib = cuda_build.load("staging")
            lib.staging_gather_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            lib.staging_gather_u8.restype = None
            lib.staging_gather_normalize.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.staging_gather_normalize.restype = None
            _lib = lib
        return _lib


def _check(src: np.ndarray, indices: np.ndarray, backend: str):
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if src.dtype != np.uint8:
        raise TypeError(f"the image store is {src.dtype}, not uint8")
    if not src.flags.c_contiguous:
        raise ValueError("the image store is not C-contiguous; pass "
                         "np.ascontiguousarray(src)")
    indices = np.ascontiguousarray(indices, np.int64)
    if indices.ndim != 1:
        raise ValueError("indices must be one-dimensional")
    if len(indices) and (indices.min() < 0 or indices.max() >= len(src)):
        raise IndexError(f"an index lies outside the store's {len(src)} "
                         "rows")
    return indices


# the bytes written per thread when the caller leaves the count to the
# library: the library starts its threads on every call, which costs more
# than one thread's copy of a training batch (64 x 84 x 84 x 3 B on the
# host of an H100 machine: 0.22 ms on one thread, 2.04 ms on eight;
# PERF.md §5, chip_smoke.py phase 15a)
_BYTES_PER_THREAD = 16 << 20


def _threads(n_threads: int, out_bytes: int) -> int:
    if n_threads > 0:
        return n_threads
    return max(1, min(8, os.cpu_count() or 1,
                      out_bytes // _BYTES_PER_THREAD))


def gather_u8(src: np.ndarray, indices, out: Optional[np.ndarray] = None,
              n_threads: int = 0, backend: str = "native") -> np.ndarray:
    """``out[i] = src[indices[i]]`` for a C-contiguous uint8 ``src`` of
    shape (N, ...); ``out`` (C-contiguous, (len(indices), ...) uint8) is
    written in place when given, e.g. a pinned host buffer.
    ``n_threads`` 0 takes one thread per 16 MiB written, up to 8."""
    indices = _check(src, indices, backend)
    shape = (len(indices),) + src.shape[1:]
    if out is None:
        out = np.empty(shape, np.uint8)
    elif (out.shape != shape or out.dtype != np.uint8
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous uint8 {shape} array")
    if backend == "numpy":
        np.take(src, indices, axis=0, out=out)
        return out
    get_lib().staging_gather_u8(
        src.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        len(indices), int(np.prod(src.shape[1:])),
        _threads(n_threads, out.nbytes))
    return out


def gather_normalize(src: np.ndarray, indices, mean, std,
                     n_threads: int = 0,
                     backend: str = "native") -> np.ndarray:
    """Gather + ``(x/255 - mean[c]) / std[c]`` in one pass, HWC layout with
    the channels trailing; f32 out.  The library multiplies by 1/255 and
    by 1/std in f32, and the numpy version computes the same way."""
    indices = _check(src, indices, backend)
    mean = np.ascontiguousarray(mean, np.float32)
    inv_std = np.ascontiguousarray(
        1.0 / np.asarray(std, np.float32), np.float32)
    channels = src.shape[-1]
    if mean.shape != (channels,) or inv_std.shape != (channels,):
        raise ValueError(f"mean and std need {channels} entries")
    if backend == "numpy":
        x = src[indices].astype(np.float32)
        return (x * np.float32(1.0 / 255.0) - mean) * inv_std
    out = np.empty((len(indices),) + src.shape[1:], np.float32)
    get_lib().staging_gather_normalize(
        src.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        len(indices), int(np.prod(src.shape[1:])),
        mean.ctypes.data_as(ctypes.c_void_p),
        inv_std.ctypes.data_as(ctypes.c_void_p), channels,
        _threads(n_threads, out.nbytes))
    return out
