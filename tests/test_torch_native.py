"""The port's host staging library (subspace_reg_tpu_torch/csrc/staging.cpp
through data/native.py) against numpy and against the JAX package's
data/native.py, on seeded uint8 stores: the gather is exact, at 1 and 8
threads and below the library's 4-row threading threshold; the
gather-normalize is bit-identical to the port's numpy version (both
multiply by f32 1/255 and 1/std) and within rtol 1e-6 / atol 1e-6 of the
JAX module (its library may contract the multiply-subtract into an FMA).
The port raises where the JAX module falls back to numpy: a failed build,
a store that is not C-contiguous."""

import numpy as np
import pytest

from subspace_reg_tpu.data import native as jax_native
from subspace_reg_tpu_torch.data import native
from subspace_reg_tpu_torch.utils import cuda_build

MEAN = (0.47, 0.45, 0.41)
STD = (0.28, 0.27, 0.29)


def _store(n=40, img=6, seed=0):
    r = np.random.RandomState(seed)
    return r.randint(0, 256, size=(n, img, img, 3)).astype(np.uint8)


@pytest.mark.parametrize("n_idx", [1, 3, 37])
@pytest.mark.parametrize("threads", [1, 8])
def test_gather_matches_numpy_and_jax(n_idx, threads):
    src = _store()
    idx = np.random.RandomState(n_idx).randint(0, len(src), n_idx)
    got = native.gather_u8(src, idx, n_threads=threads)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(
        got, native.gather_u8(src, idx, backend="numpy"))
    np.testing.assert_array_equal(
        got, jax_native.gather_u8(src, idx, n_threads=threads))
    # in place, e.g. into a pinned buffer
    out = np.zeros_like(got)
    assert native.gather_u8(src, idx, out=out, n_threads=threads) is out
    np.testing.assert_array_equal(out, src[idx])


@pytest.mark.parametrize("n_idx", [2, 29])
@pytest.mark.parametrize("threads", [1, 8])
def test_gather_normalize_matches_numpy_and_jax(n_idx, threads):
    src = _store(seed=1)
    idx = np.random.RandomState(n_idx).randint(0, len(src), n_idx)
    got = native.gather_normalize(src, idx, MEAN, STD, n_threads=threads)
    assert got.dtype == np.float32 and got.shape == (n_idx, 6, 6, 3)
    np.testing.assert_array_equal(
        got, native.gather_normalize(src, idx, MEAN, STD, backend="numpy"))
    np.testing.assert_allclose(
        got, jax_native.gather_normalize(src, idx, MEAN, STD,
                                         n_threads=threads),
        rtol=1e-6, atol=1e-6)
    ref = (src[idx].astype(np.float64) / 255 - MEAN) / STD
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_refusals():
    src = _store()
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_u8(src[:, ::2], [0, 1])
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_normalize(np.asfortranarray(src), [0], MEAN, STD)
    with pytest.raises(IndexError):
        native.gather_u8(src, [len(src)])
    with pytest.raises(ValueError, match="backend"):
        native.gather_u8(src, [0], backend="jax")
    with pytest.raises(ValueError, match="out must be"):
        native.gather_u8(src, [0, 1], out=np.zeros((3, 6, 6, 3), np.uint8))


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without g++ the library cannot be built, and the gather raises
    instead of falling back to numpy."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.gather_u8(_store(), [0, 1])
    # a compiler that fails: the build's error is raised with its log
    monkeypatch.setattr(cuda_build.shutil, "which",
                        lambda name: "/bin/false")
    with pytest.raises(RuntimeError, match="build failed"):
        native.gather_u8(_store(), [0, 1])
    # the numpy version runs when asked for by name
    np.testing.assert_array_equal(
        native.gather_u8(_store(), [3, 1], backend="numpy"),
        _store()[[3, 1]])


def test_library_is_named_by_its_source_and_flags(monkeypatch):
    path = cuda_build.library_path("staging")
    assert path.name.startswith("libstaging_") and path.suffix == ".so"
    monkeypatch.setattr(cuda_build, "GXX_FLAGS",
                        cuda_build.GXX_FLAGS + ("-g",))
    assert cuda_build.library_path("staging") != path
