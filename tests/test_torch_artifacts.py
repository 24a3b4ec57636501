"""The port's ``utils/artifacts.py`` against the JAX package's on the same
inputs: the label mapping, the prediction rows and the CSV's bytes, the
NN and cosine classifiers, row normalisation, and ``image_formatter``,
whose PNG the port writes without PIL (the bytes differ from PIL's; the
decoded pixels must not)."""

import base64
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from subspace_reg_tpu.utils import artifacts as jax_art
from subspace_reg_tpu_torch.utils import artifacts as art

TAG = '<img src="data:image/jpeg;base64,'


def pixels(tag: str) -> np.ndarray:
    assert tag.startswith(TAG) and tag.endswith('">')
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(
        tag[len(TAG):-2]))))


@pytest.mark.parametrize("shape,dtype", [
    ((3, 12, 10), np.float32),      # CHW, as the reference hands it
    ((12, 10, 3), np.float32),      # HWC
    ((16, 16, 3), np.uint8),        # the raw queries of the vis frames
    ((9, 7), np.float64),           # one channel: a grayscale PNG
], ids=["chw", "hwc", "hwc_uint8", "gray"])
def test_image_formatter_pixels_equal_jax(shape, dtype):
    r = np.random.RandomState(0)
    im = (r.rand(*shape) * 255).astype(dtype)
    got, want = art.image_formatter(im), jax_art.image_formatter(im)
    np.testing.assert_array_equal(pixels(got), pixels(want))
    raw = base64.b64decode(got[len(TAG):-2])
    assert raw[:8] == b"\x89PNG\r\n\x1a\n" and raw[12:16] == b"IHDR"


def test_classifiers_and_normalize_rows_equal_jax():
    r = np.random.RandomState(1)
    support, query = r.randn(15, 8), r.randn(9, 8)
    ys = list(r.randint(0, 5, 15))
    np.testing.assert_array_equal(art.normalize_rows(support),
                                  jax_art.normalize_rows(support))
    assert (art.nn_classifier(support, ys, query)
            == jax_art.nn_classifier(support, ys, query))
    assert (art.cosine_classifier(support, ys, query)
            == jax_art.cosine_classifier(support, ys, query))


def test_map2original_equals_jax():
    id2orig = {60: 7, 61: 21, 62: 37}
    base = {0: 100, 1: 101}
    ls = [np.array([60, 1, 62]), [0, 61]]
    assert (art.map2original(ls, [id2orig, base])
            == jax_art.map2original(ls, [id2orig, base]))
    for mod in (art, jax_art):
        with pytest.raises(ValueError, match="duplicate"):
            mod.map2original(ls, [id2orig, {60: 1}])
        with pytest.raises(AssertionError, match="injective"):
            mod.map2original(ls, [id2orig, {0: 7}])


@pytest.mark.parametrize("mapped", [True, False],
                         ids=["mapped", "unmapped_base"])
def test_prediction_rows_and_csv_bytes_equal_jax(tmp_path, mapped):
    """Two sessions' rows, then the CSV; without the base map the base ids
    have no original label and every row of the session gets -1."""
    id2orig = {60 + k: 70 + 3 * k for k in range(10)}
    basec = {k: 200 + k for k in range(60)} if mapped else {}
    rows = {}
    for name, mod in (("port", art), ("jax", jax_art)):
        rows[name] = mod.new_prediction_rows()
        rr = np.random.RandomState(3)
        for idx in range(2):
            q_gold = rr.randint(60, 65, 20).astype(np.int64)
            q_pred = rr.randint(0, 65 + 5 * idx, 20).astype(np.int64)
            b_gold = rr.randint(0, 60, 30).astype(np.int64)
            b_pred = rr.randint(0, 65 + 5 * idx, 30).astype(np.int64)
            mod.accumulate_prediction_rows(rows[name], idx, q_pred, q_gold,
                                           b_pred, b_gold, id2orig, basec)
        path = tmp_path / f"{name}.csv"
        mod.save_predictions_csv(str(path), {
            k: np.asarray(v) for k, v in rows[name].items()})
    assert rows["port"] == rows["jax"]
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())
    assert (-1 in rows["port"]["Original_Gold"]) == (not mapped)


def test_predictions_csv_name_equals_jax():
    opt = SimpleNamespace(set_seed=4, dataset="miniImageNet", n_shots=5,
                          label_pull=1.0,
                          attraction_override="distance2subspace",
                          continual=True, memory_replay=1)
    name = art.predictions_csv_name(opt)
    assert name == jax_art.predictions_csv_name(opt)
    assert os.path.dirname(name) == "csv_files_mem"


def test_mean_confidence_interval_equals_jax():
    data = [61.2, 60.4, 62.9, 59.8, 61.1]
    np.testing.assert_allclose(art.mean_confidence_interval(data),
                               jax_art.mean_confidence_interval(data))
