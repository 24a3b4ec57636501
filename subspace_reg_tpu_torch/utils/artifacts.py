"""Analysis artifacts: the aggregate over seeds, the simple classifiers,
the prediction dumps and the image formatter.  The port's copy of the JAX
package's ``utils/artifacts.py`` (reference eval/util.py and the
observability paths of language_eval.py), without PIL or pandas: the PNG
is written with ``zlib`` and ``struct``, and the CSV with ``csv``."""

from __future__ import annotations

import base64
import struct
import zlib
from typing import Dict, List, Sequence

import numpy as np


def mean_confidence_interval(data, confidence: float = 0.95):
    """(mean, half-width of the ``confidence`` interval) of ``data`` under
    Student's t: reference eval/util.py:42-47, which is broken there (an
    undefined ``t._ppf``); this is the working version via scipy.stats.t."""
    import scipy.stats
    a = 1.0 * np.array(data)
    n = len(a)
    m, se = np.mean(a), scipy.stats.sem(a)
    h = se * scipy.stats.t.ppf((1 + confidence) / 2.0, n - 1)
    return m, h


def normalize_rows(x: np.ndarray) -> np.ndarray:
    """Reference eval/util.py:49-51."""
    norm = np.power(np.power(x, 2).sum(1, keepdims=True), 0.5)
    return x / norm


def nn_classifier(support: np.ndarray, support_ys, query: np.ndarray):
    """Nearest-neighbour classifier (reference eval/util.py:71-79)."""
    support = np.expand_dims(support.transpose(), 0)
    query = np.expand_dims(query, 2)
    diff = np.multiply(query - support, query - support)
    distance = diff.sum(1)
    min_idx = np.argmin(distance, axis=1)
    return [support_ys[idx] for idx in min_idx]


def cosine_classifier(support: np.ndarray, support_ys, query: np.ndarray):
    """Cosine classifier (reference eval/util.py:81-90)."""
    support = support / np.linalg.norm(support, axis=1, keepdims=True)
    query = query / np.linalg.norm(query, axis=1, keepdims=True)
    cosine_distance = query @ support.transpose()
    max_idx = np.argmax(cosine_distance, axis=1)
    return [support_ys[idx] for idx in max_idx]


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(im: np.ndarray) -> bytes:
    """An 8-bit PNG of a uint8 (H, W, 3) image (RGB) or (H, W) image
    (grayscale): filter 0 on every row, one IDAT chunk."""
    h, w = im.shape[:2]
    color = 2 if im.ndim == 3 else 0
    rows = np.ascontiguousarray(im, np.uint8).reshape(h, -1)
    raw = b"".join(b"\x00" + row.tobytes() for row in rows)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw))
            + _png_chunk(b"IEND", b""))


def image_formatter(im: np.ndarray) -> str:
    """Base64 <img> HTML for dataframe visualization
    (reference eval/util.py:53-60).  Accepts CHW or HWC arrays; each
    channel is scaled by its maximum to 0..255 and cast to uint8, as the
    JAX package does before PIL writes the PNG."""
    if im.shape[0] in (1, 3) and im.ndim == 3 and im.shape[0] < im.shape[-1]:
        im = im.transpose((1, 2, 0))
    im = ((im / np.max(im, axis=(0, 1), keepdims=True)) * 255).astype("uint8")
    decoded = base64.b64encode(png_bytes(im)).decode()
    return f'<img src="data:image/jpeg;base64,{decoded}">'


def map2original(ls: Sequence, dictlist: Sequence[Dict]) -> List[List]:
    """Map session-local ids back to original dataset labels
    (reference language_eval.py:457-472; its assert at :466 is inverted —
    this version checks uniqueness correctly)."""
    combined: Dict = {}
    for d in dictlist:
        for k, v in d.items():
            if k in combined:
                raise ValueError(f"duplicate key {k}")
            combined[k] = v
    values = list(combined.values())
    assert len(np.unique(values)) == len(values), "mapping is not injective"
    rlist = []
    for l0 in ls:
        if not isinstance(l0, list):
            l0 = np.asarray(l0).tolist()
        rlist.append([combined[el] for el in l0])
    return rlist


def new_prediction_rows() -> Dict[str, list]:
    """Empty accumulator in the reference's prediction-dump schema."""
    return {k: [] for k in ("Episode", "Gold", "Prediction",
                            "Original_Gold", "Original_Prediction")}


def accumulate_prediction_rows(preds_rows: Dict[str, list], idx: int,
                               q_pred, q_gold, b_pred, b_gold,
                               id2orig: Dict, basec_map_rev: Dict) -> None:
    """Append one session's prediction rows (reference
    language_eval.py:407-438): session-0 query preds + base preds, both in
    session-local ids and mapped back to original dataset labels (-1 rows
    when an id has no original label)."""
    maps = [id2orig, basec_map_rev] if basec_map_rev else [id2orig]
    try:
        (qp_o, qg_o), (bp_o, bg_o) = (
            map2original([q_pred, q_gold], maps),
            map2original([b_pred, b_gold], maps))
    except KeyError:
        qp_o = qg_o = bp_o = bg_o = None
    n_rows = len(q_gold) + len(b_gold)
    preds_rows["Episode"] += [idx] * n_rows
    preds_rows["Gold"] += list(q_gold) + list(b_gold)
    preds_rows["Prediction"] += list(q_pred) + list(b_pred)
    if qp_o is not None:
        preds_rows["Original_Gold"] += list(qg_o) + list(bg_o)
        preds_rows["Original_Prediction"] += list(qp_o) + list(bp_o)
    else:
        preds_rows["Original_Gold"] += [-1] * n_rows
        preds_rows["Original_Prediction"] += [-1] * n_rows


def predictions_csv_name(opt) -> str:
    """The reference's prediction-dump filename (language_eval.py:436)."""
    return (f"csv_files_mem/seed_{opt.set_seed}_{opt.dataset}_"
            f"{opt.n_shots}_{opt.label_pull}_{opt.attraction_override}"
            f"_continual_{opt.continual}_mem_{opt.memory_replay}"
            f"_predictions.csv")


def save_predictions_csv(path: str, rows: Dict[str, np.ndarray]) -> None:
    """Prediction dump in the reference's schema
    (language_eval.py:429-438): Episode, Gold, Prediction, Original_Gold,
    Original_Prediction."""
    import csv
    keys = list(rows.keys())
    n = len(rows[keys[0]])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(keys)
        for i in range(n):
            w.writerow([rows[k][i] for k in keys])
