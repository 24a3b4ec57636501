"""Aggregates over seeds: the port's copy of the JAX package's
``utils/artifacts.py::mean_confidence_interval`` (:14-22)."""

from __future__ import annotations

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
