"""Named host ranges of the port's layers, for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler is recording, so kineto puts it on the timeline of the device's
records, and one shared no-op context otherwise: the check costs a fraction
of a microsecond, the range itself ~14 us.  Nothing is kept here; run the
program under ``torch.profiler.profile`` to get the ranges (README.md).

Every name starts with ``srt.`` and holds no substring that a reader of
device records matches on (``conv``, ``fft``, ``finetune_loop``, ...).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else the
    shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
