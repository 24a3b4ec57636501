"""The program's own ranges in a traced window.

The port opens ``srt.*`` ranges (``torch.profiler.record_function``) at
its layer boundaries while a profiler records
(``subspace_reg_tpu_torch/utils/spans.py``).  Kineto files them among the
host records of a ``harness.Trace``, on the clock of the device's records,
so the readers of the per-layer metrics divide by them what the trace
holds: the device's idle time, and the host's kernel launches.  Each
function returns None where the trace holds no range of the names asked
for (a program without them), never 0.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple

# the host records of a kernel launch: cudaLaunch* (runtime API) and
# cuLaunch* (the lower-level API)
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


def ranges(trace, names: Iterable[str]) -> List[Tuple[int, int]]:
    """(start, end) of the trace's host records named one of ``names``."""
    names = set(names)
    return [(a, b) for n, a, b in trace.host if n in names]


def _union(spans) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def idle_intervals(trace) -> List[Tuple[int, int]]:
    """The stretches of the trace's span with nothing on the device."""
    lo, hi = trace.span
    out, t = [], lo
    for a, b in trace.busy_intervals():
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def idle_in_s(trace, names: Iterable[str]) -> Optional[float]:
    """Seconds of device-idle time that fall inside a range named one of
    ``names`` (nested ranges counted once)."""
    spans = _union(ranges(trace, names))
    if not spans:
        return None
    tot, i = 0, 0
    for a, b in idle_intervals(trace):
        while i < len(spans) and spans[i][1] <= a:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < b:
            tot += min(b, spans[j][1]) - max(a, spans[j][0])
            j += 1
    return tot * 1e-9


def launches_in(trace, names: Iterable[str]) -> Optional[int]:
    """Host records of kernel launches that start inside a range named one
    of ``names``, from any thread (the autograd engine launches the
    backward's kernels from its own)."""
    spans = _union(ranges(trace, names))
    if not spans:
        return None
    starts = sorted(a for n, a, _ in trace.host
                    if n.startswith(LAUNCH_PREFIXES))
    return sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
               for a, b in spans)


def launches_per_step(rec, names: Iterable[str]) -> Optional[float]:
    """Launches inside the ranges ``names`` over the steps, a step being
    one ``srt.pretrain.optimizer`` range, in the first of the records'
    traces that holds the host's operations."""
    trace = next((t for t in rec.get("traces") or []
                  if t.host_window_s is None and t.device), None)
    if trace is None:
        return None
    steps = len(ranges(trace, ("srt.pretrain.optimizer",)))
    n = launches_in(trace, names)
    if not steps or n is None:
        return None
    return n / steps
