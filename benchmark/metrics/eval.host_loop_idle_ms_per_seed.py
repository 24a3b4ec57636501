"""eval.host_loop_idle_ms_per_seed: the device's idle time inside the
engine's host loop, the program's ``srt.eval.setup`` (``SeedRun``'s
construction, with the uploads and the initial base evaluation),
``srt.eval.begin`` (a session's inputs) and ``srt.eval.finish`` (the
memory update and the pull of the metrics) ranges, over the traced
runs, in ms.  Nothing to read where the program opens no such range."""

from benchmark import spans

NAMES = ("srt.eval.setup", "srt.eval.begin", "srt.eval.finish")


def read(rec):
    traces = rec.get("traces") or []
    runs = rec.get("runs", 0)
    if not traces or not traces[0].device or runs <= 0:
        return None
    s = spans.idle_in_s(traces[0], NAMES)
    return None if s is None else 1e3 * s / runs
