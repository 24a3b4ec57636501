"""eval.sampler_idle_ms_per_seed: the device's idle time inside the
program's ``srt.data.sampler`` ranges (``EpisodeSampler``'s
construction, two a run), over the traced runs, in ms.  Nothing to read
where the program opens no such range."""

from benchmark import spans

NAMES = ("srt.data.sampler",)


def read(rec):
    traces = rec.get("traces") or []
    runs = rec.get("runs", 0)
    if not traces or not traces[0].device or runs <= 0:
        return None
    s = spans.idle_in_s(traces[0], NAMES)
    return None if s is None else 1e3 * s / runs
