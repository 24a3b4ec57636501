"""eval.device_idle_pct: the share of the traced window (whole runs) in
which nothing ran on the device."""


def read(rec):
    traces = rec.get("traces") or []
    if not traces or not traces[0].device or rec.get("runs", 0) <= 0:
        return None
    t = traces[0]
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
