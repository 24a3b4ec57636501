"""pretrain.device_idle_pct: the share of the profiled steps' span in
which nothing ran on the device, 100 minus the union of the device
records' intervals over the span."""


def read(rec):
    traces = rec.get("traces") or []
    if not traces or not traces[0].device or rec.get("steps_traced", 0) <= 0:
        return None
    t = traces[0]
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
