"""pretrain.kernels_per_step: device kernels launched in the profiled
steps over the steps (copies and fills not counted)."""


def read(rec):
    traces = rec.get("traces") or []
    steps = rec.get("steps_traced", 0)
    if not traces or not traces[0].device or steps <= 0:
        return None
    return len(traces[0].kernels()) / steps
