"""eval.k1_roofline_pct: K1's least time over its device time in the
traced runs.  The least time of a launch is the larger of its operations
for the epochs it ran (after the first, which the engine runs) at the
f32 peak and its bytes (operands read once, outputs written once) at the
memory rate, for the classes and rows of its session (flops.py).

A traced window with device records but no K1 kernel is a fault of the
path (every session launches K1): the reader raises rather than let the
metric drop out of the line."""

from benchmark import flops
from benchmark.harness import BenchError

K1_MARKS = ("finetune_loop",)


def read(rec):
    traces = rec.get("traces") or []
    if not traces or not traces[0].device or rec.get("runs", 0) <= 0:
        return None
    t = traces[0].device_time_s(K1_MARKS)
    if t <= 0:
        raise BenchError("the traced evaluation window holds no K1 "
                         "(finetune_loop) kernel")
    bound = sum(flops.k1_bound_s(s, rec["peak_flops"]["f32"],
                                 rec["hbm_bytes_per_s"])
                for s in rec["sessions"])
    return 100.0 * bound / t
