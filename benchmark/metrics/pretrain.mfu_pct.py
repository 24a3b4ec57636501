"""pretrain.mfu_pct: the whole step's share of the card's peak: the
benchmark's count of a step's operations (forward + backward = 3 x the
forward, flops.py) times the profiled steps, over the profiled span, over
the peak of the configuration's training precision."""

from benchmark import flops


def read(rec):
    traces = rec.get("traces") or []
    steps = rec.get("steps_traced", 0)
    if not traces or not traces[0].device or steps <= 0:
        return None
    bsz, n_cls = rec["train_step_flops_args"]
    ops = steps * flops.train_step_flops(rec["cell"].config, bsz, n_cls)
    peak = rec["peak_flops"][rec["precision"]]
    return 100.0 * ops / traces[0].window_s / peak
