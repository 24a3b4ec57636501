"""eval.mfu_pct: the whole run's share of the card's f32 peak: the
benchmark's count of the operations the runs really needed (the backbone
forwards of the filled rows, the head's products, K1's epochs; flops.py)
over the traced window (whole runs), over the peak of the evaluation's
precision."""

from benchmark import flops


def read(rec):
    traces = rec.get("traces") or []
    if not traces or not traces[0].device or rec.get("runs", 0) <= 0:
        return None
    cfg = rec["cell"].config
    ops = sum(flops.eval_run_flops(cfg, s, rec["base_eval_n"])
              for s in rec["sessions"])
    peak = rec["peak_flops"][rec["precision"]]
    return 100.0 * ops / traces[0].window_s / peak
