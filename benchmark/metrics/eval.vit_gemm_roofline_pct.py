"""eval.vit_gemm_roofline_pct: the ViT's dense products (patch embedding,
qkv, proj, fc1, fc2: the configuration's reference ``dense_flops`` a
row) over the device time of the GEMM kernel that runs them in the
traced runs (by its name), as a share of the f32 peak.

The rows are those the traced runs put through the backbone, padded
replay rows included: the number of ``srt.vit.forward`` ranges in the
trace times the mean rows of a forward, from the program's counters
``ViT.rows_forwarded`` / ``ViT.forwards`` (every run of the process, the
warm-up too, runs the same forwards, which leaves the mean as it is).
Nothing to read where the program has no such counter or range, or the
configuration's reference no ``dense_flops``."""

from benchmark import spans
from benchmark.reference import backbone

# the cuBLAS kernel that runs every dense product of the forward on the
# card (f32, TF32 off: 49 launches a forward, at every row count the
# evaluation forwards); the head's small products run other tiles
GEMM_MARKS = ("xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8",)
NAMES = ("srt.vit.forward",)


def read(rec):
    traces = rec.get("traces") or []
    if not traces or not traces[0].device or rec.get("runs", 0) <= 0:
        return None
    try:
        from subspace_reg_tpu_torch.models.vit import ViT
    except ImportError:
        return None
    cfg = rec["cell"].config
    dense = getattr(backbone.of(cfg), "dense_flops", None)
    forwards = len(spans.ranges(traces[0], NAMES))
    seconds = traces[0].device_time_s(GEMM_MARKS)
    if dense is None or not ViT.forwards or not forwards or seconds <= 0:
        return None
    rows = ViT.rows_forwarded / ViT.forwards * forwards
    peak = rec["peak_flops"][rec["precision"]]
    return 100.0 * dense(cfg) * rows / seconds / peak
