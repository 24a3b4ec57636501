"""eval.vit_attention_ms_per_seed: device time of the ViT's attention
kernels (``F.scaled_dot_product_attention``'s, by their names: on the
card, in f32, the memory-efficient kernel, which computes scores, softmax
and values in one launch) in the traced runs, over the runs, in ms.
Nothing to read where no such kernel ran (a backbone without attention)."""

ATTENTION_MARKS = ("fmha_", "attention_kernel")


def read(rec):
    traces = rec.get("traces") or []
    runs = rec.get("runs", 0)
    if not traces or not traces[0].device or runs <= 0:
        return None
    s = traces[0].device_time_s(ATTENTION_MARKS)
    return 1e3 * s / runs if s > 0 else None
