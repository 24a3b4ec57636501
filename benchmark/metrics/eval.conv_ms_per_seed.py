"""eval.conv_ms_per_seed: device time of cuDNN's convolution kernels
(implicit GEMM and FFT algorithms, by their names) in the traced runs,
over the runs, in ms."""

CONV_MARKS = ("conv", "xmma", "fft", "pointwise_mult_and_sum_complex",
              "region_transform")


def read(rec):
    traces = rec.get("traces") or []
    runs = rec.get("runs", 0)
    if not traces or not traces[0].device or runs <= 0:
        return None
    s = traces[0].device_time_s(CONV_MARKS)
    return 1e3 * s / runs if s > 0 else None
