"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): HBM3 bandwidth, and the float32 rate outside the tensor
cores, the precision both FCN configurations state and the one the frontend
kernels' 32-bit scalar operations run at."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of bytes over
    bandwidth and operations over the float32 rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_FLOPS)
