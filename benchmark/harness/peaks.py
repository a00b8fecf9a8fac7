"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit): the rates a roofline or utilization is a share of."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def least_seconds(nbytes: float, ops: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the bytes at the
    memory's rate and the operations at the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])
