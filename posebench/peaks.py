"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
700 W): the denominators of every roofline and MFU share."""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, flops: float = BF16_FLOPS):
    """The least time the card could take: max(ops / peak, bytes / HBM)."""
    return max(ops / flops, nbytes / HBM_BYTES_PER_S)
