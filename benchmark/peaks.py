"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): what the rooflines and the MFU are
shares of."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores
TF32_TC_OPS_PER_S = 495e12  # TF32 on the tensor cores
BF16_TC_OPS_PER_S = 989e12


def bound_s(n_bytes: float, n_ops: float, ops_per_s: float) -> float:
    """The least time for the work: bytes over the memory rate or operations
    over the peak of the units that run them, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)
