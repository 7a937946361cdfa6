"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12


def tensor_core_peak(dtype_policy: str) -> float:
    """The tensor cores' rate on the policy's input type: bfloat16's, or
    for float32 TF32's (the most the card does on 32-bit operands)."""
    return BF16_OPS_PER_S if dtype_policy == 'bfloat16' else TF32_OPS_PER_S


def itemsize(dtype_policy: str) -> int:
    return 2 if dtype_policy == 'bfloat16' else 4
