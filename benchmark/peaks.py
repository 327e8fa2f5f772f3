"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at its 700 W
limit), the yardstick of every roofline and ``mfu`` share.

The port computes float32 products as three TF32 products on the tensor
cores (3xTF32), so float32 work is held to the TF32 rate: 67 TFLOP/s, the
rate outside the tensor cores, is no upper bound on what it reaches.
"""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12

FLOPS = {"bfloat16": BF16_FLOPS, "float32": TF32_FLOPS}


def flops(compute_dtype: str) -> float:
    """The product rate of a configuration's ``compute_dtype``."""
    return FLOPS[compute_dtype]


def bound_s(flop: float, nbytes: float, compute_dtype: str) -> float:
    """The least seconds for the work: the larger of its operations at the
    product rate and its bytes at the memory rate."""
    return max(flop / flops(compute_dtype), nbytes / HBM_BYTES)
