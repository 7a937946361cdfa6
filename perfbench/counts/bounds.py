"""Least times of single kernels and layers on the card, from their shapes
(the roofline's larger bound: operations over the peak rate of the input
type, bytes over HBM bandwidth)."""

from .peaks import BF16_OPS_PER_S, HBM_BYTES_PER_S, TF32_OPS_PER_S

# Adam reads the parameter, its gradient and both moments and writes the
# parameter and both moments: seven float32 values a parameter.
ADAM_BYTES_PER_PARAM = 28


def cin_bound(kernel: str, B: int, F: int, G: int, L: int, D: int,
              itemsize: int):
    """Least time of the CIN contraction (``'cin_fwd'``, K4) or its
    gradient (``'cin_bwd'``, K3) in seconds, and its operations. Bytes:
    each input read once, each output written once (z and dW float32, dx0
    and dh in the input type). Operations: the GEMM (2·L·F·G per column)
    and the pair products (F·G per column); the gradient twice the GEMM
    (dpair and dW) and 5·F·G per column (pair, dx0 and dh products and
    sums). Every operation at the tensor cores' rate on the input type:
    bfloat16's 989 TFLOP/s, float32's 495, TF32's rate."""
    N = B * D
    if kernel == 'cin_fwd':
        nbytes = itemsize * (N * F + N * G + L * F * G) + 4 * L * N
        ops = 2 * L * F * G * N + F * G * N
    elif kernel == 'cin_bwd':
        nbytes = itemsize * (2 * N * F + 2 * N * G + L * F * G + L * N) \
            + 4 * L * F * G
        ops = 4 * L * F * G * N + 5 * F * G * N
    else:
        raise ValueError(kernel)
    rate = BF16_OPS_PER_S if itemsize == 2 else TF32_OPS_PER_S
    return max(nbytes / HBM_BYTES_PER_S, ops / rate), ops


def adam_bound(n_params: int) -> float:
    """Least time of one Adam update of ``n_params`` float32 parameters."""
    return ADAM_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S

