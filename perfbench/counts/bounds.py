"""Least times of single kernels and layers on the card, from their shapes
(the roofline's larger bound: operations over the peak rate of the input
type, bytes over HBM bandwidth). A net's own kernels' bounds are in its
module (``perfbench/nets``)."""

from dataclasses import dataclass
from typing import Callable

from .peaks import BF16_OPS_PER_S, HBM_BYTES_PER_S, TF32_OPS_PER_S

# Adam reads the parameter, its gradient and both moments and writes the
# parameter and both moments: seven float32 values a parameter.
ADAM_BYTES_PER_PARAM = 28


@dataclass(frozen=True)
class KernelBound:
    """What a roofline reader needs of one hand-written kernel of a net:
    ``least(*shape, itemsize)``, its least time in seconds and its
    operations at a call's shape; ``runs(name)``, whether a device kernel
    of the trace does part of its work; ``once_a_call(name)``, whether it
    is the device kernel launched once a call (to count the calls the
    profiler saw)."""
    least: Callable
    runs: Callable[[str], bool]
    once_a_call: Callable[[str], bool]


def least_time(ops: int, nbytes: int, itemsize: int) -> float:
    """The roofline's larger bound: ``ops`` at the tensor cores' rate on
    the input type (bfloat16's 989 TFLOP/s; float32's, TF32's 495),
    ``nbytes`` at HBM bandwidth."""
    rate = BF16_OPS_PER_S if itemsize == 2 else TF32_OPS_PER_S
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)


def adam_bound(n_params: int) -> float:
    """Least time of one Adam update of ``n_params`` float32 parameters."""
    return ADAM_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S

