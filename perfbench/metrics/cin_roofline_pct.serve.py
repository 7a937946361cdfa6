"""K4 (``cin_fwd``) in the traced serving stretch, counted on the padded
chunks it is given: its least time over the device time of the kernels
from ``csrc/cin.cu``."""

from perfbench.harness.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, ('cin_fwd',))
