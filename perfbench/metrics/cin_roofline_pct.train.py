"""K4 (``cin_fwd``) and K3 (``cin_bwd``) in the traced epoch: their least
time (``bounds`` of nets/cin_nets.py) over the device time of the kernels
from ``csrc/cin.cu``."""

from perfbench.harness.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, ('cin_fwd', 'cin_bwd'))
