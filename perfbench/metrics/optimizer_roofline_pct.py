"""Least time of the traced Adam updates (28 bytes a parameter at HBM
bandwidth) over the device time of the kernels launched inside the
harness's spans around ``optimizer.step``."""

from perfbench.harness.readers import optimizer_roofline_pct


def read(ctx):
    return optimizer_roofline_pct(ctx)
