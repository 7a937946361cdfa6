"""K5 (``fa_fwd`` and ``fa_bwd``, the field attention of AutoInt's
interacting layers) in the traced epoch: their least time (``bounds`` of
nets/autoint_nets.py) over the device time of their kernels from
``csrc/field_attention.cu``."""

from perfbench.harness.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, ('fa_fwd', 'fa_bwd'))
