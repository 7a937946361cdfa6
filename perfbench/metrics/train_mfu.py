"""The training steps' model operations in the traced epoch over its time,
against the tensor cores' peak on the input type (counts/flops.py: three
forwards a step)."""

from perfbench.harness.readers import train_mfu


def read(ctx):
    return train_mfu(ctx)
