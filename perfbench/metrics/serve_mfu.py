"""The forward operations of the requested rows (padding not counted) in
the traced stretch over its time, against the tensor cores' peak on the
input type."""

from perfbench.harness.readers import serve_mfu


def read(ctx):
    return serve_mfu(ctx)
