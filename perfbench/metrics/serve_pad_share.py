"""Padded rows over the rows the traced stretch's forwards ran (%): the
program's ``serve.request`` spans count each request's ``rows`` and the
``padded_rows`` its bucket adds."""

from perfbench.harness.program import pad_share


def read(ctx):
    return pad_share(ctx)
