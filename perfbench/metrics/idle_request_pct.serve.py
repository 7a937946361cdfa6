"""Share of the traced serving stretch (%) in which no kernel, copy or
fill ran on the card while the caller's thread was in a request outside
its forward (``serve.request``: ``serve.pad``, ``serve.copy_back`` and the
request's own Python)."""

from perfbench.harness.program import idle_pct_under, in_request


def read(ctx):
    return idle_pct_under(ctx, in_request)
