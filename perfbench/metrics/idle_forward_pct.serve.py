"""Share of the traced serving stretch (%) in which no kernel, copy or
fill ran on the card while the caller's thread was in a request's forward
(``serve.forward``: the id check, the copies to the card and the model's
nets)."""

from perfbench.harness.program import idle_pct_under, in_serve_forward


def read(ctx):
    return idle_pct_under(ctx, in_serve_forward)
