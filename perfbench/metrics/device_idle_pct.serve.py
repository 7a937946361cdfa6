"""Share of the traced serving stretch (about a second of requests) in
which no kernel, copy or fill ran on the card."""

from perfbench.harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
