"""Share of the traced training stretch (one epoch: its steps, its
validation batch and metrics) in which no kernel, copy or fill ran on the
card."""

from perfbench.harness.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
