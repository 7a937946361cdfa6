"""Share of the traced training stretch (%) in which no kernel, copy or
fill ran on the card while the step's thread was in a step's input spans
(``input.check_ids``, the host's id check; ``input.copy``, the copies of
the batch, labels and weights to the card)."""

from perfbench.harness.program import idle_pct_under, in_input


def read(ctx):
    return idle_pct_under(ctx, in_input)
