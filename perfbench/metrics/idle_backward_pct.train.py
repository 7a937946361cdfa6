"""Share of the traced training stretch (%) in which no kernel, copy or
fill ran on the card while the step's thread was in a step's backward
(``step.backward``: it waits while the autograd engine's thread launches
the backward's kernels)."""

from perfbench.harness.program import idle_pct_under, in_step


def read(ctx):
    return idle_pct_under(ctx, in_step('step.backward'))
