"""Share of the traced training stretch (%) in which no kernel, copy or
fill ran on the card while the step's thread was in one of AutoInt's
interacting layers (the program's ``autoint.block`` spans, in the
training steps' forwards and the validation forward); None for a program
that logs no such span."""

from perfbench.harness.program import PROGRAM, idle_pct_under, span_log

BLOCK = PROGRAM + 'autoint.block'


def read(ctx):
    if not any(e.get('name') == BLOCK for e in span_log(ctx) or ()):
        return None
    return idle_pct_under(ctx, lambda path: BLOCK in path)
