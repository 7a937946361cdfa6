"""Share of the traced training stretch (%) in which no kernel, copy or
fill ran on the card while the fitting thread was in the epoch loop's own
work: ``fit.batch`` (the host's gather and shuffle), ``fit.train_metrics``
(the epoch's mean loss, the logits' copy, the training AUC) and
``fit.validation`` (the validation forward, its loss and metrics)."""

from perfbench.harness.program import idle_pct_under, in_epoch_loop


def read(ctx):
    return idle_pct_under(ctx, in_epoch_loop)
