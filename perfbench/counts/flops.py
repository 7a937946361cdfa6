"""Operations of one example's forward pass, from a configuration's shapes.

Counted: the matrix products at 2 operations a multiply-add (Dense layers
with their biases, the head), the nets' own products and poolings, each as
its module's ``ops_per_row`` says (``perfbench/nets``). Not counted: the
embedding gather, BatchNorm, activations, the loss. A training step counts
three forwards and no recomputation."""

from .. import nets as nets_lib


def forward_per_row(config) -> dict:
    """``{net: operations}`` of one example's forward, and ``'head'``."""
    out = {name: net.ops_per_row(config)
           for name, net in nets_lib.of(config)}
    # the sums of the nets' logits, then a Dense with bias
    out['head'] = (len(out) - 1) + 2 + 1
    return out


def forward_ops(config, rows: int) -> int:
    return rows * sum(forward_per_row(config).values())


def train_step_ops(config, batch: int) -> int:
    return 3 * forward_ops(config, batch)
