"""Operations of one example's forward pass, from a configuration's shapes.

Counted: the matrix products at 2 operations a multiply-add (DNN layers
with their biases, the linear net, the CIN's logit and the head), FM's
pooling and the CIN's contraction. Not counted: the embedding gather,
BatchNorm, activations, the loss. A training step counts three forwards
and no recomputation."""

from ..reference.model import cin_maps


def cin_layer_ops(n_fields: int, g: int, maps: int, dim: int) -> int:
    """One example's CIN layer: the pair products (F·G a column) and the
    GEMM (2·L·F·G a column), D columns; ``counts.bounds.cin_bound``'s
    operations over one example."""
    return dim * (2 * maps * n_fields * g + n_fields * g)


def forward_per_row(config) -> dict:
    """``{net: operations}`` of one example's forward, and ``'head'``."""
    n_fields = len(config['vocabulary'])
    dim = int(config['embedding_dim'])
    n_dense = int(config['dense_features'])
    nets = config['nets']
    out = {}
    if 'linear' in nets:
        # the per-field sums, then a Dense of F + n_dense inputs
        out['linear'] = n_fields * dim + 2 * (n_fields + n_dense)
    if 'fm_nets' in nets:
        # Σ_f e, its square, Σ_f e², their difference and the sum over d
        out['fm_nets'] = 3 * n_fields * dim + 3 * dim
    if 'cin_nets' in nets:
        layers, width = cin_maps(config)
        ops = sum(cin_layer_ops(n_fields, g, maps, dim)
                  for maps, g in layers)
        out['cin_nets'] = ops + width * dim + 2 * width + 1
    if 'dnn_nets' in nets:
        width = n_fields * dim + n_dense
        ops = 0
        for units in config['dnn_hidden_units']:
            ops += 2 * width * units + units
            width = units
        out['dnn_nets'] = ops + 2 * width
    out['head'] = (len(out) - 1) + 2 + 1
    return out


def forward_ops(config, rows: int) -> int:
    return rows * sum(forward_per_row(config).values())


def train_step_ops(config, batch: int) -> int:
    return 3 * forward_ops(config, batch)
