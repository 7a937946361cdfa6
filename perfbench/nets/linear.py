"""``linear``: DeepTables' order-1 net, one Dense without bias over
[the per-field sums of the embeddings, the normalised dense inputs]."""

import torch

from ..reference import model as ref


def _inputs(config) -> int:
    return len(config['vocabulary']) + int(config['dense_features'])


def param_specs(config):
    n = _inputs(config)
    return [('linear.w', (1, n), ref.lecun(n))]



def forward(params, config, parts, training, precision):
    x = torch.cat([parts.embeddings.sum(dim=-1), parts.dense], dim=1)
    return ref.matmul(x, params['linear.w'].t(), precision)


def ops_per_row(config):
    # the per-field sums, then a Dense of F + n_dense inputs
    return len(config['vocabulary']) * int(config['embedding_dim']) + \
        2 * _inputs(config)


def port_settings(config):
    return {}


def port_names(config):
    return {'linear.w': 'linear_logit.weight'}
