"""``dnn_nets``: a Dense with bias and ``dnn_activation`` for each of
``dnn_hidden_units`` over the BatchNormed concatenation, then a Dense
without bias to one logit (the model's ``dense_logit_dnn_nets``)."""

from . import ACTIVATIONS
from ..reference import model as ref


def param_specs(config):
    specs = []
    width = ref.concat_width(config)
    for i, units in enumerate(config['dnn_hidden_units']):
        specs += [(f'dnn.{i}.w', (units, width), ref.he(width)),
                  (f'dnn.{i}.b', (units,), ref.SMALL)]
        width = units
    specs.append(('dnn.logit.w', (1, width), ref.lecun(width)))
    return specs



def forward(params, config, parts, training, precision):
    activation = ACTIVATIONS[config['dnn_activation']]
    h = parts.concat
    for i in range(len(config['dnn_hidden_units'])):
        h = activation(ref.matmul(h, params[f'dnn.{i}.w'].t(), precision)
                       + params[f'dnn.{i}.b'])
    return ref.matmul(h, params['dnn.logit.w'].t(), precision)


def ops_per_row(config):
    width = ref.concat_width(config)
    ops = 0
    for units in config['dnn_hidden_units']:
        ops += 2 * width * units + units
        width = units
    return ops + 2 * width


def port_settings(config):
    dropout = float(config.get('dnn_dropout', 0))
    return {'dnn_params': {
        'hidden_units': tuple((int(u), dropout, False)
                              for u in config['dnn_hidden_units']),
        'activation': config['dnn_activation']}}


def port_names(config):
    names = {}
    for i in range(len(config['dnn_hidden_units'])):
        names[f'dnn.{i}.w'] = f'dnn_dense_{i + 1}.weight'
        names[f'dnn.{i}.b'] = f'dnn_dense_{i + 1}.bias'
    names['dnn.logit.w'] = 'dense_logit_dnn_nets.weight'
    return names
