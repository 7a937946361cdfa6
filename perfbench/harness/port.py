"""The system under test: the port's ``DeepModel`` of a configuration, with
the harness's weights loaded into it.

The port draws its own initial weights (on the host, from
``config.seed``) when it builds the model; :func:`load` then writes the
harness's weights over every parameter and running statistic, and refuses
a model that holds anything the configuration does not name."""

import types

import torch

from deeptables_torch.models.config import ModelConfig
from deeptables_torch.models.deepmodel import DeepModel
from deeptables_torch.models.metainfo import (CategoricalColumn,
                                              ContinuousColumn)

CAT_KEY = 'cat'
DENSE_KEY = 'input_continuous_all'


def build(config, seed: int, device, metrics=('AUC',)) -> DeepModel:
    """A binary task under binary cross-entropy, trained with Adam (the
    reference's model), with no embedding dropout."""
    dim = int(config['embedding_dim'])
    dropout = float(config['dnn_dropout'])
    settings = dict(
        nets=list(config['nets']), metrics=list(metrics), task='binary',
        loss='binary_crossentropy', optimizer='adam',
        learning_rate=float(config['learning_rate']), embedding_dropout=0.0,
        embeddings_output_dim=dim,
        dense_batch_norm=bool(config.get('dense_batch_norm', True)),
        dnn_params={'hidden_units': tuple(
            (int(u), dropout, False) for u in config['dnn_hidden_units']),
            'activation': config['dnn_activation']},
        dtype_policy=config['dtype_policy'], seed=int(seed))
    if 'cin_nets' in config['nets']:
        settings['cin_params'] = {
            'cross_layer_size': tuple(config['cin_cross_layer_size']),
            'activation': config['cin_activation'], 'use_residual': False,
            'use_bias': False, 'direct': bool(config.get('cin_direct', False)),
            'reduce_D': False}
    cats = tuple(CategoricalColumn(f'C{i + 1}', int(v) + 1, dim)
                 for i, v in enumerate(config['vocabulary']))
    conts = (ContinuousColumn(DENSE_KEY, [
        f'I{i + 1}' for i in range(int(config['dense_features']))]),)
    return DeepModel('binary', 2, ModelConfig(**settings), cats, conts,
                     device=device)


def port_names(config) -> dict:
    """``{reference leaf or statistic: the port's state_dict key}``."""
    names = {'embeddings':
             f'emb_categorical_vars_all.embeddings_d{config["embedding_dim"]}'}
    for ref_bn, port_bn in (('bn_dense', 'bn_dense_all'),
                            ('bn_concat', 'bn_concat_emb_dense')):
        for ref_key, port_key in (('gamma', 'weight'), ('beta', 'bias'),
                                  ('mean', 'running_mean'),
                                  ('var', 'running_var')):
            names[f'{ref_bn}.{ref_key}'] = f'{port_bn}.{port_key}'
    names['linear.w'] = 'linear_logit.weight'
    for i in range(len(config.get('cin_cross_layer_size') or ())):
        names[f'cin.{i}.w'] = f'cin_layer.f_{i}'
    names['cin.out.w'] = 'cin_layer.exFM_out.weight'
    names['cin.out.b'] = 'cin_layer.exFM_out.bias'
    for i in range(len(config['dnn_hidden_units'])):
        names[f'dnn.{i}.w'] = f'dnn_dense_{i + 1}.weight'
        names[f'dnn.{i}.b'] = f'dnn_dense_{i + 1}.bias'
    names['dnn.logit.w'] = 'dense_logit_dnn_nets.weight'
    names['out.w'] = 'task_output.weight'
    names['out.b'] = 'task_output.bias'
    return names


def load(model: DeepModel, params: dict, config):
    """Copy every tensor of ``params`` into the model; the model's
    parameters and running statistics must be exactly those."""
    module = model.build()
    state = module.state_dict()
    names = port_names(config)
    wanted = {names[k]: k for k in params}
    if set(wanted) != set(state):
        raise RuntimeError(
            f'the port\'s model holds {sorted(set(state) - set(wanted))} '
            f'that the configuration does not name, and lacks '
            f'{sorted(set(wanted) - set(state))}')
    with torch.no_grad():
        for key, tensor in state.items():
            src = params[wanted[key]]
            if tuple(src.shape) != tuple(tensor.shape):
                raise RuntimeError(f'{key}: the port holds {tuple(tensor.shape)}'
                                   f', the configuration {tuple(src.shape)}')
            tensor.copy_(src)


def leaves(model: DeepModel, config) -> dict:
    """``{reference leaf: the port's parameter}`` of every trained leaf."""
    named = dict(model.build().named_parameters())
    return {ref_name: named[port_name]
            for ref_name, port_name in port_names(config).items()
            if port_name in named}


def estimator(model: DeepModel):
    """What ``serving.Predictor`` reads from a fitted estimator."""
    return types.SimpleNamespace(task=model.task, preprocessor=None,
                                 get_model=lambda selector: model)


def arrays(cat, dense) -> dict:
    return {CAT_KEY: cat, DENSE_KEY: dense}
