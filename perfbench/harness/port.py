"""The system under test: the port's ``DeepModel`` of a configuration, with
the harness's weights loaded into it.

The port draws its own initial weights (on the host, from
``config.seed``) when it builds the model; :func:`load` then writes the
harness's weights over every parameter and running statistic, and refuses
a model that holds anything the configuration does not name."""

import types

import numpy as np
import torch

from deeptables_torch.models.config import ModelConfig
from deeptables_torch.models.deepmodel import DeepModel
from deeptables_torch.models.metainfo import (CategoricalColumn,
                                              ContinuousColumn)

from .. import nets as nets_lib

CAT_KEY = 'cat'
DENSE_KEY = 'input_continuous_all'


def build(config, seed: int, device, metrics=('AUC',)) -> DeepModel:
    """A binary task under binary cross-entropy, trained with Adam (the
    reference's model), with no embedding dropout; each net's settings from
    its module (``perfbench/nets``). With no dense features the model has no
    continuous column."""
    dim = int(config['embedding_dim'])
    settings = dict(
        nets=list(config['nets']), metrics=list(metrics), task='binary',
        loss='binary_crossentropy', optimizer='adam',
        learning_rate=float(config['learning_rate']), embedding_dropout=0.0,
        embeddings_output_dim=dim,
        dense_batch_norm=bool(config.get('dense_batch_norm', True)),
        dtype_policy=config['dtype_policy'], seed=int(seed))
    for _, net in nets_lib.of(config):
        settings.update(net.port_settings(config))
    cats = tuple(CategoricalColumn(f'C{i + 1}', int(v) + 1, dim)
                 for i, v in enumerate(config['vocabulary']))
    n_dense = int(config['dense_features'])
    conts = (ContinuousColumn(DENSE_KEY, [
        f'I{i + 1}' for i in range(n_dense)]),) if n_dense else ()
    return DeepModel('binary', 2, ModelConfig(**settings), cats, conts,
                     device=device)


def port_names(config) -> dict:
    """``{reference leaf or statistic: the port's state_dict key}``."""
    names = {'embeddings':
             f'emb_categorical_vars_all.embeddings_d{config["embedding_dim"]}'}
    bns = [('bn_concat', 'bn_concat_emb_dense')]
    if int(config['dense_features']) and config.get('dense_batch_norm', True):
        bns.insert(0, ('bn_dense', 'bn_dense_all'))
    for ref_bn, port_bn in bns:
        for ref_key, port_key in (('gamma', 'weight'), ('beta', 'bias'),
                                  ('mean', 'running_mean'),
                                  ('var', 'running_var')):
            names[f'{ref_bn}.{ref_key}'] = f'{port_bn}.{port_key}'
    for _, net in nets_lib.of(config):
        names.update(net.port_names(config))
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
    """The port's input of the rows: no dense key where ``dense`` has no
    columns."""
    if dense.shape[1] == 0:
        return {CAT_KEY: cat}
    return {CAT_KEY: cat, DENSE_KEY: dense}


def columns(batch) -> tuple:
    """``(cat, dense)`` of a batch of :func:`arrays`, copied; ``dense`` with
    no columns where the batch has none."""
    cat = batch[CAT_KEY]
    if DENSE_KEY not in batch:
        return cat.copy(), np.zeros((len(cat), 0), dtype=np.float32)
    return cat.copy(), batch[DENSE_KEY].copy()
