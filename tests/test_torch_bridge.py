# -*- coding:utf-8 -*-
"""The weight bridge (``deeptables_torch.bridge``) against the JAX package's
own layout code: every table row is checked against ``unpack_table`` at the
JAX ``plan_groups`` offsets, and every Dense and BatchNorm entry that
follows the field axis against the JAX plan's field order. The CIN weights
of xDeepFM on a non-ascending schema: every axis over the input fields in
column order, the hidden-unit axes as they are. Copies are exact.
"""

import numpy as np
import pytest

from deeptables_tpu.ops.embedding import plan_groups, unpack_table
from deeptables_torch import bridge
from torch_parity import Case, to_column_order


@pytest.fixture(scope='module', params=['nonascending_d16', 'nonascending_d8',
                                        'bench', 'mixed_widths'])
def case(request):
    return Case(request.param)


def test_state_dict_loads_strictly(case):
    model = case.port_model().module
    assert set(case.state_dict) == set(model.state_dict())


def test_embedding_rows(case):
    params = case.variables['params']['emb_categorical_vars_all']
    vocabs = [int(v) for v in case.vocabs]
    for dim, cols, offsets, total, _ in plan_groups(vocabs, case.dims):
        logical = unpack_table(params[f'embeddings_d{dim}'], total, dim)
        port = case.state_dict[
            f'emb_categorical_vars_all.embeddings_d{dim}'].numpy()
        group = sorted(cols)
        assert port.shape == (sum(vocabs[c] for c in group), dim)
        port_offsets = np.cumsum([0] + [vocabs[c] for c in group])
        for col, offset in zip(cols, offsets):
            start = port_offsets[group.index(col)]
            np.testing.assert_array_equal(
                port[start:start + vocabs[col]],
                logical[offset:offset + vocabs[col]])


def test_dense_layers(case):
    params = case.variables['params']
    order = case.field_order()
    dim = case.dims[0]
    for name, node in params.items():
        if 'kernel' not in node:
            continue
        kernel = np.asarray(node['kernel'])
        if name == 'linear_logit':
            kernel = to_column_order(kernel.T, order, 1).T
        elif name == 'dnn_dense_1' and 'fm_nets' in case.nets:
            kernel = to_column_order(kernel.T, order, dim).T
        np.testing.assert_array_equal(
            case.state_dict[f'{name}.weight'].numpy(), kernel.T)
        if 'bias' in node:
            np.testing.assert_array_equal(
                case.state_dict[f'{name}.bias'].numpy(), node['bias'])


def test_batch_norm(case):
    params = case.variables['params']
    stats = case.variables['batch_stats']
    order = case.field_order()
    for name in stats:
        block = case.dims[0] if name == 'bn_concat_emb_dense' else 0
        for port_key, value in (('weight', params[name]['scale']),
                                ('bias', params[name]['bias']),
                                ('running_mean', stats[name]['mean']),
                                ('running_var', stats[name]['var'])):
            expected = to_column_order(value, order, block) if block \
                else np.asarray(value)
            np.testing.assert_array_equal(
                case.state_dict[f'{name}.{port_key}'].numpy(), expected)


CIN_VARIANTS = {'default': None,
                'reduce_D-residual-bias': {'reduce_D': True,
                                           'use_residual': True,
                                           'use_bias': True},
                'direct-residual': {'direct': True, 'use_residual': True}}


@pytest.fixture(scope='module', params=list(CIN_VARIANTS))
def cin_case(request):
    return Case('xdeepfm_nonascending_d8',
                cin_params=CIN_VARIANTS[request.param])


def _cin_expected(key, value, order):
    """The JAX CIN weight ``key`` with its field axes in column order."""
    value = np.asarray(value)
    kind, layer = key.rsplit('_', 1)
    out = np.empty_like(value)
    index = [slice(None)] * value.ndim
    if kind == 'f' or kind == 'f0':
        index[1] = order
    if layer == '0' and kind in ('f', 'f_'):
        index[2] = order
    out[np.ix_(*[np.arange(n) if i == slice(None) else np.asarray(i)
                 for n, i in zip(value.shape, index)])] = value
    return out


def test_cin_weights_follow_the_column_order(cin_case):
    params = cin_case.variables['params']['cin_layer']
    order = cin_case.field_order()
    assert order != sorted(order)  # the plan reorders these fields
    state = cin_case.state_dict
    expected_keys = set()
    for key, value in params.items():
        if isinstance(value, dict):
            np.testing.assert_array_equal(
                state[f'cin_layer.{key}.weight'].numpy(), value['kernel'].T)
            np.testing.assert_array_equal(
                state[f'cin_layer.{key}.bias'].numpy(), value['bias'])
            expected_keys |= {f'cin_layer.{key}.weight',
                              f'cin_layer.{key}.bias'}
        else:
            np.testing.assert_array_equal(state[f'cin_layer.{key}'].numpy(),
                                          _cin_expected(key, value, order))
            expected_keys.add(f'cin_layer.{key}')
    assert expected_keys == {k for k in state if k.startswith('cin_layer.')}
    config = cin_case.port_config.cin_params
    names = {k.split('.')[1] for k in expected_keys}
    assert ('f0_0' in names) == bool(config.get('reduce_D'))
    assert ('exFM_out0' in names) == bool(config.get('use_residual'))
    assert ('bias_1' in names) == bool(config.get('use_bias'))


def test_cin_state_dict_loads_strictly_and_maps_gradients(cin_case):
    model = cin_case.port_model().module
    assert set(cin_case.state_dict) == set(model.state_dict())
    # a gradient tree (no batch_stats) maps through the same linear steps
    grads = {'params': cin_case.variables['params']}
    mapped = bridge.state_dict_from_flax(grads, cin_case.port_cats,
                                         cin_case.port_conts,
                                         cin_case.port_config)
    for key, value in mapped.items():
        np.testing.assert_array_equal(value.numpy(),
                                      cin_case.state_dict[key].numpy())
    assert {k for k in mapped if k.startswith('cin_layer.')} == \
        {k for k in cin_case.state_dict if k.startswith('cin_layer.')}


@pytest.fixture(scope='module', params=['autoint_nonascending_d8',
                                        'autoint_dnn_d8'])
def autoint_case(request):
    return Case(request.param)


def test_autoint_weights_are_nested_and_need_no_permutation(autoint_case):
    params = autoint_case.variables['params']
    stats = autoint_case.variables['batch_stats']
    state = autoint_case.state_dict
    blocks = [n for n in params if n.startswith('autoint_attention_')]
    assert blocks == ['autoint_attention_0', 'autoint_attention_1']
    expected_keys = set()
    for block in blocks:
        for layer in ('dense_Q', 'dense_K', 'dense_V', 'dense_residual'):
            node = params[block][layer]
            np.testing.assert_array_equal(
                state[f'{block}.{layer}.weight'].numpy(), node['kernel'].T)
            np.testing.assert_array_equal(
                state[f'{block}.{layer}.bias'].numpy(), node['bias'])
            expected_keys |= {f'{block}.{layer}.weight',
                              f'{block}.{layer}.bias'}
        bn = f'{block}.batch_normalize'
        for port_key, value in (
                ('weight', params[block]['batch_normalize']['scale']),
                ('bias', params[block]['batch_normalize']['bias']),
                ('running_mean', stats[block]['batch_normalize']['mean']),
                ('running_var', stats[block]['batch_normalize']['var'])):
            np.testing.assert_array_equal(state[f'{bn}.{port_key}'].numpy(),
                                          value)
            expected_keys.add(f'{bn}.{port_key}')
    assert expected_keys == {k for k in state
                             if k.startswith('autoint_attention_')}
    assert set(state) == set(autoint_case.port_model().module.state_dict())


def test_autoint_output_layer_rows_follow_the_column_order(autoint_case):
    """The flattened (F·U) AutoInt output is in JAX plan order: the layer
    that reads it has its rows permuted in blocks of U."""
    params = autoint_case.variables['params']
    order = autoint_case.field_order()
    assert order != sorted(order)
    dim = autoint_case.dims[0]
    reader = 'task_output' if autoint_case.nets == ['autoint_nets'] \
        else 'dense_logit_autoint_nets'
    kernel = np.asarray(params[reader]['kernel'])
    np.testing.assert_array_equal(
        autoint_case.state_dict[f'{reader}.weight'].numpy(),
        to_column_order(kernel.T, order, dim))
    if reader != 'task_output':
        # beside another net, task_output reads the stacked logits
        np.testing.assert_array_equal(
            autoint_case.state_dict['task_output.weight'].numpy(),
            np.asarray(params['task_output']['kernel']).T)
