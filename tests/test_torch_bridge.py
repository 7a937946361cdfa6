# -*- coding:utf-8 -*-
"""The weight bridge (``deeptables_torch.bridge``) against the JAX package's
own layout code: every table row is checked against ``unpack_table`` at the
JAX ``plan_groups`` offsets, and every Dense and BatchNorm entry that
follows the field axis against the JAX plan's field order. Copies are exact.
"""

import numpy as np
import pytest

from deeptables_tpu.ops.embedding import plan_groups, unpack_table
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
