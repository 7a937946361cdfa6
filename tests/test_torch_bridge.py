# -*- coding:utf-8 -*-
"""The weight bridge (``deeptables_torch.bridge``) against the JAX package's
own layout code: every table row is checked against ``unpack_table`` at the
JAX ``plan_groups`` offsets, and every Dense and BatchNorm entry that
follows the field axis against the JAX plan's field order. The CIN weights
of xDeepFM on a non-ascending schema: every axis over the input fields in
column order, the hidden-unit axes as they are. Wide&Deep+DCN on the adult
schema: Cross's kernels and biases and every Dense that reads a tensor laid
out like ``concat_emb_dense`` in column order; the nets that read the
fields in the JAX package's order (FGCNN, FiBiNet, AFM, the products) one
to one. Copies are exact.
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


# ------------------------------------------------ Wide&Deep+DCN, the zoo

@pytest.fixture(scope='module')
def wdcn_case():
    return Case('adult_widedeep_dcn', jit_init=True)


def test_wide_deep_dcn_on_adult_permutes_what_reads_concat_emb_dense(
        wdcn_case):
    """Cross acts position by position on concat_emb_dense, which the port
    keeps in column order: its kernels and biases, and the rows of
    dcn_dense_1 and dense_logit_dcn_nets, go to column order in blocks of
    D over the first F·D entries; the dense inputs' entries stay."""
    params = wdcn_case.variables['params']
    order = wdcn_case.field_order()
    assert order == [6, 5, 4, 2, 0, 3, 1, 7]  # adult's vocabularies ascend
    dim = wdcn_case.dims[0]
    state = wdcn_case.state_dict
    assert set(state) == set(wdcn_case.port_model().module.state_dict())
    cross = params['dcn_cross_layer']
    assert sorted(cross) == sorted(f'{k}_{i}' for k in ('kernels', 'bias')
                                   for i in range(4))
    for key, value in cross.items():
        value = np.asarray(value)
        np.testing.assert_array_equal(
            state[f'dcn_cross_layer.{key}'].numpy(),
            to_column_order(value.T, order, dim).T)
    for name in ('dcn_dense_1', 'dense_logit_dcn_nets', 'dnn_dense_1'):
        kernel = np.asarray(params[name]['kernel'])
        np.testing.assert_array_equal(state[f'{name}.weight'].numpy(),
                                      to_column_order(kernel.T, order, dim))
    np.testing.assert_array_equal(state['dcn_dense_2.weight'].numpy(),
                                  np.asarray(params['dcn_dense_2']['kernel']).T)


@pytest.mark.parametrize('nets,reader,offset', [
    (['cross_nets'], 'task_output', 0),
    (['cross_nets', 'dnn_nets'], 'dense_logit_cross_nets', 0),
    (['cross_dnn_nets'], 'cross_dnn_dense_1', 0),
    (['pnn_nets'], 'pnn_dense_1', 2 * 28),
    (['ipnn_nets'], 'ipnn_dense_1', 28),
    (['opnn_nets'], 'opnn_dense_1', 28)])
def test_readers_of_concat_emb_dense_follow_the_column_order(nets, reader,
                                                             offset):
    """Each Dense that reads a tensor laid out like concat_emb_dense has its
    rows from ``offset`` (past the pair products, 28 pairs of 8 fields)
    permuted; a net alone is read by task_output."""
    case = Case('adult_widedeep_dcn', nets=nets, jit_init=True)
    order = case.field_order()
    kernel = np.asarray(case.variables['params'][reader]['kernel'])
    expected = np.concatenate([kernel[:offset], to_column_order(
        kernel[offset:].T, order, case.dims[0]).T]).T
    np.testing.assert_array_equal(case.state_dict[f'{reader}.weight'].numpy(),
                                  expected)


def test_nets_in_flax_order_map_one_to_one():
    """The nets that read the fields in the JAX package's order (FGCNN,
    FiBiNet, AFM, the outer product) map without a permutation: a conv2d
    kernel (kh, kw, in, out) → (out, in, kh, kw), every other leaf as it is
    or as a Dense."""
    case = Case('adult_widedeep_dcn', nets=['fgcnn_dnn_nets', 'fibi_nets',
                                            'afm_nets', 'opnn_nets'],
                jit_init=True, fgcnn_params={'fg_filters': (3, 4), 'fg_heights': (3, 2),
                              'fg_pool_heights': (2, 2),
                              'fg_new_feat_filters': (2, 1)})
    params = case.variables['params']
    state = case.state_dict
    assert set(state) == set(case.port_model().module.state_dict())
    stage = params['fgcnn_0_stage_0']
    np.testing.assert_array_equal(
        state['fgcnn_0_stage_0.conv2d.weight'].numpy(),
        np.asarray(stage['conv2d']['kernel']).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state['fgcnn_0_stage_0.dense_output.weight'].numpy(),
        np.asarray(stage['dense_output']['kernel']).T)
    for key in ('fgcnn_dnn_dense_1', 'dense_logit_fibi_nets'):
        np.testing.assert_array_equal(
            state[f'{key}.weight'].numpy(),
            np.asarray(params[key]['kernel']).T)
    for key, leaf in (('senet_bilinear_layer_0.bilinear_weight',
                       params['senet_bilinear_layer_0']['bilinear_weight']),
                      ('afm_layer.projection_h',
                       params['afm_layer']['projection_h']),
                      ('outer_product_layer.kernel',
                       params['outer_product_layer']['kernel'])):
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(leaf))


def test_flax_field_order_is_shared_with_the_model():
    from deeptables_torch.ops import embedding
    assert bridge.flax_field_order is embedding.flax_field_order
    vocabs, dims = [9, 16, 7, 15, 6, 5, 2, 42], [16] * 8
    assert embedding.flax_field_order(vocabs, dims) == [6, 5, 4, 2, 0, 3, 1, 7]
    # var-len fields follow; a var-len width apart stacks nothing
    assert embedding.flax_field_order(vocabs, dims, [16]) == \
        [6, 5, 4, 2, 0, 3, 1, 7, 8]
    assert embedding.flax_field_order(vocabs, dims, [48]) == list(range(9))
    assert embedding.flax_field_order([50, 7], [8, 16]) == [0, 1]
