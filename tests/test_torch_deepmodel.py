# -*- coding:utf-8 -*-
"""The port's DeepFM (``deeptables_torch.models.deepmodel``) against the JAX
package's, with the same weights (bridged) and the same inputs, on the CPU.

Every tap and the logits of ``DeepTabularModel`` are compared under both
dtype policies, on a schema whose vocabularies are not ascending (the TPU
plan reorders its fields) and on the bench schema; a schema of two
embedding widths runs ``dnn_nets`` alone; two schemas run xDeepFM (with a
CIN of (8, 4)). The JAX taps that follow
the field axis (``flatten_embeddings``, ``concat_embedding_dense``) are in
the plan's field order and are put in column order first.

Tolerances:
- float32: atol 1e-5, rtol 1e-5 (the conftest pins JAX matmuls to full
  float32; only the summation order differs).
- bfloat16: each tap within 2⁻⁷ (the spacing of bfloat16 numbers just above
  1) times its scale, as the two frameworks round the bfloat16 sums of the
  linear and FM nets at other places. A tap's scale is its largest
  magnitude; FM's is the largest ``Σ_f,d x²`` of a row, since it is the
  difference of two sums of that size and JAX rounds both to bfloat16.
  Logits atol 2e-2.
"""

import numpy as np
import pytest

from deeptables_tpu.data.pipeline import BatchIterator as JaxBatchIterator
from deeptables_torch.data.pipeline import BatchIterator
from torch_parity import Case, to_column_order

BF16_SPACING = 2.0 ** -7
FIELD_TAPS = ('flatten_embeddings', 'concat_embedding_dense')


@pytest.fixture(scope='module', params=[
    ('nonascending_d16', 'float32'), ('nonascending_d16', 'bfloat16'),
    ('nonascending_d8', 'float32'), ('bench', 'float32'),
    ('bench', 'bfloat16'), ('mixed_widths', 'float32'),
    ('xdeepfm_nonascending_d8', 'float32'),
    ('xdeepfm_nonascending_d16', 'bfloat16')],
    ids=lambda p: '-'.join(p))
def case(request):
    case = Case(*request.param)
    case.port = case.port_model()
    return case


def _assert_tap(name, actual, expected, dtype_policy, scale=None):
    actual = np.asarray(actual, np.float32)
    expected = np.asarray(expected, np.float32)
    assert actual.shape == expected.shape, name
    if dtype_policy == 'float32':
        np.testing.assert_allclose(actual, expected, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    else:
        if scale is None:
            scale = float(np.abs(expected).max())
        np.testing.assert_allclose(actual, expected, rtol=0,
                                   atol=BF16_SPACING * scale, err_msg=name)


def test_logits_and_every_tap(case):
    batch = case.batch(37)
    logits, taps = case.jax_model.module.apply(case.variables, batch,
                                               training=False)
    port_logits, port_taps = case.port.forward_batch(batch)
    assert set(port_taps) == set(taps)
    policy = case.port_config.dtype_policy
    order = case.field_order()
    dim = case.dims[0]
    flat = np.asarray(taps['flatten_embeddings'], np.float32)
    scales = {'fm_nets_out': float(np.square(flat).sum(axis=1).max())}
    for name, value in taps.items():
        expected = np.asarray(value, np.float32)
        if name in FIELD_TAPS:
            expected = to_column_order(expected, order, dim)
        port_value = port_taps[name]
        assert str(port_value.dtype).split('.')[-1] == str(value.dtype), name
        _assert_tap(name, port_value.float().numpy(), expected, policy,
                    scales.get(name))
    atol = 1e-5 if policy == 'float32' else 2e-2
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(logits),
                               rtol=1e-5 if policy == 'float32' else 0,
                               atol=atol)


def test_predict_over_batch_loader_with_ragged_tail(case):
    batch = case.batch(37, seed=2)
    jax_loader = JaxBatchIterator(batch, batch_size=16, shuffle=False,
                                  drop_remainder=False)
    loader = BatchIterator(batch, batch_size=16, shuffle=False,
                           drop_remainder=False)
    assert [valid for *_, valid in loader] == [16, 16, 5]
    expected = case.jax_model.predict(jax_loader)
    proba = case.port.predict(loader)
    assert proba.shape == (37, 1)
    atol = 1e-5 if case.port_config.dtype_policy == 'float32' else 5e-3
    np.testing.assert_allclose(proba, expected, atol=atol)
    # packed arrays take the same path through an inner BatchIterator
    np.testing.assert_allclose(case.port.predict(batch, batch_size=16),
                               proba, rtol=0, atol=0)


def test_predict_and_apply_from_a_dataframe(case):
    pd = pytest.importorskip('pandas')
    batch = case.batch(21, seed=3)
    columns = {c.name: batch['cat'][:, i]
               for i, c in enumerate(case.port_cats)}
    dense = case.port_conts[0]
    columns.update({name: batch[dense.name][:, i]
                    for i, name in enumerate(dense.column_names)})
    X = pd.DataFrame(columns)
    atol = 1e-5 if case.port_config.dtype_policy == 'float32' else 5e-3
    np.testing.assert_allclose(case.port.predict(X, batch_size=8),
                               case.jax_model.predict(X, batch_size=8),
                               atol=atol)
    layers = ['dnn_dense_2', 'task_output']
    port_out = case.port.apply(X, output_layers=layers, concat_outputs=True)
    jax_out = case.jax_model.apply(X, output_layers=layers,
                                   concat_outputs=True)
    assert port_out.shape == jax_out.shape == (21, 33)
    _assert_tap('apply', port_out, jax_out, case.port_config.dtype_policy)


def test_model_desc_names_the_same_nets(case):
    desc = case.port.module.model_desc
    assert desc.nets == list(case.nets)
    assert [line.split(':')[0] for line in desc.nets_info] == \
        [line.split(':')[0] for line in case.jax_model.model_desc.nets_info]
