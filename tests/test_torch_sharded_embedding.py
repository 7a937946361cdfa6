# -*- coding:utf-8 -*-
"""Row-sharded embedding tables over a model axis in the port
(``deeptables_torch/parallel/sharded_embedding.py``), the twin of
``tests/test_parallel.py``'s sharded lookups, plan and fits.

The JAX tests run one process over the conftest's 8-device CPU mesh; the
port runs one process a device, so the port's side runs on the ranks of a
gloo process group (``tests/torch_ranks.py``: subprocesses with a time
limit and a ``file://`` store), one launch a mesh shape: four ranks for the
2×2 and 1×4 meshes, two for 1×2. The JAX functions run here on the first
devices of the virtual mesh at the same ``(data, model)`` shape, on the
same numpy inputs from a seed.

- The lookups (``sharded_lookup``, ``sharded_lookup_a2a``): the port's rows
  EQUAL to the JAX function's (both are gathers of the same rows), on
  every rank of a data shard; under ``capacity_factor`` 1.0 and 1.5 the
  same ids dropped (their rows zero); the table gradients within rtol 1e-5,
  atol 1e-6 of the JAX gradient and of the dense oracle. A 63-row table on
  two shards (a padding row) is held against the dense oracle alone: the
  JAX lookups take only tables whose rows divide the model axis.
  ``test_lane_packed`` (``tests/test_parallel.py``) has no twin: it tests
  the TPU's lane-packed table layout, which the port does not have.
- The placement plan (``shard_plan``), the twin of ``variable_shardings``.
- DeepFM with a var-len column, fitted on 2×2 under ``'sharded'`` (Adam,
  an l2 embedding penalty) and ``'sharded_a2a'`` (LAMB; Adam with
  dropout): the whole state, the history and the predictions on a
  remainder batch equal a one-process replicated fit's within rtol 1e-4,
  atol 1e-5 (histories atol 1e-6), as ``tests/test_torch_parallel.py``
  holds data parallelism; every rank holds the same.
- On 1×2: a capacity factor of 1.5 drops ids, counts them and logs them
  (``__graft_entry__.dryrun_multichip``'s twin) with a finite loss;
  ``save`` writes the whole table, which a one-process ``DeepModel.load``
  reads to the same predictions; a checkpoint restores the shards and the
  Adam moments bit for bit and reads back whole; a JAX ``DeepModel`` built
  under ``'sharded_a2a'`` on a 1×2 mesh, bridged, gives the port's sharded
  model its logits within 1e-5; ``DeepTable.fit`` and a streaming fit over
  a ``CriteoStreamLoader`` run under the strategy (twins of
  ``tests/test_parallel.py``'s and ``tests/test_criteo_e2e.py``'s sharded
  fits), the latter equal to a one-process fit.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from torch_parity import jit_init_variables
from deeptables_torch import bridge
from deeptables_torch.models import DeepModel as TDeepModel
from deeptables_torch.parallel import sharded_embedding as se
from deeptables_tpu.models.config import ModelConfig
from deeptables_tpu.models.deepmodel import DeepModel
from deeptables_tpu.models.metainfo import (CategoricalColumn,
                                            ContinuousColumn,
                                            VarLenCategoricalColumn)
from deeptables_tpu.parallel import mesh as jax_mesh
from deeptables_tpu.parallel import sharded_embedding as jax_se

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason='needs 8 virtual devices')

CASES = torch_ranks.LOOKUP_CASES


def _bridged_case():
    """A JAX DeepModel of torch_ranks' sharded schema under 'sharded_a2a'
    on a 1×2 mesh (its weights drawn under jax.jit): the bridged
    state_dict, a batch and its logits."""
    cats = tuple(CategoricalColumn(f'C{i}', v, 8)
                 for i, v in enumerate(torch_ranks.SHARDED_VOCABS))
    conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
    genres = VarLenCategoricalColumn('genres', torch_ranks.VARLEN_VOCAB, 8,
                                     pooling_strategy='max')
    genres.max_elements_length = torch_ranks.VARLEN_TOKENS
    strategy = jax_mesh.DataAndModelParallel(
        data_parallel=1, model_parallel=2, mesh=jax_mesh.build_mesh(1, 2))
    config = ModelConfig(
        nets=['linear', 'fm_nets', 'dnn_nets'], task='binary',
        metrics=['AUC'], embedding_dropout=0,
        dnn_params={'hidden_units': ((32, 0, False), (16, 0, False))},
        distribute_strategy=strategy,
        embedding_device_strategy='sharded_a2a')
    model = DeepModel('binary', 2, config, cats, conts,
                      var_categorical_len_columns=[genres])
    X, _ = torch_ranks.sharded_data(seed=3)
    batch = {k: v[:64] for k, v in X.items()}
    model.variables = jit_init_variables(model)
    model.build()
    logits, _ = jax.jit(lambda v, b: model.module.apply(
        v, b, training=False))(model.variables, batch)
    port = torch_ranks.sharded_model({})
    state = bridge.state_dict_from_flax(
        jax.device_get(model.variables), port.categorical_columns,
        port.continuous_columns, port.config,
        port.var_len_categorical_columns)
    return {'state_dict': {k: v.numpy() for k, v in state.items()},
            'batch': batch, 'jax_logits': np.asarray(logits),
            'packed_rows': np.asarray(model.variables['params'][
                'emb_categorical_vars_all']['embeddings_d8']).shape[0]}


@pytest.fixture(scope='module')
def four_ranks(tmp_path_factory):
    return torch_ranks.run_ranks('model_axis', tmp_path_factory.mktemp('ma'),
                                 4)


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('ma12')
    case = _bridged_case()
    with open(tmp / 'bridged.pkl', 'wb') as f:
        pickle.dump(case, f)
    ranks = torch_ranks.run_ranks('model_axis_1x2', tmp, 2, tmp,
                                  tmp / 'bridged.pkl')
    return ranks, case, tmp


def _ranks_of(case, four_ranks, two_ranks):
    return two_ranks[0] if CASES[case][0] == (1, 2) else four_ranks


def _assembled(case, ranks):
    """(the rows of the whole batch, the table's gradient or None) from the
    ranks' results; every model rank of a data shard holds the same rows."""
    (n_data, n_model) = CASES[case][0]
    results = {(r['lookups'][case]['d'], r['lookups'][case]['m']):
               r['lookups'][case] for r in ranks
               if case in r['lookups']}
    parts = []
    for d in range(n_data):
        for m in range(1, n_model):
            np.testing.assert_array_equal(results[(d, m)]['rows'],
                                          results[(d, 0)]['rows'])
        parts.append(results[(d, 0)]['rows'])
    grad = None
    if CASES[case][-1]:
        grad = se.unshard_rows(
            [torch.from_numpy(results[(0, m)]['grad'])
             for m in range(n_model)], CASES[case][1]).numpy()
        for d in range(1, n_data):  # summed over the data axis
            for m in range(n_model):
                np.testing.assert_array_equal(results[(d, m)]['grad'],
                                              results[(0, m)]['grad'])
    return np.concatenate(parts), grad, results


def _jax_lookup(case):
    (n_data, n_model), _, _, _, _, _, _, how, factor, want_grad = CASES[case]
    table, ids, w = torch_ranks.lookup_inputs(case)
    mesh = jax_mesh.build_mesh(n_data, n_model)

    def run(t):
        if how == 'sharded':
            return jax_se.sharded_lookup(t, jnp.asarray(ids), mesh)
        return jax_se.sharded_lookup_a2a(t, jnp.asarray(ids), mesh,
                                         capacity_factor=factor)
    rows = np.asarray(jax.jit(run)(jnp.asarray(table)))
    grad = None
    if want_grad:
        grad = np.asarray(jax.jit(jax.grad(
            lambda t: jnp.sum(run(t) * jnp.asarray(w))))(jnp.asarray(table)))
    return rows, grad


def _oracle_grad(table, ids, w):
    g = np.zeros_like(table)
    np.add.at(g, ids, w)
    return g


@requires_8
@pytest.mark.parametrize('case', [c for c in CASES if '_padded' not in c])
def test_lookup_equals_the_jax_function(case, four_ranks, two_ranks):
    rows, grad, _ = _assembled(case, _ranks_of(case, four_ranks, two_ranks))
    jax_rows, jax_grad = _jax_lookup(case)
    np.testing.assert_array_equal(rows, jax_rows)
    table, ids, w = torch_ranks.lookup_inputs(case)
    if 'drops' not in case:
        np.testing.assert_array_equal(rows, table[ids])
    if grad is not None:
        np.testing.assert_allclose(grad, jax_grad, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(grad, _oracle_grad(table, ids, w),
                                   rtol=1e-5, atol=1e-6)


@requires_8
@pytest.mark.parametrize('factor', ['1.0', '1.5'])
def test_bounded_capacity_drops_the_jax_functions_ids(factor, four_ranks,
                                                      two_ranks):
    case = f'a2a_drops_{factor}'
    rows, _, results = _assembled(case, four_ranks)
    jax_rows, _ = _jax_lookup(case)
    dropped = (rows == 0).all(axis=-1)
    assert dropped.any(), 'expected capacity drops under skew'
    np.testing.assert_array_equal(dropped, (jax_rows == 0).all(axis=-1))
    table, ids, _ = torch_ranks.lookup_inputs(case)
    np.testing.assert_array_equal(rows[~dropped], table[ids][~dropped])
    # each rank counts the drops of its model axis
    assert all(r['drops'] == int(dropped.sum()) for r in results.values())


def test_padded_table_against_the_dense_oracle(four_ranks, two_ranks):
    case = 'psum_1x2_padded'
    rows, grad, results = _assembled(case, two_ranks[0])
    table, ids, w = torch_ranks.lookup_inputs(case)
    np.testing.assert_array_equal(rows, table[ids])
    np.testing.assert_allclose(grad, _oracle_grad(table, ids, w), rtol=1e-5,
                               atol=1e-6)
    # the padding row of the last shard gets no gradient
    assert not results[(0, 1)]['grad'][-1].any()


@requires_8
def test_shard_plan_twins_variable_shardings():
    fake = {'emb_categorical_vars_all.embeddings_d4': np.zeros((64, 4)),
            'emb_genres.embeddings': np.zeros((64, 4)),
            'dnn_dense_1.weight': np.zeros((128, 10))}
    plan = se.shard_plan(fake, model_size=2)
    assert plan == {'emb_categorical_vars_all.embeddings_d4': 32}
    assert se.shard_plan(fake, model_size=1) == {}
    assert se.shard_plan(fake, model_size=2, shard_threshold=65) == {}
    shardings = jax_se.variable_shardings(
        {'params': {'emb_categorical_vars_all': {
            'embeddings_d4': np.zeros((64, 4))},
            'dnn_dense_1': {'kernel': np.zeros((10, 128))}}},
        jax_mesh.build_mesh(4, 2), shard_embeddings=True)
    params = shardings['params']
    assert 'model' in str(params['emb_categorical_vars_all'][
        'embeddings_d4'].spec)
    assert 'model' not in str(params['dnn_dense_1']['kernel'].spec)
    assert se.is_embedding_table('emb_genres.embeddings', np.zeros((3, 2)))
    assert not se.is_embedding_table('dnn_dense_1.weight', np.zeros((3, 2)))


def test_shard_rows_round_trip():
    table = torch.arange(53 * 3, dtype=torch.float32).reshape(53, 3)
    shards = [se.shard_rows(table, 2, m) for m in range(2)]
    assert [tuple(s.shape) for s in shards] == [(27, 3), (27, 3)]
    assert not shards[1][-1].any()
    assert torch.equal(se.unshard_rows(shards, 53), table)


def test_dispatch_plan_is_the_jax_plan():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 40, 37).astype(np.int32)
    for capacity in (37, 12, 5):
        port = se._dispatch_plan(torch.from_numpy(ids), 4, capacity, 10)
        ref = jax_se._dispatch_plan(jnp.asarray(ids), 4, capacity, 10)
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize('case', list(torch_ranks.SHARDED_CASES))
def test_2x2_fit_equals_one_process_fit(case, four_ranks):
    state, history, predictions, model = torch_ranks.sharded_fit(
        torch_ranks.SHARDED_CASES[case])
    assert not model._sharded_embedding()  # the replicated reference
    got = four_ranks[0][case]
    # Σ vocab 53 over 2 shards: 27 rows a rank, the last one padding
    assert got['shard_rows'] == (27, 8)
    assert set(got['state']) == set(state)
    for key, value in state.items():
        np.testing.assert_allclose(got['state'][key], value, rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    assert set(got['history']) == set(history)
    for key, values in history.items():
        np.testing.assert_allclose(got['history'][key], values, rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(got['predictions'], predictions, rtol=1e-4,
                               atol=1e-6)
    for other in four_ranks[1:]:
        for key, value in got['state'].items():
            np.testing.assert_array_equal(other[case]['state'][key], value,
                                          err_msg=key)
        assert other[case]['history'] == got['history']
        np.testing.assert_array_equal(other[case]['predictions'],
                                      got['predictions'])


def test_the_meshes_lay_ranks_out_row_major(four_ranks):
    for rank, result in enumerate(four_ranks):
        assert result['mesh'] == {(2, 2): (rank // 2, rank % 2),
                                  (1, 4): (0, rank)}


def test_capacity_factor_drops_are_counted_and_logged(two_ranks):
    ranks, _, _ = two_ranks
    for result in ranks:
        capacity = result['capacity']
        assert all(np.isfinite(capacity['loss']))
        assert capacity['drops'] > 0
    warnings = ranks[0]['capacity']['warnings']
    assert warnings and 'exceeded the per-shard capacity' in warnings[0]
    assert not ranks[1]['capacity']['warnings']  # logged by model rank 0


def test_saved_model_loads_whole_in_one_process(two_ranks):
    ranks, _, tmp = two_ranks
    model = TDeepModel.load(str(tmp / 'sharded.dt'), device='cpu')
    table = model.module.emb_categorical_vars_all.embeddings_d8
    assert tuple(table.shape) == (sum(torch_ranks.SHARDED_VOCABS), 8)
    X, _ = torch_ranks.sharded_data()
    proba = model.predict({k: v[:torch_ranks.N_PREDICT]
                           for k, v in X.items()}, batch_size=64)
    for result in ranks:
        np.testing.assert_allclose(result['saved_predictions'], proba,
                                   rtol=1e-6, atol=1e-7)


def test_checkpoint_round_trip_on_the_same_mesh(two_ranks):
    ranks, _, _ = two_ranks
    for result in ranks:
        ckpt = result['checkpoint']
        assert ckpt['params_equal'] and ckpt['moments_equal']
        assert ckpt['whole'].shape == (sum(torch_ranks.SHARDED_VOCABS), 8)
        np.testing.assert_array_equal(ckpt['whole'], ckpt['full_table'])


@requires_8
def test_bridged_sharded_a2a_jax_model(two_ranks):
    ranks, case, _ = two_ranks
    # the JAX table's packed rows were padded to the model axis; the bridge
    # dropped them with the other padding rows
    assert case['state_dict']['emb_categorical_vars_all.embeddings_d8'] \
        .shape == (sum(torch_ranks.SHARDED_VOCABS), 8)
    assert case['packed_rows'] % 2 == 0
    for result in ranks:
        np.testing.assert_allclose(result['bridged_logits'],
                                   case['jax_logits'], rtol=1e-5, atol=1e-5)


def test_deeptable_fit_under_a_model_axis(two_ranks):
    ranks, _, _ = two_ranks
    for result in ranks:
        assert 'val_auc' in result['deeptable']['history']
        assert result['deeptable']['proba'].shape == (50, 2)
    np.testing.assert_array_equal(ranks[1]['deeptable']['proba'],
                                  ranks[0]['deeptable']['proba'])


def test_streaming_fit_under_a_model_axis(two_ranks, tmp_path):
    ranks, _, _ = two_ranks
    loss = torch_ranks.stream_fit(torch_ranks._tsv_shards(str(tmp_path)))
    for result in ranks:
        assert np.isfinite(result['stream_loss'][0])
        np.testing.assert_allclose(result['stream_loss'], loss, rtol=1e-4,
                                   atol=1e-6)
