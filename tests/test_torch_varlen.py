# -*- coding:utf-8 -*-
"""Var-len categorical columns in the port (``VarLenColumnEmbedding``)
against the JAX package, on the CPU (mirrors
tests/test_var_len_categorical.py):

- the layer alone, in its three poolings (``max``, ``avg``, ``flat``), on
  ids from a numpy seed with padding (id 0) and a row without tokens: the
  pooled output, and the table's gradient (the port's through K1's plain
  twin) against JAX's on its lane-packed table, unpacked: rtol 1e-5 with
  1e-6 of the largest value (float32, only the order of sums differs);
- a model with two var-len columns beside the categorical ones, bridged from
  a JAX ``DeepModel``: logits and one step's gradients, by the rules of
  tests/test_torch_nets.py; in ``max`` and ``avg`` their fields stack onto
  the categorical ones (in the JAX package's field order), in ``flat`` the
  widths differ and nothing stacks;
- ``DeepTable`` on movielens genres in every pooling, an unseen token, and
  ``Predictor.warmup`` over the var-len input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.ops.embedding import \
    VarLenColumnEmbedding as JaxVarLenEmbedding
from deeptables_torch.ops.embedding import VarLenColumnEmbedding
from test_torch_nets import SMALL, check_against_jax
from torch_parity import Case

POOLINGS = ['max', 'avg', 'flat']


def _ids(B, L, vocab, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, L + 1, B)
    lengths[0] = 0  # a row without tokens
    ids = rng.integers(1, vocab, (B, L))
    ids[np.arange(L)[None] >= lengths[:, None]] = 0
    ids[1, :2] = [3, 3]  # a token twice in one row: a tie under max
    return ids.astype(np.int32)


@pytest.mark.parametrize('pooling', POOLINGS)
def test_var_len_embedding_matches_jax(pooling):
    B, L, vocab, dim = 24, 5, 11, 8
    ids = _ids(B, L, vocab, seed=0)
    layer = JaxVarLenEmbedding(vocabulary_size=vocab, output_dim=dim,
                               pooling_strategy=pooling)
    params = layer.init(jax.random.PRNGKey(0), ids)['params']
    packed = np.array(params['embeddings'])
    logical = packed.reshape(-1, dim)[:vocab]
    expected, vjp = jax.vjp(lambda p: layer.apply({'params': p}, ids),
                            {'embeddings': jnp.asarray(packed)})
    g = np.random.default_rng(1).normal(size=expected.shape).astype(
        np.float32)
    (dtable,) = jax.tree_util.tree_leaves(vjp(jnp.asarray(g)))

    port = VarLenColumnEmbedding(vocab, dim, pooling_strategy=pooling)
    with torch.no_grad():
        port.embeddings.copy_(torch.from_numpy(logical))
    out = port(torch.from_numpy(ids))
    assert out.shape == expected.shape
    np.testing.assert_allclose(out.detach().numpy(), expected, rtol=1e-5,
                               atol=1e-6)
    if pooling != 'flat':
        assert not out[0].any()  # the row without tokens
    out.backward(torch.from_numpy(g))
    dlogical = np.asarray(dtable).reshape(-1, dim)[:vocab]
    np.testing.assert_allclose(port.embeddings.grad.numpy(), dlogical,
                               rtol=1e-5,
                               atol=1e-6 * float(np.abs(dlogical).max()))
    assert not port.embeddings.grad[0].any()  # padding gets no gradient


def test_var_len_embedding_rejects_unknown_pooling():
    with pytest.raises(ValueError, match='pooling'):
        VarLenColumnEmbedding(5, 4, pooling_strategy='sum')


def test_out_of_range_tokens_are_refused_on_the_host():
    """A token past the vocabulary would abort a CUDA gather: the model
    checks the ids before they reach the device."""
    case = Case('nonascending_d8', nets=['dnn_nets'],
                var_len=[('genres', 13, 8, 'max', 4)], **SMALL)
    batch = case.batch(8)
    batch['genres'][3, 1] = 13
    with pytest.raises(ValueError, match="var-len column 'genres'"):
        case.port_model().to_device(batch)


@pytest.mark.parametrize('pooling', POOLINGS)
def test_model_with_var_len_columns_matches_jax(pooling):
    var_len = [('genres', 13, 8, pooling, 4), ('tags', 30, 8, pooling, 3)]
    nets = ['dnn_nets'] if pooling == 'flat' else \
        ['linear', 'fm_nets', 'pnn_nets', 'dnn_nets']
    case = Case('nonascending_d8', nets=nets, var_len=var_len, **SMALL)
    port = check_against_jax(case)
    order = port.module._field_order
    if pooling == 'flat':
        assert order is None  # the widths differ: no field is stacked
    else:
        # the JAX plan's categorical order, then the two var-len fields
        assert order == case.field_order() + [5, 6]


# ------------------------------------------------ DeepTable on movielens

def _movielens(n):
    pytest.importorskip('pandas')
    from deeptables_torch.data.datasets import load_movielens
    df = load_movielens(n)
    y = df.pop('rating')
    return df.drop(columns=['title', 'timestamp']), y


@pytest.mark.parametrize('pooling', POOLINGS)
def test_movielens_genres(pooling):
    from deeptables_torch.models import DeepTable, ModelConfig
    df, y = _movielens(800)
    conf = ModelConfig(
        nets=['dnn_nets'], task='regression', metrics=['mse'],
        var_len_categorical_columns=[('genres', '|', pooling)],
        embedding_dropout=0)
    dt = DeepTable(config=conf, device='cpu')
    dt.fit(df, y, epochs=1, verbose=0)
    assert dt.preprocessor.var_len_categorical_columns[0] \
        .max_elements_length >= 1
    pred = dt.predict(df.head(50))
    assert pred.shape[0] == 50
    assert np.isfinite(np.asarray(pred, dtype=float)).all()


def test_var_len_unseen_token_and_warmup():
    from deeptables_torch.models import DeepTable, ModelConfig
    from deeptables_torch.serving import Predictor
    df, y = _movielens(400)
    conf = ModelConfig(
        nets=['linear', 'fm_nets', 'dnn_nets'], task='regression',
        metrics=['mse'], var_len_categorical_columns=[('genres', '|', 'max')])
    dt = DeepTable(config=conf, device='cpu')
    dt.fit(df, y, epochs=1, verbose=0)
    df2 = df.head(10).copy()
    df2.loc[:, 'genres'] = 'UnknownGenre|Drama'
    pred = dt.predict(df2)
    assert np.isfinite(np.asarray(pred, dtype=float)).all()
    predictor = Predictor(dt, batch_buckets=(1, 8)).warmup()
    np.testing.assert_allclose(predictor.predict_proba(df2).reshape(-1),
                               np.asarray(pred, float).reshape(-1),
                               rtol=1e-5)
