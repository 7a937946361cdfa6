# -*- coding:utf-8 -*-
"""The port's own copies of the JAX package's host code: constants, column
schema, ``ModelConfig``, the input pipeline and the criteo-style and
avazu-style synthetic data. They must agree exactly with the originals."""

import dataclasses

import numpy as np
import pytest
import torch

from deeptables_tpu.data import datasets as jax_datasets
from deeptables_tpu.data import pipeline as jax_pipeline
from deeptables_tpu.models import config as jax_config
from deeptables_tpu.models import deepnets as jax_deepnets
from deeptables_tpu.models import metainfo as jax_metainfo
from deeptables_tpu.utils import consts as jax_consts
from deeptables_torch.data import datasets, pipeline
from deeptables_torch.models import config, deepmodel, deepnets, metainfo
from deeptables_torch.utils import consts


def test_constants_match():
    for name in dir(consts):
        if name.isupper():
            assert getattr(consts, name) == getattr(jax_consts, name), name


def test_model_config_fields_and_defaults_match():
    port = {f.name: f for f in dataclasses.fields(config.ModelConfig)}
    ref = {f.name: f for f in dataclasses.fields(jax_config.ModelConfig)}
    assert list(port) == list(ref)
    a, b = config.ModelConfig(), jax_config.ModelConfig()
    for name in port:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize('fields', [
    {}, {'exclude_columns': ['a']}, {'task': 'binary', 'cat_exponent': 0.3},
    {'categorical_columns': ['x', 'y'], 'gbm_params': {'n_estimators': 3}},
    {'fixed_embedding_dim': False, 'embeddings_output_dim': 8}])
def test_model_config_signature_fields_match(fields):
    """The preprocessor's fit-cache key."""
    assert config.ModelConfig(**fields).signature_fields() == \
        jax_config.ModelConfig(**fields).signature_fields()


def test_model_config_normalizes_nets():
    cfg = config.ModelConfig(nets=deepnets.DeepFM + ['linear'])
    assert cfg.nets == ('linear', 'fm_nets', 'dnn_nets')
    assert cfg._replace(seed=1).seed == 1


def test_every_builtin_net_is_known():
    assert list(deepnets._BUILTIN) == list(jax_deepnets._BUILTIN)
    for preset in ('WideDeep', 'DeepFM', 'xDeepFM', 'AutoInt', 'DCN',
                   'FGCNN', 'FiBiNet', 'PNN', 'AFM'):
        assert getattr(deepnets, preset) == getattr(jax_deepnets, preset)


@pytest.mark.parametrize('name', [n for n in jax_deepnets._BUILTIN
                                  if n not in ('linear', 'fm_nets',
                                               'cin_nets', 'autoint_nets',
                                               'dnn_nets')])
def test_unported_nets_name_their_slice(name):
    # every builder that once raised, naming the slice that would port it,
    # now builds its net (none is left unported)
    inputs = deepnets.NetInputs(4, 8, 32, 3, 35)
    net = deepnets.get(name)(inputs, config.ModelConfig(),
                             deepmodel.ModelDesc(), None)
    assert isinstance(net, torch.nn.Module) and net.output_dim >= 1


def test_columns_match():
    for port_cls, ref_cls, args in (
            (metainfo.CategoricalColumn, jax_metainfo.CategoricalColumn,
             ('c', 300, 0)),
            (metainfo.ContinuousColumn, jax_metainfo.ContinuousColumn,
             ('all', ['a', 'b'])),
            (metainfo.VarLenCategoricalColumn,
             jax_metainfo.VarLenCategoricalColumn, ('v', 20, 4))):
        assert tuple(port_cls(*args)) == tuple(ref_cls(*args))
        assert port_cls._fields == ref_cls._fields


@pytest.mark.parametrize('seed', [2024, 7])
def test_criteo_synthetic_is_bit_identical(seed):
    port = datasets.load_criteo_synthetic(n_rows=500, seed=seed,
                                          return_arrays=True)
    ref = jax_datasets.load_criteo_synthetic(n_rows=500, seed=seed,
                                             return_arrays=True)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    df = datasets.load_criteo_synthetic(n_rows=50, seed=seed)
    ref_df = jax_datasets.load_criteo_synthetic(n_rows=50, seed=seed)
    assert list(df.columns) == list(ref_df.columns)
    np.testing.assert_array_equal(df.to_numpy(), ref_df.to_numpy())


@pytest.mark.parametrize('seed', [31, 7])
def test_avazu_synthetic_is_bit_identical(seed):
    pytest.importorskip('pandas')
    df = datasets.load_avazu_synthetic(n_rows=600, seed=seed)
    ref = jax_datasets.load_avazu_synthetic(n_rows=600, seed=seed)
    assert list(df.columns) == list(ref.columns)
    assert list(df.dtypes) == list(ref.dtypes)
    np.testing.assert_array_equal(df.to_numpy(), ref.to_numpy())
    # the numpy columns that the DataFrame is built from
    fields, click = datasets._avazu_fields(n_rows=600, seed=seed)
    assert list(fields) == list(ref.columns[1:])
    np.testing.assert_array_equal(click, ref['click'].to_numpy())
    for name, column in fields.items():
        assert column.dtype == ref[name].dtype
        np.testing.assert_array_equal(column, ref[name].to_numpy())


@pytest.mark.parametrize('n,batch_size,shuffle,drop,pad_multiple', [
    (37, 16, False, False, 1), (37, 16, True, True, 1),
    (10, 16, False, False, 4), (64, 16, True, True, 1)])
def test_batch_iterator_matches(n, batch_size, shuffle, drop, pad_multiple):
    rng = np.random.default_rng(n)
    arrays = {'cat': rng.integers(0, 9, (n, 3)).astype(np.int32),
              'dense': rng.normal(size=(n, 2)).astype(np.float32)}
    y = rng.integers(0, 2, n).astype(np.float32)
    w = rng.uniform(size=n).astype(np.float32)
    kwargs = dict(batch_size=batch_size, shuffle=shuffle,
                  drop_remainder=drop, seed=3, pad_multiple=pad_multiple)
    port = pipeline.BatchIterator(arrays, y, w, **kwargs)
    ref = jax_pipeline.BatchIterator(arrays, y, w, **kwargs)
    assert port.steps == ref.steps
    for (b, yb, wb, valid), (rb, ryb, rwb, rvalid) in zip(port, ref):
        assert valid == rvalid
        for k in arrays:
            np.testing.assert_array_equal(b[k], rb[k])
        np.testing.assert_array_equal(yb, ryb)
        np.testing.assert_array_equal(wb, rwb)


def test_labels_and_batch_counts_match():
    y = np.array([0, 1, 2, 1])
    for task in ('binary', 'multiclass', 'regression', 'multilabel'):
        a = pipeline.prepare_labels(y, task, 3)
        b = jax_pipeline.prepare_labels(y, task, 3)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for n, bs, drop in ((10, 4, True), (10, 4, False), (3, 4, True)):
        assert pipeline.num_batches(n, bs, drop) == \
            jax_pipeline.num_batches(n, bs, drop)


def test_extract_arrays_matches():
    pd = pytest.importorskip('pandas')
    X = pd.DataFrame({'a': [1, 2, 0], 'b': [3, 0, 1],
                      'x': [0.5, np.nan, 2.0], 'z': [1.0, 2.0, 3.0]})
    cats = [metainfo.CategoricalColumn('a', 4), metainfo.CategoricalColumn('b', 4)]
    conts = [metainfo.ContinuousColumn('all', ['x', 'z'])]
    port = pipeline.extract_arrays(X, cats, conts)
    ref = jax_pipeline.extract_arrays(
        X, [jax_metainfo.CategoricalColumn('a', 4),
            jax_metainfo.CategoricalColumn('b', 4)],
        [jax_metainfo.ContinuousColumn('all', ['x', 'z'])])
    assert list(port) == list(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(port[k], ref[k])


def test_out_of_range_ids_are_refused_before_the_device():
    cats = [metainfo.CategoricalColumn('a', 4), metainfo.CategoricalColumn('b', 2)]
    pipeline.check_categorical_ids(np.array([[3, 1]]), cats)
    for bad in ([[4, 0]], [[0, -1]], [[0, 2]]):
        with pytest.raises(ValueError, match='out of range'):
            pipeline.check_categorical_ids(np.array(bad), cats)
    with pytest.raises(ValueError, match='shape'):
        pipeline.check_categorical_ids(np.zeros((2, 3), np.int32), cats)
