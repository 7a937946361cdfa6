# -*- coding:utf-8 -*-
"""The port's preprocessor, its transformers and its dataset loaders against
the JAX package's, on the CPU (they run on the host only).

The same inputs go through both packages: the loaders' frames from the same
seeds; ``DefaultPreprocessor`` fitted on the same frames under the same
config (the config variants of ``tests/test_preprocessor.py``);
``fit_from_stats`` fed one stats dict (built by the JAX streaming helper).
Everything is held exactly equal: the task, the labels, the column metadata
(names, vocabularies, embedding widths, var-len separators, pooling and
lengths), the fitted transformers' state (vocabularies, imputer fills, bin
edges, scaler ranges, the GBM's trees) and every integer column of the
transformed frames. Float columns and float state are held to rtol 1e-12:
both packages run the same float64 arithmetic in numpy, pandas and
scikit-learn, so they agree to the bit here, and the tolerance admits only
a library's change of summation order. (The GBM features fit gradient
boosting with a fixed ``random_state``: unseeded, it breaks ties between
features at random and two fits build other trees. The JAX package's
encoder fits scikit-learn's, the port's ``models/gbm.py``, whose trees are
held equal here node by node and whose ``gbm_leaf_*`` columns are held
equal bit for bit; ``chip_smoke.py``'s ``GBM_LEAF_DIGESTS`` are recomputed
from the JAX package, and a ``DeepTable`` fit with GBM leaf features in a
subprocess with scikit-learn, pandas, pyarrow and LightGBM blocked is
bit-equal to the same fit with them present.)
"""

import importlib.util
import math
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from deeptables_tpu.data import datasets as jax_datasets
from deeptables_tpu.data import pipeline as jax_pipeline
from deeptables_tpu.data.streaming import ChunkedSource, \
    collect_streaming_stats
from deeptables_tpu.models import ModelConfig as JaxModelConfig
from deeptables_tpu.models import metainfo as jax_metainfo
from deeptables_tpu.models import preprocessor as jax_preprocessor
from deeptables_tpu.models import transformers as jax_transformers
from deeptables_torch.data import datasets, pipeline
from deeptables_torch.models import ModelConfig, metainfo
from deeptables_torch.models import preprocessor, transformers

FLOAT_RTOL = 1e-12

LOADERS = {
    'load_adult': {'n_rows': 300}, 'load_bank': {'n_rows': 300},
    'load_movielens': {'n_rows': 300}, 'load_glass_uci': {},
    'load_boston': {}, 'load_heart_disease_uci': {},
    'load_multilabel_synthetic': {'n_rows': 300},
    'load_criteo_synthetic': {'n_rows': 300},
    'load_avazu_synthetic': {'n_rows': 300}}


@pytest.mark.parametrize('seed', [None, 1])
@pytest.mark.parametrize('name', sorted(LOADERS))
def test_loaders_give_the_same_frames(name, seed):
    kwargs = dict(LOADERS[name], **({} if seed is None else {'seed': seed}))
    pd.testing.assert_frame_equal(getattr(datasets, name)(**kwargs),
                                  getattr(jax_datasets, name)(**kwargs))


def _columns(p):
    """The column metadata of a fitted preprocessor, as plain tuples."""
    return {
        'task': p.task, 'labels': None if p.labels is None else
        [str(v) for v in np.asarray(p.labels).tolist()],
        'categorical': [(c.name, c.vocabulary_size, c.embeddings_output_dim)
                        for c in p.categorical_columns or []],
        'continuous': [(c.name, list(c.column_names))
                       for c in p.continuous_columns or []],
        'var_len': [(c.name, c.vocabulary_size, c.embeddings_output_dim,
                     c.sep, c.pooling_strategy, c.max_elements_length)
                    for c in p.var_len_categorical_columns or []],
        'steps': list(p.X_transformers)}


def _state(obj, depth=0):
    """A fitted transformer's state as plain values: vocabularies, imputer
    fills, bin edges, scaler ranges, and those of the scikit-learn
    estimators inside, by class name and attribute."""
    assert depth < 40
    if isinstance(obj, float) and np.isnan(obj):
        return 'nan'
    if isinstance(obj, (str, bytes, int, float, bool, type(None))):
        return obj
    if isinstance(obj, np.generic):
        return _state(obj.item(), depth + 1)
    if isinstance(obj, np.ndarray):
        return [_state(v, depth + 1) for v in obj.tolist()]
    if isinstance(obj, dict):
        return {str(k): _state(v, depth + 1) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        items = sorted(obj, key=repr) if isinstance(obj, (set, frozenset)) \
            else obj
        return [_state(v, depth + 1) for v in items]
    if isinstance(obj, (pd.Series, pd.Index)):
        return _state(obj.to_numpy(), depth + 1)
    if type(obj).__name__ in GBM_CLASSES:
        return (type(obj).__name__, _gbm_state(obj, depth + 1))
    if type(obj).__module__.startswith(('sklearn', 'deeptables')):
        # (a fitted tree keeps its nodes in what it pickles)
        return (type(obj).__name__, _state(obj.__getstate__(), depth + 1))
    return type(obj).__name__


GBM_CLASSES = ('GradientBoostingClassifier', 'GradientBoostingRegressor')
TREE_ARRAYS = ('children_left', 'children_right', 'feature', 'threshold',
               'value')


def _gbm_state(model, depth):
    """A fitted gradient boosting model (scikit-learn's, or the port's in
    ``models/gbm.py``) as its classes and, tree by tree, the arrays that
    ``apply`` reads and the leaves' values."""
    trees = []
    for row in model.estimators_:
        for est in row:
            tree = getattr(est, 'tree_', est)
            arrays = {f: np.asarray(getattr(tree, f)) for f in TREE_ARRAYS}
            arrays['value'] = arrays['value'].reshape(-1)
            trees.append(_state(arrays, depth + 1))
    return {'classes': _state(getattr(model, 'classes_', None), depth + 1),
            'shape': list(model.estimators_.shape), 'trees': trees}


def _assert_state_equal(port, ref, path=''):
    """Equal states; floats to rtol FLOAT_RTOL."""
    if isinstance(ref, float) and isinstance(port, float):
        assert math.isclose(port, ref, rel_tol=FLOAT_RTOL, abs_tol=0), \
            (path, port, ref)
    elif isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), path
        for k in ref:
            _assert_state_equal(port[k], ref[k], f'{path}/{k}')
    elif isinstance(ref, (list, tuple)):
        assert type(port) is type(ref) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_state_equal(a, b, f'{path}[{i}]')
    else:
        assert port == ref, (path, port, ref)


def _assert_frames_equal(port, ref):
    assert list(port.columns) == list(ref.columns)
    for c in ref.columns:
        a, b = port[c], ref[c]
        assert a.dtype == b.dtype, c
        if b.dtype == object and len(b) and isinstance(b.iloc[0], np.ndarray):
            np.testing.assert_array_equal(np.stack(a.values),
                                          np.stack(b.values), err_msg=c)
        elif b.dtype.kind == 'f':
            np.testing.assert_allclose(a.values, b.values, rtol=FLOAT_RTOL,
                                       atol=0, err_msg=c)
        else:
            np.testing.assert_array_equal(a.values, b.values, err_msg=c)
    np.testing.assert_array_equal(port.index.values, ref.index.values)


def _fit_both(df, y, use_cache=False, **config):
    port = preprocessor.DefaultPreprocessor(ModelConfig(**config),
                                            use_cache=use_cache)
    ref = jax_preprocessor.DefaultPreprocessor(JaxModelConfig(**config),
                                               use_cache=use_cache)
    X_port, y_port = port.fit_transform(df.copy(), np.copy(y))
    X_ref, y_ref = ref.fit_transform(df.copy(), np.copy(y))
    assert _columns(port) == _columns(ref)
    _assert_state_equal(_state(port.X_transformers),
                        _state(ref.X_transformers))
    _assert_frames_equal(X_port, X_ref)
    np.testing.assert_array_equal(y_port, y_ref)
    assert y_port.dtype == y_ref.dtype
    return port, ref


def _adult(n=400, seed=42):
    df = datasets.load_adult(n, seed=seed)
    return df, df.pop(14).values


def test_fit_transform_default_config():
    _fit_both(*_adult())


@pytest.mark.parametrize('config', [
    {'auto_discrete': True, 'auto_imputation': True,
     'auto_encode_label': True, 'auto_categorize': True,
     'apply_gbm_features': False},
    {'categorical_columns': ['x_1', 'x_3', 'x_5'], 'auto_categorize': False},
    {'exclude_columns': ['x_1']},
    {'auto_categorize': True, 'cat_remain_numeric': False},
    {'fixed_embedding_dim': False},
    {'auto_scale': True, 'auto_discrete': True},
    {'embeddings_output_dim': 0}])
def test_fit_transform_config_variants(config):
    _fit_both(*_adult(), **config)


def test_transform_on_held_out_rows_with_unseen_categories():
    df, y = _adult(600)
    config = {'auto_discrete': True, 'auto_categorize': True}
    port, ref = _fit_both(df.iloc[:400], y[:400], **config)
    held = df.iloc[400:].copy()
    held[1] = held[1].where(np.arange(len(held)) % 5 != 0, 'Unseen-work')
    held.loc[held.index[::7], 0] = np.nan
    X_port, y_port = port.transform(held.copy(), np.copy(y[400:]))
    X_ref, y_ref = ref.transform(held.copy(), np.copy(y[400:]))
    _assert_frames_equal(X_port, X_ref)
    np.testing.assert_array_equal(y_port, y_ref)
    # the unseen bucket is the code past the fitted classes
    assert (X_port['x_1'].values[::5] ==
            len(port.X_transformers['label_encoder'].encoders['x_1']
                .classes_)).all()
    _assert_frames_equal(port.transform_X(held.copy()),
                         ref.transform_X(held.copy()))
    np.testing.assert_array_equal(port.transform_y(np.copy(y[400:])),
                                  ref.transform_y(np.copy(y[400:])))
    restored = port.inverse_transform_y(y_port)
    np.testing.assert_array_equal(restored, ref.inverse_transform_y(y_ref))
    np.testing.assert_array_equal(restored, y[400:])


@pytest.mark.parametrize('name,target,config', [
    ('load_bank', 'y', {}),
    ('load_glass_uci', 10, {}),
    ('load_boston', 'target', {'task': 'regression'}),
    ('load_heart_disease_uci', 'target', {'auto_discrete': True}),
    ('load_criteo_synthetic', 'label', {}),
    ('load_avazu_synthetic', 'click', {})])
def test_fit_transform_on_each_schema(name, target, config):
    df = getattr(datasets, name)(**LOADERS[name])
    y = df.pop(target).values
    port, ref = _fit_both(df, y, **config)
    np.testing.assert_array_equal(
        port.inverse_transform_y(port.transform_y(np.copy(y))),
        ref.inverse_transform_y(ref.transform_y(np.copy(y))))


def test_var_len_columns():
    df = datasets.load_movielens(300)
    y = df.pop('rating')
    df = df.drop(columns=['title'])
    port, _ = _fit_both(df, y, task='regression',
                        var_len_categorical_columns=[('genres', '|', 'max')])
    assert port.var_len_categorical_columns[0].max_elements_length >= 1


def test_multilabel_task():
    df = datasets.load_multilabel_synthetic(300)
    labels = [c for c in df.columns if c.startswith('label_')]
    y = df[labels].values
    port, _ = _fit_both(df.drop(columns=labels), y)
    assert port.task == 'multilabel'


def test_int_category_and_bool_columns():
    rng = np.random.default_rng(0)
    n = 300
    df = pd.DataFrame({
        'c_int': pd.Categorical(rng.integers(0, 7, n)),
        'c_str': pd.Categorical(rng.choice(['a', 'b', 'c'], n).astype(object)),
        'flag': rng.integers(0, 2, n).astype(bool),
        'x': rng.normal(size=n)})
    df.loc[::11, 'x'] = np.nan
    port, _ = _fit_both(df, rng.integers(0, 2, n))
    assert len(port.get_categorical_columns()) == 3


def test_auto_discard_unique():
    df, y = _adult(300)
    df[2] = 1  # a constant column
    port, _ = _fit_both(df, y)
    assert 'x_2' not in port.get_categorical_columns() + \
        port.get_continuous_columns()


def test_apply_gbm_features_sklearn_backend():
    df, y = _adult(300)
    held_out, _ = _adult(120, seed=5)
    for feature_type in ('embedding', 'dense'):
        port, ref = _fit_both(df, y, apply_gbm_features=True,
                              gbm_feature_type=feature_type,
                              gbm_params={'n_estimators': 3,
                                          'random_state': 0})
        assert port.X_transformers['gbm_features'].backend == 'sklearn'
        names = port.X_transformers['gbm_features'].new_columns
        assert names == [f'gbm_leaf_{t}' for t in range(3)]
        for rows in (df, held_out):
            X_port = port.transform_X(rows.copy())
            X_ref = ref.transform_X(rows.copy())
            for name in names:
                np.testing.assert_array_equal(np.asarray(X_port[name]),
                                              np.asarray(X_ref[name]),
                                              err_msg=name)


REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize('row', ['bank_deepfm', 'glass_multiclass',
                                 'boston_regression'])
def test_gbm_leaf_digests_are_sklearns(row):
    """chip_smoke.py's GBM_TABLES and GBM_LEAF_DIGESTS: the JAX package's
    preprocessor over scikit-learn gives them on the parity row's train
    split, and so does the port's."""
    from deeptables_torch.data import columns as cl
    from deeptables_torch.tools import parity_quality
    cs = _chip_smoke()
    assert row in cs.GBM_ROWS

    def frame(X):
        return X if cl.is_frame(X) else cl.to_frame(X)
    for module, config in ((jax_preprocessor, JaxModelConfig),
                           (preprocessor, ModelConfig)):
        table, leaves, n_leaves, _ = cs.gbm_leaves(
            module.DefaultPreprocessor, config, parity_quality, row,
            to_frame=frame if module is jax_preprocessor else None)
        assert table == cs.GBM_TABLES[row], module
        assert leaves == cs.GBM_LEAF_DIGESTS[row], module
        assert n_leaves >= 10


def _gbm_option_cases():
    cs = _chip_smoke()
    return [(option, row) for option, (rows, _) in cs.GBM_OPTIONS.items()
            for row in rows]


@pytest.mark.parametrize('option, row', _gbm_option_cases())
def test_gbm_option_digests_are_sklearns(option, row):
    """chip_smoke.py's GBM_OPTION_DIGESTS: each option of scikit-learn's
    gradient boosting in ``gbm_params``, the JAX package's preprocessor over
    scikit-learn gives them on the parity row's train split (the port's
    leaves are held to the JAX encoder's with each option in
    ``test_torch_gbm.py``, and to these digests on the card)."""
    from deeptables_torch.data import columns as cl
    from deeptables_torch.tools import parity_quality
    cs = _chip_smoke()
    params = dict(cs.GBM_PARAMS, **cs.GBM_OPTIONS[option][1])
    table, leaves, n_leaves, _ = cs.gbm_leaves(
        jax_preprocessor.DefaultPreprocessor, JaxModelConfig,
        parity_quality, row, gbm_params=params,
        to_frame=lambda X: X if cl.is_frame(X) else cl.to_frame(X))
    assert table == cs.GBM_TABLES[row]
    assert leaves == cs.GBM_OPTION_DIGESTS[option][row]
    assert n_leaves >= 10


GBM_SCRIPT = r'''
import pickle, sys
MODE, DATA, OUT = sys.argv[1:4]
if MODE == 'blocked':
    for name in ('sklearn', 'pandas', 'pyarrow', 'lightgbm'):
        sys.modules[name] = None
import numpy as np
import torch
from deeptables_torch.models import DeepTable, ModelConfig
with open(DATA, 'rb') as f:
    X, y = pickle.load(f)
out = {}
for feature_type in ('embedding', 'dense'):
    torch.manual_seed(0)
    dt = DeepTable(ModelConfig(
        nets=['linear', 'fm_nets', 'dnn_nets'], apply_gbm_features=True,
        gbm_feature_type=feature_type, embedding_dropout=0, seed=0,
        gbm_params={'n_estimators': 4, 'max_leaf_nodes': 5,
                    'random_state': 0},
        dnn_params={'hidden_units': ((16, 0, False),)}), device='cpu')
    dt.fit(dict(X), y, epochs=1, batch_size=64, verbose=0)
    encoder = dt.preprocessor.X_transformers['gbm_features']
    leaves = encoder.transform(dt.preprocessor.transform_X(dict(X)))
    out[feature_type] = {
        'backend': encoder.backend,
        'leaves': {n: np.asarray(leaves[n]) for n in encoder.new_columns},
        'proba': dt.predict_proba(dict(X)),
        'state': {k: v.numpy() for k, v in
                  dt.get_model().module.state_dict().items()}}
out['modules'] = [m for m in ('sklearn', 'pandas', 'pyarrow')
                  if sys.modules.get(m) is not None]
with open(OUT, 'wb') as f:
    pickle.dump(out, f)
print('ok')
'''


def test_deeptable_gbm_features_without_sklearn(tmp_path):
    """``DeepTable(apply_gbm_features=True)`` with scikit-learn (and pandas,
    pyarrow, LightGBM) blocked is bit-equal to the same fit with them
    present."""
    from deeptables_torch.data import columns as cl
    df, y = _adult(300)
    cols = cl.as_columns(df)
    data = tmp_path / 'data.pkl'
    with open(data, 'wb') as f:  # numpy arrays alone: no pandas type
        pickle.dump(({n: cols[n] for n in cols.columns},
                     np.asarray(y, dtype=object)), f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1',
               PYTHONPATH=str(REPO))
    procs = {mode: subprocess.Popen(
        [sys.executable, '-c', GBM_SCRIPT, mode, str(data),
         str(tmp_path / f'{mode}.pkl')], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mode in ('blocked', 'present')}
    results = {}
    for mode, proc in procs.items():
        try:
            _, stderr = proc.communicate(timeout=240)
        finally:
            proc.kill()
        assert proc.returncode == 0, stderr[-4000:]
        with open(tmp_path / f'{mode}.pkl', 'rb') as f:
            results[mode] = pickle.load(f)
    blocked, present = results['blocked'], results['present']
    assert blocked.pop('modules') == []
    assert 'sklearn' not in present.pop('modules')
    for feature_type, got in blocked.items():
        ref = present[feature_type]
        assert got['backend'] == ref['backend'] == 'sklearn'
        assert list(got['leaves']) == list(ref['leaves'])
        for name, values in ref['leaves'].items():
            np.testing.assert_array_equal(got['leaves'][name], values)
        np.testing.assert_array_equal(got['proba'], ref['proba'])
        assert list(got['state']) == list(ref['state'])
        for k, v in ref['state'].items():
            np.testing.assert_array_equal(got['state'][k], v, err_msg=k)


def test_missing_y_raises():
    df, y = _adult(100)
    y = y.astype(object)
    y[3] = None
    for module in (preprocessor, jax_preprocessor):
        config = ModelConfig() if module is preprocessor else JaxModelConfig()
        with pytest.raises(ValueError, match='Missing values in y'):
            module.DefaultPreprocessor(config, use_cache=False) \
                .fit_transform(df, y)


def test_fit_cache():
    df, y = _adult(400, seed=3)
    first, _ = _fit_both(df, y, use_cache=True)
    again = preprocessor.DefaultPreprocessor(ModelConfig(), use_cache=True)
    X_again, _ = again.fit_transform(df.copy(), np.copy(y))
    X_first = first.transform_X(df.copy())
    assert _columns(again) == _columns(first)
    assert list(X_again.columns) == list(X_first.columns)
    # the cache keys on signature_fields: another config fits anew
    other = preprocessor.DefaultPreprocessor(
        ModelConfig(exclude_columns=['x_1']), use_cache=True)
    other.fit_transform(df.copy(), np.copy(y))
    assert 'x_1' not in other.get_categorical_columns()
    assert other.signature != first.signature


@pytest.mark.parametrize('config', [
    {}, {'auto_discrete': True, 'auto_scale': True},
    {'auto_categorize': True, 'cat_remain_numeric': True}])
def test_fit_from_stats(config):
    df, y = _adult(500, seed=9)
    df.loc[df.index[::13], 0] = np.nan
    df.columns = [f'x_{c}' for c in df.columns]  # a stream's named columns
    df['y'] = y
    col_stats, y_stats, n_rows = collect_streaming_stats(
        ChunkedSource(df, chunk_size=128), 'y', JaxModelConfig(**config))
    port = preprocessor.DefaultPreprocessor(ModelConfig(**config))
    ref = jax_preprocessor.DefaultPreprocessor(JaxModelConfig(**config))
    port.fit_from_stats(col_stats, y_stats, n_rows)
    ref.fit_from_stats(col_stats, y_stats, n_rows)
    assert _columns(port) == _columns(ref)
    _assert_state_equal(_state(port.X_transformers),
                        _state(ref.X_transformers))
    X = df.drop(columns=['y'])
    _assert_frames_equal(port.transform_X(X.copy()), ref.transform_X(X.copy()))


def test_extract_arrays_on_the_transformed_frame():
    """The seam to DeepModel: the arrays the port's pipeline takes from the
    port's frame are those the JAX package takes from its own."""
    df, y = _adult(400)
    port, ref = _fit_both(df, y, auto_discrete=True)
    X_port, X_ref = port.transform_X(df.copy()), ref.transform_X(df.copy())
    arrays = pipeline.extract_arrays(
        X_port, port.categorical_columns, port.continuous_columns,
        port.var_len_categorical_columns)
    expected = jax_pipeline.extract_arrays(
        X_ref, ref.categorical_columns, ref.continuous_columns,
        ref.var_len_categorical_columns)
    assert list(arrays) == list(expected)
    for k in expected:
        assert arrays[k].dtype == expected[k].dtype, k
        np.testing.assert_array_equal(arrays[k], expected[k], err_msg=k)


def test_preprocessor_builds_the_ports_column_records():
    port, _ = _fit_both(*_adult(200))
    assert all(isinstance(c, metainfo.CategoricalColumn)
               for c in port.categorical_columns)
    assert all(isinstance(c, metainfo.ContinuousColumn)
               for c in port.continuous_columns)
    assert not any(isinstance(c, jax_metainfo.CategoricalColumn)
                   for c in port.categorical_columns)


def test_gbm_leaf_codes_match():
    classes = np.array([3, 7, 11])
    col = np.array([7, 3, 11, 5, 99])
    codes = transformers.GbmLeavesEncoder._leaf_codes(classes, col)
    np.testing.assert_array_equal(
        codes, jax_transformers.GbmLeavesEncoder._leaf_codes(classes, col))
    assert codes.dtype == np.int32


def test_quantile_bin_edges_match():
    rng = np.random.default_rng(4)
    values = np.sort(rng.normal(size=50))
    counts = rng.integers(1, 9, 50)
    for n_bins in (2, 5, 11):
        np.testing.assert_array_equal(
            transformers.quantile_bin_edges(values, counts, n_bins),
            jax_transformers.quantile_bin_edges(values, counts, n_bins))


def test_infer_task_type_matches():
    rng = np.random.default_rng(1)
    for y in (rng.integers(0, 2, 50), rng.normal(size=50),
              rng.integers(0, 5, 50), np.array(['a', 'b', 'c'] * 10),
              rng.integers(0, 2, (50, 3))):
        task, labels = preprocessor.infer_task_type(y)
        ref_task, ref_labels = jax_preprocessor.infer_task_type(y)
        assert task == ref_task
        np.testing.assert_array_equal(labels, ref_labels)

