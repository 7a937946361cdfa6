# -*- coding:utf-8 -*-
"""The port's estimator layer on numpy columns against the JAX package's on
pandas, on the CPU.

- The preprocessor: the port's ``DefaultPreprocessor`` fed a dict of 1-D
  numpy arrays against the JAX package's fed the DataFrame of the same
  columns, on the adult, bank, criteo-style, avazu-style, multilabel and
  movielens (a var-len column) schemas, a table with missing values in
  every kind of column and one with a ``category`` column of integers.
  Held exactly equal: the task, the labels, the column metadata, the
  fitted transformers' state (the imputer's blocks, vocabularies, bin
  edges), every integer column and the var-len ids, on the fitted rows and
  on held-out rows; continuous columns within 1e-6 relative, float state
  within ``test_torch_preprocessor``'s 1e-12 (both run the same float64
  arithmetic in the same order). The port fed the DataFrame gives the
  DataFrame of what it gives for the dict.
- The loaders without pandas (blocked in ``sys.modules``): the JAX
  loaders' columns, value for value, with pandas' dtypes as the kinds.
- The conversions the preprocessor rests on: ``as_str`` against
  ``Series.astype(str)``, ``nunique`` and ``to_float`` against pandas.
- ``KFold`` and ``StratifiedKFold`` against scikit-learn's (hypothesis:
  sizes, fold counts, seeds, class mixes with a rare class).
- ``write_csv`` against ``DataFrame.to_csv(index=False)``.
"""

import sys

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings, strategies as st

from deeptables_tpu.data import datasets as jax_datasets
from deeptables_tpu.models import ModelConfig as JaxModelConfig
from deeptables_tpu.models import preprocessor as jax_preprocessor
from deeptables_torch.data import columns as cl
from deeptables_torch.data import datasets, split
from deeptables_torch.models import ModelConfig, preprocessor
from deeptables_torch.models.deeptable import write_csv
from test_torch_preprocessor import _assert_state_equal, _columns, _state

RTOL = 1e-6


def _assert_columns_match_frame(cols, frame):
    """The port's columns against the JAX package's DataFrame."""
    assert isinstance(cols, cl.Columns)
    assert cols.columns == list(frame.columns)
    for c in frame.columns:
        ours, ref = cols[c], frame[c]
        if ref.dtype == object and len(ref) and \
                isinstance(ref.iloc[0], np.ndarray):
            np.testing.assert_array_equal(ours, np.stack(ref.values),
                                          err_msg=c)
        elif ref.dtype.kind == 'f' or (ref.dtype == object and len(ref) and
                                       isinstance(ref.iloc[0], float)):
            np.testing.assert_allclose(ours.astype(np.float64),
                                       ref.to_numpy(np.float64), rtol=RTOL,
                                       atol=0, err_msg=c)
        else:
            assert ours.dtype == ref.dtype, c
            np.testing.assert_array_equal(ours, ref.to_numpy(), err_msg=c)
    np.testing.assert_array_equal(np.asarray(cols.index), frame.index.values)


def _as_dict(frame):
    """The DataFrame's columns as a dict of 1-D numpy arrays: text as a
    numpy unicode array (object where values are missing), a categorical
    as pandas.Categorical (a dict value pandas takes as it is)."""
    out = {}
    for c in frame.columns:
        s = frame[c]
        if isinstance(s.dtype, pd.CategoricalDtype):
            out[c] = s
        elif str(s.dtype) == 'str':
            values = s.to_numpy(dtype=object)
            out[c] = values.astype(str) if not s.isna().any() else values
        else:
            out[c] = s.to_numpy()
    return out


def _fit(frame, y, held=None, **config):
    """Fit the JAX preprocessor on the frame and the port's on the dict of
    its columns, and on the frame; compare everything."""
    port = preprocessor.DefaultPreprocessor(ModelConfig(**config),
                                            use_cache=False)
    ref = jax_preprocessor.DefaultPreprocessor(JaxModelConfig(**config),
                                               use_cache=False)
    X_ref, y_ref = ref.fit_transform(frame.copy(), np.copy(y))
    X_port, y_port = port.fit_transform(_as_dict(frame), np.copy(y))
    assert _columns(port) == _columns(ref)
    _assert_state_equal(_state(port.X_transformers),
                        _state(ref.X_transformers))
    # the dict's columns carry no index: compare on the frame's RangeIndex
    X_port.index = frame.index
    _assert_columns_match_frame(X_port, X_ref)
    np.testing.assert_array_equal(y_port, y_ref)
    assert y_port.dtype == y_ref.dtype
    # the port fed the DataFrame: the frame of what the dict gave
    framed = preprocessor.DefaultPreprocessor(ModelConfig(**config),
                                              use_cache=False)
    X_framed, _ = framed.fit_transform(frame.copy(), np.copy(y))
    pd.testing.assert_frame_equal(X_framed, cl.to_frame(X_port))
    if held is not None:
        X_held = port.transform_X(_as_dict(held))
        X_held.index = held.index
        _assert_columns_match_frame(X_held, ref.transform_X(held.copy()))
        X_held, _ = port.transform(_as_dict(held), y[:len(held)])
        X_held.index = held.index
        _assert_columns_match_frame(
            X_held, ref.transform(held.copy(), y[:len(held)])[0])
    return port, ref


def _split(frame, target):
    y = frame.pop(target)
    return frame, y.to_numpy() if hasattr(y, 'to_numpy') else y


@pytest.mark.parametrize('name,target,config', [
    ('load_adult', 14, {}),
    ('load_adult', 14, {'auto_discrete': True, 'auto_categorize': True,
                        'auto_scale': True}),
    ('load_bank', 'y', {}),
    ('load_bank', 'y', {'auto_categorize': True,
                        'cat_remain_numeric': False}),
    ('load_criteo_synthetic', 'label',
     {'categorical_columns': [f'C{i}' for i in range(1, 27)]}),
    ('load_criteo_synthetic', 'label', {}),
    ('load_avazu_synthetic', 'click', {}),
    ('load_glass_uci', 10, {}),
    ('load_boston', 'target', {'task': 'regression'})])
def test_preprocessor_on_columns_matches_jax(name, target, config):
    frame, y = _split(getattr(jax_datasets, name)(n_rows=400), target)
    _fit(frame.iloc[:300].reset_index(drop=True), y[:300],
         held=frame.iloc[300:], **config)


def test_multilabel_on_columns_matches_jax():
    frame = jax_datasets.load_multilabel_synthetic(300)
    labels = [c for c in frame.columns if c.startswith('label_')]
    port, _ = _fit(frame.drop(columns=labels), frame[labels].to_numpy())
    assert port.task == 'multilabel'


def test_var_len_on_columns_matches_jax():
    frame = jax_datasets.load_movielens(300)
    y = frame.pop('rating').to_numpy()
    frame = frame.drop(columns=['title'])
    frame.loc[::17, 'genres'] = np.nan
    port, _ = _fit(frame.iloc[:250], y[:250], held=frame.iloc[250:],
                   task='regression',
                   var_len_categorical_columns=[('genres', '|', 'max')])
    assert port.var_len_categorical_columns[0].max_elements_length == 3


def _messy(n, seed):
    """Missing values in every kind of column."""
    rng = np.random.default_rng(seed)
    frame = pd.DataFrame({
        'text': rng.choice(['a', 'b', 'c', 'd'], n).astype(object),
        'ints': rng.integers(0, 1000, n).astype(float),
        'reals': rng.normal(3, 2, n),
        'f32': rng.normal(0, 1, n).astype(np.float32),
        'small': rng.integers(0, 6, n).astype(float),
        'flag': rng.integers(0, 2, n).astype(bool),
        'levels': pd.Categorical(rng.integers(0, 3, n)),
        'codes': rng.integers(0, 9, n)})
    frame.loc[frame.index[::7], 'text'] = np.nan
    frame.loc[frame.index[3::11], 'ints'] = np.nan
    frame.loc[frame.index[5::13], 'reals'] = np.nan
    frame.loc[frame.index[2::9], 'f32'] = np.nan
    frame['text'] = frame['text'].astype('str')
    return frame, rng.integers(0, 2, n)


@pytest.mark.parametrize('config', [
    {}, {'auto_discrete': True, 'auto_scale': True},
    {'categorical_columns': ['text', 'codes', 'flag']},
    {'exclude_columns': ['reals']}])
def test_missing_values_in_every_kind_match_jax(config):
    frame, y = _messy(400, 5)
    held = frame.iloc[300:].copy()
    held.loc[held.index[::4], 'small'] = np.nan
    held.loc[held.index[1::4], 'codes'] = 99  # unseen
    _fit(frame.iloc[:300], y[:300], held=held, **config)


def test_a_bool_block_alone_is_refused_as_by_jax():
    """scikit-learn's imputer refuses a block of bool columns alone (they
    take the numeric fill); the port refuses it too."""
    frame = pd.DataFrame({'flag': np.arange(40) % 3 == 0,
                          'x': np.linspace(0, 1, 40)})
    y = np.arange(40) % 2
    for module, config in ((preprocessor, ModelConfig),
                           (jax_preprocessor, JaxModelConfig)):
        with pytest.raises(ValueError, match='dtype bool'):
            module.DefaultPreprocessor(config(), use_cache=False) \
                .fit_transform(frame.copy(), y)


@pytest.mark.parametrize('with_missing', [False, True])
def test_int_category_column_matches_jax(with_missing):
    rng = np.random.default_rng(2)
    n = 300
    codes = rng.integers(0, 7, n).astype(float)
    if with_missing:
        codes[::10] = np.nan
    frame = pd.DataFrame({
        'c_int': pd.Categorical(codes),
        'c_str': pd.Categorical(rng.choice(['x', 'y', 'z'], n)),
        'other_int': pd.Categorical(rng.integers(0, 4, n)),
        'x': rng.normal(size=n)})
    port, _ = _fit(frame, rng.integers(0, 2, n))
    assert port.get_categorical_columns() == ['c_int', 'c_str', 'other_int']


def test_two_dimensional_array_matches_jax():
    """A 2-D array: columns x_0.. (renamed), one dtype."""
    rng = np.random.default_rng(4)
    values = np.column_stack([rng.integers(0, 5, 200),
                              rng.normal(size=200), rng.normal(size=200)])
    y = rng.integers(0, 2, 200)
    port = preprocessor.DefaultPreprocessor(ModelConfig(), use_cache=False)
    ref = jax_preprocessor.DefaultPreprocessor(JaxModelConfig(),
                                               use_cache=False)
    X_port, _ = port.fit_transform(values, y)
    X_ref, _ = ref.fit_transform(pd.DataFrame(values), y)
    assert _columns(port) == _columns(ref)
    X_port.index = X_ref.index
    _assert_columns_match_frame(X_port, X_ref)


def test_fit_cache_keys_on_the_column_values():
    frame, y = _split(jax_datasets.load_bank(200), 'y')
    first = preprocessor.DefaultPreprocessor(ModelConfig())
    X_first, _ = first.fit_transform(_as_dict(frame), y)
    again = preprocessor.DefaultPreprocessor(ModelConfig())
    X_again, _ = again.fit_transform(frame.copy(), y)  # same values: a hit
    assert _columns(again) == _columns(first)
    pd.testing.assert_frame_equal(X_again, cl.to_frame(X_first))
    changed = _as_dict(frame)
    changed['age'] = changed['age'] + 1
    assert first.get_X_y_signature(changed, y) != \
        first.get_X_y_signature(_as_dict(frame), y)


# ---------------------------------------------------------------- loaders

@pytest.mark.parametrize('name', ['load_adult', 'load_bank',
                                  'load_movielens', 'load_glass_uci',
                                  'load_boston', 'load_heart_disease_uci',
                                  'load_criteo_synthetic',
                                  'load_avazu_synthetic',
                                  'load_multilabel_synthetic'])
def test_loaders_give_the_jax_columns_without_pandas(name, monkeypatch):
    kwargs = {} if name in ('load_glass_uci', 'load_boston',
                            'load_heart_disease_uci') else {'n_rows': 200}
    with monkeypatch.context() as blocked:
        blocked.setitem(sys.modules, 'pandas', None)
        cols = getattr(datasets, name)(**kwargs)
    ref = getattr(jax_datasets, name)(**kwargs)
    assert isinstance(cols, cl.Columns)
    assert cols.columns == list(ref.columns)
    for c in ref.columns:
        assert cols.kinds[c] == str(ref[c].dtype), c
        np.testing.assert_array_equal(
            cols[c], ref[c].to_numpy(dtype=object) if cols.kinds[c] == 'str'
            else ref[c].to_numpy(), err_msg=str(c))
    pd.testing.assert_frame_equal(cl.to_frame(cols), ref)


# ---------------------------------------------------------------- conversions

def test_as_str_matches_pandas():
    rng = np.random.default_rng(0)
    reals = np.concatenate([
        rng.normal(size=20), 10.0 ** rng.integers(-20, 22, 30)
        * rng.normal(size=30), [0.0, -0.0, 1e16, 1e15, 123456789012345.6,
                                0.1 + 0.2, 1e-5, 5e-324]])
    cases = [reals, reals.astype(np.float32), rng.integers(-9, 9, 20),
             np.array([True, False]), np.array(['a', 'bb'], dtype=object),
             np.array([1, 2.5, 'x', True, np.float32(0.1)], dtype=object)]
    for values in cases:
        expected = pd.Series(values).astype(str).to_numpy(dtype=object)
        np.testing.assert_array_equal(cl.as_str(values).astype(object),
                                      expected)
    # missing values: 'nan' where pandas 3 keeps them missing
    values = np.array(['a', None, np.nan, 3.5], dtype=object)
    assert cl.as_str(values).tolist() == ['a', 'nan', 'nan', '3.5']


def test_nunique_unique_and_to_float_match_pandas():
    rng = np.random.default_rng(1)
    floats = rng.integers(0, 9, 100).astype(float)
    floats[::5] = np.nan
    objects = np.array(['a', None, 'b', np.nan, 'a', 1, 1.0, True],
                       dtype=object)
    for values in (floats, objects, rng.integers(0, 4, 50)):
        s = pd.Series(values)
        assert cl.nunique(values) == s.nunique()
        assert list(cl.unique(values)) == list(pd.unique(s.dropna()))
    text = np.array(['1.5', 'x', None, '7', 3], dtype=object)
    np.testing.assert_array_equal(
        cl.to_float(text), pd.to_numeric(pd.Series(text), errors='coerce')
        .to_numpy(np.float64))


def test_as_columns_conversions():
    frame = pd.DataFrame({0: [1, 2], 1: ['a', None]})
    with pytest.raises(ValueError, match='duplicate'):
        cl.as_columns(pd.concat([frame, frame], axis=1))
    cols = cl.as_columns(frame)
    assert cols.columns == ['x_0', 'x_1']
    assert cols.kinds == {'x_0': 'int64', 'x_1': 'str'}
    assert cols['x_1'][0] == 'a' and np.isnan(cols['x_1'][1])
    cols = cl.as_columns({'t': np.array(['a', 'b']),
                          'o': np.array([1, 'b'], dtype=object)})
    assert cols.kinds == {'t': 'str', 'o': 'object'}
    assert cl.as_columns(np.zeros((3, 2))).columns == ['x_0', 'x_1']
    assert cl.as_columns({'a': [1, 2]}).shape == (2, 1)


# ---------------------------------------------------------------- folds

@settings(max_examples=40, deadline=None)
@given(n=st.integers(6, 300), k=st.integers(2, 6),
       seed=st.integers(0, 2 ** 31 - 1), weights=st.lists(
           st.integers(1, 20), min_size=2, max_size=5),
       rare=st.booleans())
def test_folds_match_sklearn(n, k, seed, weights, rare):
    from sklearn.model_selection import KFold, StratifiedKFold
    if k > n:
        k = n
    rng = np.random.default_rng(seed)
    p = np.asarray(weights, float) / sum(weights)
    y = rng.choice(len(weights), n, p=p)
    if rare:
        y[rng.integers(0, n)] = len(weights)  # one member alone
    X = np.zeros((n, 1))
    for shuffle, state in ((True, seed), (False, None)):
        ours = [(a.tolist(), b.tolist()) for a, b in split.KFold(
            k, shuffle=shuffle, random_state=state).split(X)]
        ref = [(a.tolist(), b.tolist()) for a, b in KFold(
            k, shuffle=shuffle, random_state=state).split(X)]
        assert ours == ref
        labels = np.array(['c%d' % v for v in y])
        try:
            ref = [(a.tolist(), b.tolist()) for a, b in StratifiedKFold(
                k, shuffle=shuffle, random_state=state).split(X, labels)]
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:20]):
                list(split.StratifiedKFold(
                    k, shuffle=shuffle, random_state=state).split(X, labels))
            continue
        ours = [(a.tolist(), b.tolist()) for a, b in split.StratifiedKFold(
            k, shuffle=shuffle, random_state=state).split(X, labels)]
        assert ours == ref


def test_stratified_folds_refuse_continuous_targets():
    with pytest.raises(ValueError, match='continuous'):
        list(split.StratifiedKFold(3).split(np.zeros(9),
                                            np.linspace(0, 1, 9)))
    with pytest.raises(ValueError, match='n_splits=2 or more'):
        split.KFold(1)


# ---------------------------------------------------------------- csv

def test_write_csv_matches_pandas(tmp_path):
    rng = np.random.default_rng(0)
    for values in (rng.uniform(size=(20, 1)),
                   rng.uniform(size=(20, 3)).astype(np.float32),
                   np.array([[np.nan, 1e-7], [1e16, 0.5]])):
        write_csv(tmp_path / 'ours.csv', values)
        pd.DataFrame(values).to_csv(tmp_path / 'ref.csv', index=False)
        assert (tmp_path / 'ours.csv').read_text() == \
            (tmp_path / 'ref.csv').read_text()
