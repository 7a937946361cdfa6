# -*- coding:utf-8 -*-
"""Out-of-core streaming in the port (``deeptables_torch/data/streaming.py``,
``DeepModel.fit`` over a ``StreamingDataLoader``, ``DeepTable.fit`` over a
loader and ``fit_cross_validation_streaming``) against the JAX package, on
the CPU (``tests/test_torch_stream_numpy.py`` holds the module with pandas
blocked).

Held exactly equal: ``ChunkedSource``'s chunks (named numpy columns, as
their DataFrames); ``StreamingDataLoader``'s
batches, with and without ``fold_spec`` (the JAX loader draws each chunk's
seed on the iterating thread, so its order is deterministic);
``collect_streaming_stats`` (every field of every column's statistics) and
the preprocessor state that ``fit_preprocessor_streaming`` leaves, exact and
from a sample, on the messy, int-category and bool columns of
``tests/test_streaming.py``. The fits start from the JAX package's weights
(bridged), on rows drawn as ``tests/torch_parity.py`` draws them (uniform
categories, normal dense inputs: ``_synthetic`` says why not the bank
rows), and are held as ``tests/test_torch_train.py`` holds a fit:
per-epoch metrics rtol 1e-4, the final state atol 2e-4, ``evaluate`` and
``predict`` 1e-5; ``DeepTable``'s scores rtol 1e-4.
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest

from deeptables_tpu.data import streaming as jax_streaming
from deeptables_tpu.models import DeepModel as JaxDeepModel
from deeptables_tpu.models import DeepTable as JaxDeepTable
from deeptables_tpu.models import ModelConfig as JaxModelConfig
from deeptables_tpu.models.preprocessor import \
    DefaultPreprocessor as JaxPreprocessor
from deeptables_torch import bridge
from deeptables_torch.data import streaming
from deeptables_torch.data.columns import Columns, to_frame
from deeptables_torch.data.datasets import load_bank
from deeptables_torch.models import DeepModel, DeepTable, ModelConfig
from deeptables_torch.models import deeptable as dt_mod
from deeptables_torch.models.preprocessor import DefaultPreprocessor
from test_torch_preprocessor import _assert_frames_equal, _columns, _state
from torch_parity import assert_batches_equal


@pytest.fixture(scope='module')
def csv_shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('shards')
    paths = []
    for i in range(4):
        p = str(tmp / f'bank_{i}.csv')
        load_bank(300, seed=100 + i).to_csv(p, index=False)
        paths.append(p)
    return paths


def _synthetic(n, seed):
    """Rows for the fits: four categorical columns drawn uniformly from 6-25
    values, three standard-normal dense columns and a 'yes'/'no' label from
    a logistic model of both. No column is constant over a batch: a
    BatchNorm'd feature that is would make its gradients zero in exact
    arithmetic, so rounding noise, which Adam turns into steps of ~lr that
    differ between the packages (ROADMAP Queue 3 item 3); the unscaled bank
    columns (up to ~1e4) also make the float32 one-pass BatchNorm variance
    of both packages depend on the order of its sums."""
    rng = np.random.default_rng(seed)
    truth = np.random.default_rng(99)
    frame, score = {}, np.zeros(n)
    for i, size in enumerate((6, 11, 17, 25)):
        ids = rng.integers(0, size, n)
        frame[f'c{i}'] = np.asarray([f'v{k}' for k in range(size)])[ids]
        score += truth.normal(size=size)[ids]
    for i in range(3):
        frame[f'x{i}'] = rng.normal(size=n)
        score += truth.normal() * frame[f'x{i}']
    frame['y'] = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-score)),
                          'yes', 'no')
    return pd.DataFrame(frame)


@pytest.fixture(scope='module')
def synth_shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('synthetic')
    paths = []
    for i in range(4):
        p = str(tmp / f'synthetic_{i}.csv')
        _synthetic(300, seed=200 + i).to_csv(p, index=False)
        paths.append(p)
    return paths


@pytest.fixture(scope='module')
def messy_shards(tmp_path_factory):
    """``tests/test_streaming.py``'s messy shards: NaNs in a categorical and
    a continuous column, string labels."""
    tmp = tmp_path_factory.mktemp('messy')
    rng = np.random.default_rng(7)
    paths = []
    for i in range(3):
        n = 400
        df = pd.DataFrame({
            'cat_a': rng.choice(['x', 'y', 'z', 'w'], n),
            'cat_b': rng.choice(list('abcdefgh'), n),
            'num_1': rng.normal(10, 3, n),
            'num_2': rng.integers(0, 2000, n).astype(float),
            'small_int': rng.integers(0, 5, n).astype(float),
            'y': rng.choice(['no', 'yes'], n),
        })
        df.loc[df.sample(30, random_state=i).index, 'cat_a'] = np.nan
        df.loc[df.sample(25, random_state=i + 9).index, 'num_1'] = np.nan
        p = str(tmp / f'part_{i}.csv')
        df.to_csv(p, index=False)
        paths.append(p)
    return paths


def _typed_frame():
    """``tests/test_streaming.py``'s int-category, str-category, bool and
    float columns, kept as a DataFrame so the dtypes survive."""
    rng = np.random.default_rng(0)
    n = 300
    return pd.DataFrame({
        'c_int': pd.Categorical(rng.integers(0, 7, n)),
        'c_str': pd.Categorical(rng.choice(['a', 'b', 'c'], n).astype(object)),
        'flag': rng.integers(0, 2, n).astype(bool),
        'x': rng.normal(size=n),
        'y': rng.integers(0, 2, n),
    })


MESSY_CONFIG = dict(nets=['dnn_nets'], metrics=['AUC'], auto_categorize=True,
                    auto_discrete=True, auto_scale=True, embedding_dropout=0)
FIT_CONFIG = dict(nets=['linear', 'fm_nets', 'dnn_nets'], metrics=['AUC'],
                   embedding_dropout=0, earlystopping_patience=0,
                   dnn_params={'hidden_units': ((32, 0, False),
                                                (16, 0, False)),
                               'activation': 'relu'})


def _pair(**config):
    """The port's and the JAX package's (config, preprocessor)."""
    port_config, jax_config = ModelConfig(**config), JaxModelConfig(**config)
    return ((port_config, DefaultPreprocessor(port_config, use_cache=False)),
            (jax_config, JaxPreprocessor(jax_config, use_cache=False)))


def _assert_preprocessors_equal(port, ref, frame):
    assert _columns(port) == _columns(ref)
    assert _state(port.X_transformers) == _state(ref.X_transformers)
    _assert_frames_equal(port.transform_X(frame.copy()),
                         ref.transform_X(frame.copy()))


# ---------------------------------------------------------------- sources

def _assert_chunks_equal(chunk, frame):
    """The port's ``Columns`` chunk holds the JAX package's DataFrame chunk:
    names, dtypes and values (a chunk's row labels are not kept)."""
    assert isinstance(chunk, Columns)
    pd.testing.assert_frame_equal(to_frame(chunk).reset_index(drop=True),
                                  frame.reset_index(drop=True))


@pytest.mark.parametrize('kind', ['csv', 'glob', 'frame', 'hosts'])
def test_chunked_source_matches_jax(csv_shards, kind):
    if kind == 'frame':
        frame = pd.concat([pd.read_csv(p) for p in csv_shards],
                          ignore_index=True)
        args, kwargs = (frame,), {'chunk_size': 170}
    elif kind == 'glob':
        args = (os.path.join(os.path.dirname(csv_shards[0]), '*.csv'),)
        kwargs = {'chunk_size': 500}
    else:
        args, kwargs = (csv_shards,), {'chunk_size': 100}
    hosts = [(0, 2), (1, 2)] if kind == 'hosts' else [(0, 1)]
    for host_id, num_hosts in hosts:
        port = streaming.ChunkedSource(*args, host_id=host_id,
                                       num_hosts=num_hosts, **kwargs)
        ref = jax_streaming.ChunkedSource(*args, host_id=host_id,
                                          num_hosts=num_hosts, **kwargs)
        if kind != 'frame':
            assert port.paths == ref.paths
        chunks = list(port.iter_chunks())
        ref_chunks = list(ref.iter_chunks())
        assert len(chunks) == len(ref_chunks) > 1
        for a, b in zip(chunks, ref_chunks):
            _assert_chunks_equal(a, b)
        _assert_chunks_equal(port.sample(250), ref.sample(250))


# ---------------------------------------------------------------- statistics

@pytest.mark.parametrize('caps', [{}, {'vc_cap': 50, 'reservoir_size': 40}],
                         ids=['exact', 'reservoir'])
@pytest.mark.parametrize('data', ['messy', 'typed', 'movielens'])
def test_collect_streaming_stats_matches_jax(messy_shards, data, caps):
    from deeptables_torch.data.datasets import load_movielens
    config = dict(MESSY_CONFIG)
    if data == 'messy':
        args, target = (messy_shards,), 'y'
    elif data == 'typed':
        args, target = (_typed_frame(),), 'y'
    else:
        frame = load_movielens(300)
        args, target = (frame,), 'rating'
        config['var_len_categorical_columns'] = [('genres', '|', 'max')]
    kwargs = dict(caps, seed=3)
    port = streaming.collect_streaming_stats(
        streaming.ChunkedSource(*args, chunk_size=150), target,
        ModelConfig(**config), **kwargs)
    ref = jax_streaming.collect_streaming_stats(
        jax_streaming.ChunkedSource(*args, chunk_size=150), target,
        JaxModelConfig(**config), **kwargs)
    (stats, y_stats, n_rows), (ref_stats, ref_y, ref_n) = port, ref
    assert n_rows == ref_n and list(stats) == list(ref_stats)
    for name in ref_stats:
        assert _state(vars(stats[name])) == _state(vars(ref_stats[name])), \
            name
        st, ref_st = stats[name], ref_stats[name]
        assert (st.resolved_dtype, st.wants_string_fill, st.nunique,
                st.mean) == (ref_st.resolved_dtype, ref_st.wants_string_fill,
                             ref_st.nunique, ref_st.mean)
        if not st.is_categorical_dtype and st.tokens is None:
            for got, want in zip(st.quantile_distribution(impute_value=1.5),
                                 ref_st.quantile_distribution(1.5)):
                np.testing.assert_array_equal(got, want)
    assert _state(vars(y_stats)) == _state(vars(ref_y))
    if caps:
        assert any(st.vc_overflow for st in stats.values())


@pytest.mark.parametrize('exact', [True, False])
@pytest.mark.parametrize('data', ['messy', 'typed'])
def test_fit_preprocessor_streaming_matches_jax(messy_shards, data, exact):
    if data == 'messy':
        source_args = (messy_shards,)
        full = pd.concat([pd.read_csv(p) for p in messy_shards],
                         ignore_index=True)
        config = MESSY_CONFIG
    else:
        full = _typed_frame()
        source_args = (full,)
        config = dict(nets=['dnn_nets'], metrics=['AUC'])
    (_, port), (_, ref) = _pair(**config)
    streaming.fit_preprocessor_streaming(
        port, streaming.ChunkedSource(*source_args, chunk_size=150), 'y',
        sample_rows=500, exact=exact)
    jax_streaming.fit_preprocessor_streaming(
        ref, jax_streaming.ChunkedSource(*source_args, chunk_size=150), 'y',
        sample_rows=500, exact=exact)
    X = full.drop(columns=['y'])
    _assert_preprocessors_equal(port, ref, X)
    np.testing.assert_array_equal(port.transform_y(full['y']),
                                  ref.transform_y(full['y']))
    if exact:
        # the exact streaming fit is the in-memory fit over the stream
        memory = DefaultPreprocessor(ModelConfig(**config), use_cache=False)
        memory.fit_transform(X.copy(), full['y'].copy())
        assert _columns(port) == _columns(memory)


# ---------------------------------------------------------------- loaders

def _fitted_preprocessors(paths, chunk_size=170, **config):
    (port_config, port), (jax_config, ref) = _pair(**config)
    port_src = streaming.ChunkedSource(paths, chunk_size=chunk_size)
    jax_src = jax_streaming.ChunkedSource(paths, chunk_size=chunk_size)
    streaming.fit_preprocessor_streaming(port, port_src, 'y')
    jax_streaming.fit_preprocessor_streaming(ref, jax_src, 'y')
    return (port_config, port, port_src), (jax_config, ref, jax_src)


@pytest.mark.parametrize('fold_spec', [None, (3, 1, 'train'),
                                       (3, 2, 'valid')])
@pytest.mark.parametrize('loader', [
    {'batch_size': 32},
    {'batch_size': 50, 'shuffle_in_chunk': False, 'drop_remainder': False},
    {'batch_size': 48, 'drop_remainder': False, 'pad_multiple': 16},
], ids=['shuffled', 'ordered', 'padded'])
def test_streaming_loader_batches_match_jax(csv_shards, fold_spec, loader):
    (_, port, port_src), (_, ref, jax_src) = _fitted_preprocessors(
        csv_shards, **FIT_CONFIG)
    kwargs = dict(loader, seed=9, fold_spec=fold_spec)
    port_loader = streaming.StreamingDataLoader(port_src, port, 'y', **kwargs)
    jax_loader = jax_streaming.StreamingDataLoader(jax_src, ref, 'y',
                                                   **kwargs)
    for _ in range(2):  # two epochs: the seed advances with each
        assert_batches_equal(port_loader, jax_loader)
    assert port_loader.steps == jax_loader.steps


def test_fold_masks_partition(csv_shards):
    (_, port, src), _ = _fitted_preprocessors(csv_shards, **FIT_CONFIG)
    total = sum(len(c) for c in src.iter_chunks())
    valid_counts = 0
    for fold in range(3):
        counts = [sum(int(valid) for *_, valid in
                      streaming.StreamingDataLoader(
                          src, port, 'y', batch_size=32,
                          shuffle_in_chunk=False, drop_remainder=False,
                          fold_spec=(3, fold, role)))
                  for role in ('valid', 'train')]
        assert sum(counts) == total
        valid_counts += counts[0]
    assert valid_counts == total
    for bad in ((3, 3, 'valid'), (3, 0, 'test')):
        with pytest.raises(ValueError):
            streaming.StreamingDataLoader(src, port, 'y', fold_spec=bad)


# ---------------------------------------------------------------- fits

def _jax_init_state(pre, config, jax_pre, jax_config):
    """The port's state dict of the JAX package's initial weights for the
    preprocessors' schema (what its DeepModel draws from ``config.seed``)."""
    model = JaxDeepModel(jax_pre.task, len(jax_pre.labels), jax_config,
                         jax_pre.categorical_columns,
                         jax_pre.continuous_columns)
    return bridge.state_dict_from_flax(
        jax.device_get(model.build()), pre.categorical_columns,
        pre.continuous_columns, config)


@pytest.fixture(scope='module')
def stream_fitted(synth_shards):
    """A JAX fit and a port fit from the same weights over the same
    StreamingDataLoader batches: two epochs with a validation loader."""
    (config, port_pre, port_src), (jax_config, ref_pre, jax_src) = \
        _fitted_preprocessors(synth_shards, chunk_size=200, **FIT_CONFIG)
    val_kwargs = dict(batch_size=64, shuffle_in_chunk=False,
                      drop_remainder=False)
    port_model = DeepModel(port_pre.task, len(port_pre.labels), config,
                           port_pre.categorical_columns,
                           port_pre.continuous_columns, device='cpu')
    port_model.build().load_state_dict(
        _jax_init_state(port_pre, config, ref_pre, jax_config))
    jax_model = JaxDeepModel(ref_pre.task, len(ref_pre.labels), jax_config,
                             ref_pre.categorical_columns,
                             ref_pre.continuous_columns)
    loaders = {}
    for side, src, pre, module in (('port', port_src, port_pre, streaming),
                                   ('jax', jax_src, ref_pre, jax_streaming)):
        val_src = module.ChunkedSource(synth_shards[:1], chunk_size=200)
        loaders[side] = (
            module.StreamingDataLoader(src, pre, 'y', batch_size=64, seed=3),
            module.StreamingDataLoader(val_src, pre, 'y', **val_kwargs))
    jax_history = jax_model.fit(loaders['jax'][0], epochs=2, verbose=0,
                                validation_data=loaders['jax'][1])
    port_history = port_model.fit(loaders['port'][0], epochs=2, verbose=0,
                                  validation_data=loaders['port'][1])
    return (port_model, jax_model, loaders, port_history, jax_history,
            port_pre, config)


@pytest.mark.parametrize('key', ['loss', 'val_loss', 'val_auc'])
def test_stream_fit_trajectory_matches_jax(stream_fitted, key):
    *_, port_history, jax_history, _, _ = stream_fitted
    assert len(port_history.history[key]) == 2
    np.testing.assert_allclose(port_history.history[key],
                               jax_history.history[key], rtol=1e-4)
    assert sorted(port_history.history.data) == \
        sorted(jax_history.history.data)


def test_stream_fit_final_state_matches_jax(stream_fitted):
    port_model, jax_model, *_, pre, config = stream_fitted
    expected = bridge.state_dict_from_flax(
        jax.device_get(jax_model.variables), pre.categorical_columns,
        pre.continuous_columns, config)
    state = port_model.module.state_dict()
    assert set(state) == set(expected)
    for key, value in state.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   rtol=0, atol=2e-4, err_msg=key)


def test_stream_evaluate_and_predict_match_jax(stream_fitted):
    port_model, jax_model, loaders, *_ = stream_fitted
    got = port_model.evaluate(loaders['port'][1])
    expected = jax_model.evaluate(loaders['jax'][1])
    assert sorted(got.data) == sorted(expected.data)
    for key in expected.data:
        np.testing.assert_allclose(got[key], expected[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    proba = port_model.predict(loaders['port'][1])
    assert proba.shape == (300, 1)
    np.testing.assert_allclose(proba, jax_model.predict(loaders['jax'][1]),
                               rtol=1e-5, atol=1e-5)


def test_stream_fit_keeps_the_optimizer_and_honours_the_epochs(
        csv_shards):
    """A second fit goes on with the first one's optimizer; ``initial_epoch``
    and ``steps_per_epoch`` bound the epochs and their steps."""
    (config, pre, src), _ = _fitted_preprocessors(csv_shards, **FIT_CONFIG)
    model = DeepModel(pre.task, len(pre.labels), config,
                      pre.categorical_columns, pre.continuous_columns,
                      device='cpu')
    loader = streaming.StreamingDataLoader(src, pre, 'y', batch_size=64)
    steps = []
    train_step = model._train_step

    def counted(*args):
        steps.append(1)
        return train_step(*args)
    model._train_step = counted
    history = model.fit(loader, epochs=3, initial_epoch=1, steps_per_epoch=4,
                        verbose=0)
    assert len(history.history['loss']) == 2 and len(steps) == 8
    optimizer = model.optimizer
    model.fit(loader, epochs=1, verbose=0)
    assert model.optimizer is optimizer
    assert len(steps) == 8 + sum(1 for _ in loader)


# ---------------------------------------------------------------- DeepTable

@pytest.fixture
def bridged_deeptables(monkeypatch):
    """Every DeepModel a port DeepTable makes starts from the JAX package's
    initial weights for its schema, as each JAX fold's model does."""
    made = []
    deep_model = dt_mod.DeepTable._deep_model

    def bridged(self, *args, **kwargs):
        model = deep_model(self, *args, **kwargs)
        jax_config = JaxModelConfig(**FIT_CONFIG)
        jax_pre = JaxPreprocessor(jax_config, use_cache=False)
        jax_streaming.fit_preprocessor_streaming(
            jax_pre, jax_streaming.ChunkedSource(made[0], chunk_size=300),
            'y')
        model.build().load_state_dict(_jax_init_state(
            self.preprocessor, self.config, jax_pre, jax_config))
        return model
    monkeypatch.setattr(dt_mod.DeepTable, '_deep_model', bridged)
    return made


def test_deeptable_stream_fit_and_evaluate_match_jax(synth_shards, tmp_path,
                                                     bridged_deeptables):
    bridged_deeptables.append(synth_shards)
    (_, pre, src), (_, ref_pre, jax_src) = _fitted_preprocessors(
        synth_shards, chunk_size=300, **FIT_CONFIG)
    results = []
    for module, cls, config, p, s in (
            (streaming, DeepTable, ModelConfig, pre, src),
            (jax_streaming, JaxDeepTable, JaxModelConfig, ref_pre, jax_src)):
        train = module.StreamingDataLoader(s, p, 'y', batch_size=64)
        evaluate = module.StreamingDataLoader(
            module.ChunkedSource(synth_shards[:1], chunk_size=300), p, 'y',
            batch_size=64, shuffle_in_chunk=False, drop_remainder=False)
        kwargs = {'device': 'cpu'} if cls is DeepTable else {}
        dt = cls(config=config(home_dir=str(tmp_path / cls.__module__),
                               **FIT_CONFIG), **kwargs)
        _, history = dt.fit(train, epochs=1, verbose=0)
        assert dt.preprocessor is p
        results.append((history.history, dict(dt.evaluate(evaluate)),
                        dt.leaderboard))
    (history, score, board), (jax_history, jax_score, jax_board) = results
    np.testing.assert_allclose(history['loss'], jax_history['loss'],
                               rtol=1e-4)
    assert sorted(score) == sorted(jax_score)
    for key in jax_score:
        np.testing.assert_allclose(score[key], jax_score[key], rtol=1e-4)
    assert list(board['model']) == list(jax_board['model'])


def test_deeptable_stream_fit_needs_a_preprocessor():
    loader = type('Loader', (), {'steps': 1, 'preprocessor': None,
                                 '__iter__': lambda self: iter(())})()
    dt = DeepTable(ModelConfig(**FIT_CONFIG), device='cpu')
    with pytest.raises(ValueError, match='fitted preprocessor'):
        dt.fit(loader)


def test_cv_streaming_matches_jax(synth_shards, tmp_path, bridged_deeptables):
    bridged_deeptables.append(synth_shards)
    results = []
    for module, cls, config in ((streaming, DeepTable, ModelConfig),
                                (jax_streaming, JaxDeepTable,
                                 JaxModelConfig)):
        kwargs = {'device': 'cpu'} if cls is DeepTable else {}
        home = tmp_path / cls.__module__
        dt = cls(config=config(home_dir=str(home), **FIT_CONFIG), **kwargs)
        scores = dt.fit_cross_validation_streaming(
            module.ChunkedSource(synth_shards, chunk_size=300), target='y',
            num_folds=3, batch_size=64, epochs=1, verbose=0)
        files = sorted(f for f in os.listdir(dt.output_path)
                       if f.endswith('.dt'))
        results.append((scores, list(dt.leaderboard['model']), files, dt))
    (scores, board, files, dt), (jax_scores, jax_board, jax_files, _) = \
        results
    assert len(scores) == len(jax_scores) == 3
    assert board == jax_board == [f'linear+fm_nets+dnn_nets-stream-kfold-{k}'
                                  for k in (1, 2, 3)]
    assert files == jax_files == [
        f'linear_fm_nets_dnn_nets-stream-kfold-{k}.dt' for k in (1, 2, 3)]
    for got, want in zip(scores, jax_scores):
        assert sorted(got) == sorted(want)
        assert all(np.isfinite(v) for v in got.values())
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=key)
    # a fold's saved model loads back and scores its fold as before
    assert isinstance(dt.get_model(board[0]), DeepModel)


def test_cv_streaming_oof_metrics(csv_shards, tmp_path):
    dt = DeepTable(ModelConfig(home_dir=str(tmp_path), **FIT_CONFIG),
                   device='cpu')
    scores = dt.fit_cross_validation_streaming(
        streaming.ChunkedSource(csv_shards[:2], chunk_size=300), target='y',
        num_folds=2, batch_size=64, oof_metrics=['auc'])
    assert [sorted(s) for s in scores] == [['auc'], ['auc']]


# ---------------------------------------------------------------- example

def test_streaming_out_of_core_flow(tmp_path):
    """``examples/streaming_out_of_core.py`` through the port on the CPU (its
    shards cut from 2000 to 600 rows): the exact streaming fit, training
    and evaluation from the stream, then k-fold CV over it."""
    for i in range(4):
        load_bank(600, seed=100 + i).to_csv(tmp_path / f'bank_{i}.csv',
                                            index=False)
    source = streaming.ChunkedSource(str(tmp_path / '*.csv'),
                                     chunk_size=1000)
    config = ModelConfig(nets=['linear', 'fm_nets', 'dnn_nets'],
                         metrics=['AUC'], embedding_dropout=0,
                         earlystopping_patience=0,
                         home_dir=str(tmp_path / 'out'))
    pre = DefaultPreprocessor(config, use_cache=False)
    streaming.fit_preprocessor_streaming(pre, source, target='y')
    assert pre.task == 'binary' and len(pre.categorical_columns) > 0
    train_loader = streaming.StreamingDataLoader(source, pre, target='y',
                                                 batch_size=256)
    eval_loader = streaming.StreamingDataLoader(
        streaming.ChunkedSource(str(tmp_path / 'bank_0.csv'),
                                chunk_size=1000),
        pre, target='y', batch_size=256, shuffle_in_chunk=False,
        drop_remainder=False)
    dt = DeepTable(config=config, device='cpu')
    dt.fit(train_loader, epochs=2, verbose=0)
    score = dt.evaluate(eval_loader)
    assert np.isfinite(score['loss']) and score['auc'] > 0.6
    dt_cv = DeepTable(config=config, device='cpu')
    fold_scores = dt_cv.fit_cross_validation_streaming(
        source, target='y', num_folds=3, batch_size=256, epochs=3, verbose=0)
    assert len(fold_scores) == 3
    assert all(np.isfinite(s['loss']) for s in fold_scores)
