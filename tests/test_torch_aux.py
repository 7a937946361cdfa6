# -*- coding:utf-8 -*-
"""The port's host utilities (ROADMAP Queue 1 item 14: ``utils/profiling``,
``utils/device``, ``utils/counter``, ``utils/fs``, ``utils/quicktest``,
``utils/dart_early_stopping``, ``utils/feature_importance``,
``utils/shap``, ``eda/utils``, ``preprocessing/utils`` and ``datasets``)
against the JAX package's, on the CPU. Where the output is deterministic
the same inputs go through both and are held exactly equal; where an
optional package (lightgbm, shap) is missing, both raise ImportError."""

import json
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import deeptables_tpu.eda as jax_eda
import deeptables_tpu.preprocessing as jax_preprocessing
from deeptables_tpu.datasets import dsutils as jax_dsutils
from deeptables_tpu.preprocessing import utils as jax_pre_utils
from deeptables_tpu.utils import counter as jax_counter
from deeptables_tpu.utils import dart_early_stopping as jax_dart
from deeptables_tpu.utils import feature_importance as jax_fi
from deeptables_tpu.utils import fs as jax_fs
from deeptables_tpu.utils import profiling as jax_profiling
from deeptables_tpu.utils import shap as jax_shap
import deeptables_torch.eda as eda
import deeptables_torch.preprocessing as preprocessing
from deeptables_torch.data import columns as cl
from deeptables_torch.data.datasets import load_bank
from deeptables_torch.datasets import dsutils
from deeptables_torch.models import DeepTable, ModelConfig
from deeptables_torch.preprocessing import utils as pre_utils
from deeptables_torch.utils import (counter, dart_early_stopping, device,
                                    feature_importance, fs, profiling,
                                    quicktest, shap)


# ---------------------------------------------------------------- profiling

def test_step_timer_matches_jax(monkeypatch):
    times = [float(t) for t in np.cumsum(
        np.random.default_rng(0).uniform(0.01, 0.2, 59))]

    def run(module):
        it = iter(times)
        monkeypatch.setattr(module.time, 'perf_counter', lambda: next(it))
        timer = module.StepTimer(window=20)
        assert np.isnan(timer.mean_step_time) and np.isnan(timer.p99)
        for _ in times:
            timer.tick()
        return timer.summary(batch_size=512), timer.throughput(512)
    assert run(profiling) == run(jax_profiling)


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate('host_phase'):
            torch.ones(64).sum()
    assert prof is not None
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    assert any(e.get('name') == 'host_phase' for e in events)


# ---------------------------------------------------------------- device

def test_device_helpers_on_the_cpu():
    assert device.resolve_device('cpu') == torch.device('cpu')
    assert device.set_memory_growth() is None
    assert device.enable_compilation_cache() is None
    info = device.device_info()
    # the JAX package's keys, and the platform in its words
    assert {'platform', 'device_kind', 'num_devices', 'num_local_devices',
            'process_index', 'num_processes'} <= set(info)
    assert (info['process_index'], info['num_processes']) == (0, 1)
    if not torch.cuda.is_available():
        assert info['platform'] == 'cpu' and info['num_devices'] == 0
        assert device.memory_stats() is None
        with pytest.raises(RuntimeError, match='CUDA'):
            device.set_memory_limit(0.5)
    with pytest.raises(ValueError, match='fraction'):
        device.set_memory_limit(1.5)
    with pytest.raises(ValueError, match='CUDA device'):
        device.set_memory_limit(0.5, device='cpu')


# ---------------------------------------------------------------- counter, fs

def test_counter_matches_jax():
    for module in (counter, jax_counter):
        module.reset()
    names = ['fgcnn', 'senet', 'fgcnn', 'fgcnn', 'senet', 'x']
    assert [counter.next_num(n) for n in names] == \
        [jax_counter.next_num(n) for n in names] == [0, 0, 1, 2, 1, 0]
    counter.reset()
    assert counter.next_num('fgcnn') == 0


@pytest.mark.parametrize('url', [False, True])
def test_fs_matches_jax(tmp_path, url):
    results = []
    for module, name in ((fs, 'port'), (jax_fs, 'jax')):
        root = f'memory://fs_test_{name}' if url else str(tmp_path / name)
        path = f'{root}/sub/file.bin'
        with module.open(path, 'wb') as f:
            f.write(b'payload')
        with module.open(path, 'rb') as f:
            data = f.read()
        module.makedirs(f'{root}/other')
        # fsspec lists a URL's entries as dicts, os.listdir as names
        listed = sorted(str(p['name'] if isinstance(p, dict) else p)
                        .rsplit('/', 1)[-1]
                        for p in module.listdir(f'{root}/sub'))
        exists = module.exists(path)
        module.remove(path)
        results.append((data, listed, exists, module.exists(path)))
    assert results[0] == results[1] == (b'payload', ['file.bin'], True,
                                        False)
    assert fs.sep == jax_fs.sep


# ---------------------------------------------------------------- encoding

def _categories(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({'c1': rng.choice(list('abc'), n),
                         'c2': rng.choice(list('xyz'), n),
                         'y': rng.integers(0, 2, n)})


def test_target_encoder_matches_jax():
    df = _categories()
    X, y = df[['c1', 'c2']], df['y']
    port = pre_utils.TargetEncoder(smoothing=0.5).fit(X, y)
    ref = jax_pre_utils.TargetEncoder(smoothing=0.5).fit(X, y)
    assert port.mappings_ == ref.mappings_ and port.prior_ == ref.prior_
    pd.testing.assert_frame_equal(port.transform(X.head(40)),
                                  ref.transform(X.head(40)))
    unseen = pd.DataFrame({'c1': ['q'], 'c2': ['x']})
    pd.testing.assert_frame_equal(port.transform(unseen),
                                  ref.transform(unseen))


def test_target_encoding_matches_jax():
    train = _categories()
    test = train.head(50).drop(columns=['y'])
    port = preprocessing.target_encoding(train.copy(), 'y', test=test.copy(),
                                         feat_to_encode=['c1', 'c2'])
    ref = jax_preprocessing.target_encoding(train.copy(), 'y',
                                            test=test.copy(),
                                            feat_to_encode=['c1', 'c2'])
    for a, b in ((port[0], ref[0]), (port[1], ref[1])):
        pd.testing.assert_frame_equal(a, b)
    assert port[2] == ref[2] and set(port[2]) == {'c1', 'c2'}
    pd.testing.assert_series_equal(port[3], ref[3])


@pytest.mark.parametrize('mode', ['order', 'rate'])
def test_target_rate_encoding_matches_jax(mode):
    rng = np.random.default_rng(1)
    df = pd.DataFrame({'c': rng.choice(list('abcd'), 200),
                       'y': rng.integers(0, 2, 200)})
    pd.testing.assert_frame_equal(
        preprocessing.target_rate_encodeing(['c'], 'y', df, mode=mode),
        jax_preprocessing.target_rate_encodeing(['c'], 'y', df, mode=mode))


# ---------------------------------------------------------------- eda

def test_eda_matches_jax():
    df = load_bank(200)
    pd.testing.assert_frame_equal(eda.columns_info(df),
                                  jax_eda.columns_info(df))
    pd.testing.assert_index_equal(eda.top_categories(df, 'job', topN=3),
                                  jax_eda.top_categories(df, 'job', topN=3))
    assert list(eda.split_seq(range(9), 4)) == \
        list(jax_eda.split_seq(range(9), 4)) == [[0, 1, 2, 3], [4, 5, 6, 7],
                                                 [8]]
    mixed = pd.DataFrame({'a': np.arange(100, dtype=np.int64),
                          'b': np.random.default_rng(2).random(100),
                          'c': np.arange(100, dtype=np.int64) * 1000,
                          'd': ['x'] * 100})
    port = eda.reduce_mem_usage(mixed.copy(), verbose=False)
    pd.testing.assert_frame_equal(
        port, jax_eda.reduce_mem_usage(mixed.copy(), verbose=False))
    assert port['a'].dtype == np.int8 and port['c'].dtype == np.int32


def _eda_frame(n=300, seed=3):
    """Tied counts, booleans, all-missing columns, a categorical with an
    unused category, times, mixed objects, each integer width."""
    rs = np.random.RandomState(seed)
    mixed = [(1, 'a', None, 2.5)[k] for k in rs.randint(0, 4, n)]
    return pd.DataFrame({
        'ties': np.repeat([5, 2, 9, 7], n // 4)[rs.permutation(n)],
        'flag': rs.rand(n) < .5,
        'const_bool': np.ones(n, bool),
        'f': np.where(rs.rand(n) < .1, np.nan, rs.randint(0, 5, n) / 4),
        'f32': rs.randn(n).astype(np.float32),
        'f32_ties': (rs.randint(0, 3, n) / 2).astype(np.float32),
        'nan': np.full(n, np.nan),
        'i16': rs.randint(-300, 300, n).astype(np.int16),
        'i32': rs.randint(-5, 5, n).astype(np.int32),
        'i64_big': rs.randint(0, 2 ** 40, n),
        'u8': rs.randint(0, 5, n).astype(np.uint8),
        's': pd.array(rs.choice(['a', 'bb', None, 'c'], n), dtype='str'),
        's_missing': pd.array([None] * n, dtype='str'),
        'cat': pd.Categorical(rs.choice(['q', 'p', None], n),
                              categories=['r', 'q', 'p', 'unused']),
        'cat_int': pd.Categorical(rs.choice([3, 1, 2], n)),
        'obj': pd.Series(mixed, dtype=object),
        'when': pd.to_datetime(rs.randint(0, 4, n) * 86_400 + 1_600_000_000
                               + rs.randint(0, 2, n) * 0.5, unit='s'),
    })


def _same_number(a, b):
    a, b = float(a), float(b)
    return (a != a and b != b) or a == b


def _assert_info_equal(port, jax_info):
    """The port's ``columns_info`` (a DataFrame, or ``Columns``) against
    the JAX helper's DataFrame: the same rows, dtypes by name, counts,
    statistics and top-N strings."""
    rows = list(jax_info.index)
    if isinstance(port, cl.Columns):
        assert list(port.index) == rows
        get = {c: port[c] for c in port.columns}
    else:
        assert list(port.index) == rows
        get = {c: port[c].to_numpy() for c in port.columns}
    assert list(get) == list(jax_info.columns)
    for j, name in enumerate(rows):
        assert get['DataType'][j] == str(jax_info['DataType'].iloc[j]), name
        for c in ('#Nulls', '#Uniques'):
            assert get[c][j] == jax_info[c].iloc[j], (name, c)
        for c in ('Min', 'Mean', 'Max', 'Std'):
            assert _same_number(get[c][j], jax_info[c].iloc[j]), \
                (name, c, get[c][j], jax_info[c].iloc[j])
        for c in jax_info.columns[7:]:
            assert get[c][j] == jax_info[c].iloc[j], (name, c)


@pytest.mark.parametrize('table', ['bank', 'edges', 'edges_small'])
@pytest.mark.parametrize('pandas_blocked', [False, True])
def test_eda_on_columns_matches_jax(monkeypatch, table, pandas_blocked):
    """``columns_info``, ``top_categories`` and ``reduce_mem_usage`` on
    ``Columns`` give what the JAX helpers give on the same DataFrame; with
    pandas blocked ``columns_info`` returns ``Columns``."""
    if table == 'bank':
        frame = load_bank(2000)
        frame = frame if isinstance(frame, pd.DataFrame) \
            else cl.to_frame(frame)
        feature = 'job'
    else:
        frame = _eda_frame(*((40, 5) if table == 'edges_small' else ()))
        feature = 'ties'
    expected = jax_eda.columns_info(frame.copy(), topN=5)
    top = list(jax_eda.top_categories(frame, feature, topN=3))
    reduced = cl.as_columns(jax_eda.reduce_mem_usage(frame.copy(),
                                                     verbose=False),
                            rename=False)
    cols = cl.as_columns(frame, rename=False)
    if pandas_blocked:
        monkeypatch.setitem(sys.modules, 'pandas', None)
    info = eda.columns_info(cols, topN=5)
    assert isinstance(info, cl.Columns) == pandas_blocked
    _assert_info_equal(info, expected)
    assert list(eda.top_categories(cols, feature, topN=3)) == top
    got = eda.reduce_mem_usage(cols, verbose=False)
    assert got is cols
    assert got.columns == reduced.columns
    for name in reduced.columns:
        a, b = got[name], reduced[name]
        assert got.kinds[name] == reduced.kinds[name], name
        assert a.dtype == b.dtype, name
        assert all(_same_number(x, y) if isinstance(x, float) else
                   (x is y or x == y) for x, y in zip(a.tolist(),
                                                      b.tolist())), name


def test_eda_digests_are_chip_smokes(monkeypatch):
    """chip_smoke.py's EDA_DIGESTS: its eda phase with pandas blocked gives
    them here, and the port's ``columns_info`` of the bank table there is
    the JAX helper's of the same DataFrame."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from deeptables_torch.tools import parity_quality
    frame = parity_quality.configs()['bank_deepfm']['loader']()
    frame = frame if isinstance(frame, pd.DataFrame) else cl.to_frame(frame)
    expected = jax_eda.columns_info(frame.copy())
    for name in cs.ESTIMATOR_BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)
    got = cs.eda_runs()
    for key, digest in cs.EDA_DIGESTS.items():
        assert got[key] == digest, key
    _assert_info_equal(eda.columns_info(cl.as_columns(frame, rename=False)),
                       expected)


# ---------------------------------------------------------------- datasets

def test_dsutils_matches_jax():
    for name in ('load_bank', 'load_adult', 'load_glass_uci'):
        pd.testing.assert_frame_equal(getattr(dsutils, name)(),
                                      getattr(jax_dsutils, name)())


# ---------------------------------------------------------------- on a DeepTable

@pytest.fixture(scope='module')
def bank_dt(tmp_path_factory):
    df = load_bank(400)
    y = df.pop('y')
    dt = DeepTable(ModelConfig(nets=['dnn_nets'], metrics=['AUC'],
                               embedding_dropout=0,
                               home_dir=str(tmp_path_factory.mktemp('fi'))),
                   device='cpu')
    dt.fit(df, y, epochs=1, verbose=0)
    return dt, df.head(100), y.head(100)


@pytest.mark.parametrize('metric, mode', [('AUC', 'max'), ('accuracy', 'max'),
                                          ('logloss', 'min')])
def test_score_importances_match_jax(bank_dt, metric, mode):
    """Both packages' permutation loops over the port's DeepTable: the same
    permutations (one seed), so the same importances."""
    dt, X, y = bank_dt
    port = feature_importance.get_score_importances(dt, X, y, metric,
                                                    n_iter=1, mode=mode)
    ref = jax_fi.get_score_importances(dt, X, y, metric, n_iter=1, mode=mode)
    np.testing.assert_array_equal(port, ref)
    assert port.shape == (X.shape[1], 2)
    if metric == 'AUC':
        assert np.abs(port[:, 1].astype(float)).sum() > 0
    selected, discarded = feature_importance.select_features(
        port, threshold=-np.inf)
    assert (selected, discarded) == jax_fi.select_features(ref, -np.inf)
    assert len(selected) + len(discarded) == X.shape[1]


def test_quicktest_trains_a_deeptable():
    dt = quicktest.test(device='cpu')
    assert dt.task == 'binary' and isinstance(dt, DeepTable)


# ---------------------------------------------------------------- optional

def _has(name):
    try:
        __import__(name)
    except ImportError:
        return False
    return True


def test_dart_early_stopping_needs_lightgbm():
    if _has('lightgbm'):
        assert callable(dart_early_stopping.dart_early_stopping(5))
        return
    for module in (dart_early_stopping, jax_dart):
        with pytest.raises(ImportError, match='lightgbm'):
            module.dart_early_stopping(5)


def test_dart_early_stopping_formats_like_jax():
    for value in (('valid', 'auc', 0.91, True),
                  ('valid', 'auc', 0.91, True, 0.02)):
        assert dart_early_stopping._format_eval_result(value) == \
            jax_dart._format_eval_result(value)
    with pytest.raises(ValueError):
        dart_early_stopping._format_eval_result(('valid',))


class _Sum:
    """A stand-in ``DeepTable`` whose prediction is a row's sum."""

    def predict(self, frame, encode_to_label=False):
        return cl.to_2d(frame).astype(np.float64).sum(axis=1)


def test_shap_gate_matches_jax():
    # the flag says whether shap imports, as JAX's does; the port explains
    # without it (an additive f: each value is x_j - mean_b b_j)
    assert shap.have_shap == jax_shap.have_shap == _has('shap')
    bg = pd.DataFrame({'a': [1.0, 2.0, 4.0], 'b': [0.0, 3.0, 3.0]})
    explainer = shap.DeepTablesExplainer(_Sum(), bg)
    values = explainer.get_shap_values(np.array([[5.0, 1.0]]))
    np.testing.assert_allclose(values, [[5.0 - 7 / 3, 1.0 - 2.0]],
                               atol=1e-12)
    assert explainer.expected_value == pytest.approx(13 / 3)
