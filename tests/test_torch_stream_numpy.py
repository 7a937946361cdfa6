# -*- coding:utf-8 -*-
"""Out-of-core CSV streaming and the estimator's reporting paths on numpy
alone (``data/columns.py``'s ``read_csv``/``concat``/``from_records``,
``data/streaming.py``, ``probe_evaluate``, the leaderboards,
``target_rate_encodeing``, ``get_score_importances``, ``quicktest``), on
the CPU.

``read_csv`` is held to ``pd.read_csv`` chunk by chunk (kinds and values
exactly, NaN in place) on edge-case files, through both of its tokenizers,
and ``concat`` to ``pd.concat``. Two subprocesses run one flow with one
torch thread: ``blocked`` with pandas, scikit-learn, JAX and the JAX
package set to ``None`` in ``sys.modules``, ``frame`` with pandas present.
The blocked run's ``ChunkedSource`` chunks, ``collect_streaming_stats``
(every field) and ``fit_preprocessor_streaming`` state (exact and from a
sample) equal the JAX package's streaming on ``tests/test_streaming.py``'s
messy, int-category and bool columns and on a Criteo-layout shard. Both
runs fit a ``DeepTable`` over a ``StreamingDataLoader`` (two epochs, a
validation loader) and ``fit_cross_validation_streaming`` (3 folds) from
the JAX package's initial weights (bridged), then ``probe_evaluate``,
``get_score_importances`` and the leaderboards: equal bit for bit between
the runs, and the fit within ``tests/test_torch_streaming.py``'s
tolerances of the JAX package's (per-epoch metrics rtol 1e-4, state atol
2e-4, ``evaluate`` and ``predict`` 1e-5; its CV there). The logistic
probe's probabilities are held to scikit-learn's within 1e-6, its AUC
within 1e-6 and its accuracy equal (rows within 1e-6 of p = 0.5 aside).
"""

import functools
import io
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from deeptables_tpu.data import streaming as jax_streaming
from deeptables_tpu.models import DeepTable as JaxDeepTable
from deeptables_tpu.models import ModelConfig as JaxModelConfig
from deeptables_tpu.models import deeptable as jax_dt_mod
from deeptables_tpu.models.preprocessor import \
    DefaultPreprocessor as JaxPreprocessor
from deeptables_tpu.preprocessing import utils as jax_preprocessing
from deeptables_tpu.utils import feature_importance as jax_fi
from deeptables_torch import bridge
from deeptables_torch.data import columns as cl
from deeptables_torch.data import streaming
from deeptables_torch.data.datasets import load_bank
from deeptables_torch.models import DeepTable, ModelConfig
from deeptables_torch.models import deeptable as dt_mod
from deeptables_torch.models.preprocessor import DefaultPreprocessor
from deeptables_torch.ops import metrics as metrics_lib
from deeptables_torch.preprocessing import utils as preprocessing
from deeptables_torch.utils import feature_importance
from test_torch_preprocessor import _assert_frames_equal, _columns, _state
from test_torch_streaming import (FIT_CONFIG, MESSY_CONFIG, _jax_init_state,
                                  _synthetic, _typed_frame)

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ('pandas', 'sklearn', 'pyarrow', 'jax', 'jaxlib', 'flax',
           'optax', 'deeptables_tpu')
TYPED_CONFIG = dict(nets=['dnn_nets'], metrics=['AUC'])
CRITEO_CONFIG = dict(nets=['linear', 'fm_nets', 'dnn_nets'],
                     metrics=['AUC'], embedding_dropout=0,
                     categorical_columns=[f'C{j}' for j in range(1, 27)])
PROBE_LAYERS = ['flatten_embeddings', 'dnn_nets_out']


# ---------------------------------------------------------------- data

def _criteo_csv(path, n, seed):
    """Criteo display-ads layout: a 0/1 label, 13 dense columns (~5% empty)
    and 26 categorical columns of 8-hex-digit tokens (~3% empty)."""
    rng = np.random.default_rng(seed)
    dense = np.round(rng.lognormal(1, 1, (n, 13)), 3).astype(str)
    dense[rng.random((n, 13)) < 0.05] = ''
    ids = rng.zipf(1.3, (n, 26)) % np.arange(5, 135, 5)
    tokens = np.array([[f'{(int(v) * 2654435761 + j) & 0xffffffff:08x}'
                        for j, v in enumerate(row)] for row in ids])
    tokens[rng.random((n, 26)) < 0.03] = ''
    label = rng.integers(0, 2, n).astype(str)
    names = ['label'] + [f'I{j}' for j in range(1, 14)] + \
        [f'C{j}' for j in range(1, 27)]
    with open(path, 'w') as f:
        f.write(','.join(names) + '\n')
        for row in np.concatenate([label[:, None], dense, tokens], axis=1):
            f.write(','.join(row) + '\n')


def _messy_frames():
    """``tests/test_streaming.py``'s messy shards."""
    rng = np.random.default_rng(7)
    frames = []
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
        frames.append(df)
    return frames


def _bool_frame():
    """The typed frame's columns as a CSV holds them (integer categories,
    text, True/False), with a bool column that misses values."""
    frame = _typed_frame()
    frame['c_int'] = frame['c_int'].astype(np.int64)
    frame['c_str'] = frame['c_str'].astype(str)
    flag = np.where(np.arange(len(frame)) % 3 == 0, 'True', 'False')
    flag[np.arange(len(frame)) % 17 == 5] = ''
    frame['flag_na'] = flag
    return frame


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    """(the directory, {name: (what ChunkedSource reads, target, config,
    chunk size)} of the sources compared with JAX, the synthetic shards of
    the fits)."""
    tmp = tmp_path_factory.mktemp('stream_numpy')
    out = {}
    paths = []
    for i, frame in enumerate(_messy_frames()):
        paths.append(str(tmp / f'messy_{i}.csv'))
        frame.to_csv(paths[-1], index=False)
    out['messy'] = (paths, 'y', MESSY_CONFIG, 150)
    out['typed'] = (_typed_frame(), 'y', TYPED_CONFIG, 150)
    path = str(tmp / 'bool.csv')
    _bool_frame().to_csv(path, index=False)
    out['bool_csv'] = ([path], 'y', TYPED_CONFIG, 100)
    paths = []
    for i, n in enumerate((600, 350)):
        paths.append(str(tmp / f'criteo_{i}.csv'))
        _criteo_csv(paths[-1], n, seed=40 + i)
    out['criteo'] = (paths, 'label', CRITEO_CONFIG, 250)
    synth = []
    for i in range(4):
        synth.append(str(tmp / f'synthetic_{i}.csv'))
        _synthetic(300, seed=200 + i).to_csv(synth[-1], index=False)
    return tmp, out, synth


def _frame_of(source):
    if isinstance(source, pd.DataFrame):
        return source
    return pd.concat([pd.read_csv(p) for p in source], ignore_index=True)


# ---------------------------------------------------------------- read_csv

EDGE_HEADER = 'i,i_na,f,f_long,b,b_na,empty,text,mixed,big,u64,under,nan_word,,i'
EDGE_ROWS = [
    '1,5,0.1,18.110448587857118,True,True,,x,00000003,1,18446744073709551615,1_000,NAN,a,7',
    '-2,,2.5e-3,1.7187464120374205,False,,,NA,a1b2c3d4,99999999999999999999,1,2,nan,b,8',
    '3, 6 ,inf,10.003443710689925,TRUE,False,,null,5,2,2,3,x,c,9',
    '',
    '   ',
    ' \t\r',
    '4,7,-1e400,1e-320,false,True,,N/A,6,3,3,4,y,d,10\r',
    '5,8, 1.5 ,0.30000000000000004,true,true,,#N/A,7,4,4,5,z,e,11',
    '6,9,1.0,123456789012345678901234,False,false,,<NA>,12e4,5,5,6,w,f,12',
    '7,10,-0.0,4.9e-324,True,False,,n/a,8,6,6,7,v,g',
]
QUOTED_ROWS = ['"8",11,"1,5","2",True,True,,"x, y","a\nb",7,7,8,u,"",13',
               '9,12,3,4,False,False,,"""q""",9,8,8,9,t,h,14', '"  "']
ONE_COLUMN_TEXT = '  \na\n1\n   \n"  "\n\t\n \t\r\n2\n\n3\n'


def _edge_text(quoted):
    rows = EDGE_ROWS + (QUOTED_ROWS if quoted else [])
    return EDGE_HEADER + '\n' + '\n'.join(rows) + '\n'


def _assert_chunk_is_frame(chunk, frame):
    """A ``Columns`` chunk holds what the DataFrame does: names, kinds as
    dtypes, values (NaN in place); chunks keep no row labels."""
    assert isinstance(chunk, cl.Columns)
    got = cl.to_frame(chunk)
    assert list(got.columns) == list(frame.columns)
    assert [str(t) for t in got.dtypes] == [str(t) for t in frame.dtypes]
    pd.testing.assert_frame_equal(got, frame.reset_index(drop=True))
    for name in frame.columns:
        if frame[name].dtype == object:
            assert [type(v) for v in chunk[name]] == \
                [type(v) for v in frame[name]], name


@pytest.mark.parametrize('case', ['plain', 'quoted', 'text_file',
                                  'no_header', 'small_blocks', 'non_ascii',
                                  'one_column', 'one_column_text'])
def test_read_csv_matches_pandas(case, tmp_path, monkeypatch):
    """Whole files and every chunk size: kinds and values of each chunk as
    ``pd.read_csv`` gives them, through the vectorised tokenizer ('plain',
    'no_header', 'small_blocks': 64-byte blocks, so chunks span blocks;
    'non_ascii': a block read through ``csv`` beside vectorised ones;
    'one_column_text': lines of spaces skipped) and through ``csv`` (a file
    with quotes, a text file object; 'one_column': a quoted field of spaces
    kept, lines of spaces skipped)."""
    text = _edge_text(case in ('quoted', 'text_file'))
    if case.startswith('one_column'):
        text = ONE_COLUMN_TEXT if case == 'one_column' \
            else ONE_COLUMN_TEXT.replace('"  "', 'x')
    if case == 'non_ascii':
        text = text.replace('x,00000003', 'café,00000003')
    if case in ('small_blocks', 'non_ascii'):
        monkeypatch.setattr(cl, 'CSV_BLOCK_BYTES', 64)
    header = None if case == 'no_header' else 0
    if header is None:
        text = text.split('\n', 1)[1]
    path = tmp_path / 'edge.csv'
    path.write_bytes(text.encode('utf-8'))
    for chunksize in (None, 1, 3, 4, 100):
        if case == 'text_file':
            got = cl.read_csv(io.StringIO(text, newline=''),
                              chunksize=chunksize, header=header)
        else:
            got = cl.read_csv(str(path), chunksize=chunksize, header=header)
        want = pd.read_csv(str(path), chunksize=chunksize, header=header)
        if chunksize is None:
            got, want = [got], [want]
        got, want = list(got), list(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_chunk_is_frame(a, b)
    if case != 'text_file':
        assert cl.count_csv_rows(str(path), header=header) == \
            len(pd.read_csv(str(path), header=header))


def test_read_csv_floats_as_pandas_parses_them(tmp_path):
    """pandas' default parser is not Python's ``float``: 17-digit texts,
    float32 reprs, exponents, subnormals and overflow, value for value."""
    rng = np.random.default_rng(3)
    values = np.concatenate([rng.normal(0, 10, 3000),
                             np.exp(rng.uniform(-700, 700, 3000)),
                             rng.random(3000).astype(np.float32)])
    texts = [repr(float(v)) for v in values] + \
        [str(np.float32(v)) for v in values[:3000]] + \
        ['%.5g' % v for v in values[3000:]] + \
        ['%.6f' % v for v in values[:3000]] + \
        ['%.15g' % v for v in values[:3000]] + \
        ['1e400', '-1e400', '0000000000000000001.5', '2.5e-320', '-0',
         '+1.25', ' 2.5 ', '.5', '7.', '999999999999999', '9999999999999999',
         'Infinity', '-inf']
    path = tmp_path / 'floats.csv'
    path.write_text('a\n' + '\n'.join(texts) + '\n')
    want = pd.read_csv(path)['a'].to_numpy()
    got = cl.read_csv(str(path))['a']
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert (np.signbit(got) == np.signbit(want)).all()
    assert (got != np.array([float(t) for t in texts])).any()


def test_read_csv_types_each_chunk_alone(tmp_path):
    """A column of digits in one chunk and of hex tokens in the next is
    int64, then text, as pandas types chunks; ``ColumnStats`` resolves it
    to text as the JAX package's does."""
    path = tmp_path / 'split.csv'
    path.write_text('c,y\n' + '00000003,1\n00000012,0\n' + 'a1b2c3d4,1\n'
                    '00000005,0\n')
    chunks = list(cl.read_csv(str(path), chunksize=2))
    assert [c.kinds['c'] for c in chunks] == ['int64', 'str']
    assert chunks[1]['c'].tolist() == ['a1b2c3d4', '00000005']
    for a, b in zip(chunks, pd.read_csv(path, chunksize=2)):
        _assert_chunk_is_frame(a, b)
    config = TYPED_CONFIG
    port = streaming.collect_streaming_stats(
        streaming.ChunkedSource(str(path), chunk_size=2), 'y',
        ModelConfig(**config))
    ref = jax_streaming.collect_streaming_stats(
        jax_streaming.ChunkedSource(str(path), chunk_size=2), 'y',
        JaxModelConfig(**config))
    assert _state(vars(port[0]['c'])) == _state(vars(ref[0]['c']))
    assert port[0]['c'].resolved_dtype == 'object'


# ---------------------------------------------------------------- concat

def _series(values, dtype=None):
    return pd.DataFrame({'a': pd.Series(values, dtype=dtype)})


CONCAT_CASES = {
    'int_float': ([1, 2], None, [1.5], None),
    'bool_int': ([True], None, [1, 2], None),
    'bool_float': ([True], None, [1.5], None),
    'bool_objectbool': ([True], None, [True, np.nan], object),
    'str_float': (['a'], 'str', [1.5], None),
    'str_allnan': (['a'], 'str', [np.nan], None),
    'str_int': (['a'], 'str', [1], None),
    'str_str': (['a'], 'str', ['b', np.nan], 'str'),
    'int_uint64': ([1], None, np.array([2 ** 63], np.uint64), None),
    'int_allnan': ([1], None, [np.nan], None),
    'bool_allnan': ([True], None, [np.nan], None),
    'int32_int64': (np.array([1], np.int32), None, [1], None),
    'int8_float32': (np.array([1], np.int8), None,
                     np.array([1.5], np.float32), None),
    'object_int': ([True, np.nan], object, [1], None),
    'category_same': (pd.Categorical([1, 2]), None,
                      pd.Categorical([2, 1], categories=[1, 2]), None),
    'category_other': (pd.Categorical([1, 2]), None, pd.Categorical([3]),
                       None),
    'category_text': (pd.Categorical(['a']), None, pd.Categorical(['b']),
                      None),
    'category_int': (pd.Categorical([1, 2]), None, [3], None),
}


@pytest.mark.parametrize('case', sorted(CONCAT_CASES))
def test_concat_matches_pandas(case):
    a, a_dtype, b, b_dtype = CONCAT_CASES[case]
    parts = [_series(a, a_dtype), _series(b, b_dtype)]
    got = cl.concat([cl.as_columns(p) for p in parts])
    want = pd.concat(parts, ignore_index=True)
    _assert_chunk_is_frame(got, want)


def test_concat_refuses_other_columns():
    with pytest.raises(ValueError, match='other columns'):
        cl.concat([cl.Columns({'a': np.arange(2)}),
                   cl.Columns({'b': np.arange(2)})])


@pytest.mark.parametrize('kind', ['csv', 'frame', 'dict', 'columns'])
def test_chunked_source_counts_the_rows_it_yields(kind, tmp_path):
    """``ChunkedSource.n_rows`` (the loader's ``steps``) is the rows its
    chunks hold: CSV lines of spaces are not rows."""
    table = {'a': np.arange(7), 'b': np.arange(7) * .5}
    if kind == 'csv':
        paths = []
        for k in range(2):
            paths.append(str(tmp_path / f'{k}.csv'))
            Path(paths[-1]).write_text(
                'a,b\n' + '\n  \n'.join(f'{i},{i / 2}' for i in range(7)))
    else:
        paths = {'frame': pd.DataFrame(table), 'dict': table,
                 'columns': cl.Columns(table)}[kind]
    source = streaming.ChunkedSource(paths, chunk_size=3)
    assert source.n_rows() == sum(len(c) for c in source.iter_chunks()) \
        == (14 if kind == 'csv' else 7)


# ---------------------------------------------------------------- two runs

SCRIPT = r'''
import os, pickle, sys
MODE, DATA, OUT = sys.argv[1:4]
if MODE == 'blocked':
    for name in BLOCKED:
        sys.modules[name] = None
import numpy as np
import torch
from deeptables_torch.data import columns as cl
from deeptables_torch.data import streaming
from deeptables_torch.models import DeepTable, ModelConfig, ModelInfo, ModelSet
from deeptables_torch.models import deeptable as dt_mod
from deeptables_torch.models.preprocessor import DefaultPreprocessor
from deeptables_torch.models.hyper_dt import HyperDT, Trial
from deeptables_torch.models.preprocessor import DefaultPreprocessor
from deeptables_torch.ops import metrics as metrics_lib
from deeptables_torch.utils import feature_importance, quicktest

with open(os.path.join(DATA, 'inputs.pkl'), 'rb') as f:
    inputs = pickle.load(f)
out = {}
if MODE == 'blocked':
    for name, (src, target, config, chunk) in inputs['sources'].items():
        source = streaming.ChunkedSource(src, chunk_size=chunk)
        result = {'chunks': list(source.iter_chunks()),
                  'sample': source.sample(250),
                  'stats': streaming.collect_streaming_stats(
                      source, target, ModelConfig(**config), seed=3)}
        for exact in (True, False):
            pre = DefaultPreprocessor(ModelConfig(**config), use_cache=False)
            try:
                streaming.fit_preprocessor_streaming(
                    pre, source, target, sample_rows=500, exact=exact)
            except ValueError as e:  # as the JAX package's fit raises
                pre = str(e)
            result[exact] = pre
        out[name] = result

state = torch.load(inputs['init'])
deep_model = dt_mod.DeepTable._deep_model
def bridged(self, model_file=None, custom_objects=None):
    model = deep_model(self, model_file, custom_objects)
    if model_file is None:
        model.build().load_state_dict(state)
    return model
dt_mod.DeepTable._deep_model = bridged

paths = inputs['synth']
config = dict(inputs['fit_config'])
pre = DefaultPreprocessor(ModelConfig(**config), use_cache=False)
source = streaming.ChunkedSource(paths, chunk_size=200)
streaming.fit_preprocessor_streaming(pre, source, 'y')
train = streaming.StreamingDataLoader(source, pre, 'y', batch_size=64, seed=3)
val = streaming.StreamingDataLoader(
    streaming.ChunkedSource(paths[:1], chunk_size=200), pre, 'y',
    batch_size=64, shuffle_in_chunk=False, drop_remainder=False)
dt = DeepTable(ModelConfig(home_dir=os.path.join(OUT, 'fit'), **config),
               device='cpu')
_, history = dt.fit(train, epochs=2, verbose=0, validation_data=val)
out['fit'] = {
    'history': dict(history.history.data),
    'evaluate': {k: float(v) for k, v in dt.evaluate(val).items()},
    'predict': dt.get_model().predict(val),
    'state': {k: v.numpy() for k, v in
              dt.get_model().module.state_dict().items()},
    'leaderboard': dt.leaderboard}
dt_cv = DeepTable(ModelConfig(home_dir=os.path.join(OUT, 'cv'), **config),
                  device='cpu')
out['cv'] = {'scores': dt_cv.fit_cross_validation_streaming(
    streaming.ChunkedSource(paths, chunk_size=300), target='y', num_folds=3,
    batch_size=64, epochs=1, verbose=0), 'leaderboard': dt_cv.leaderboard}

X_train = cl.read_csv(paths[1])
y_train = X_train.pop('y')
X_test = cl.read_csv(paths[2])
y_test = X_test.pop('y')
out['probe'] = [
    dt_mod.probe_evaluate(dt, X_train, y_train, X_test, y_test,
                          layers=PROBE_LAYERS, score_fn=score_fn)
    for score_fn in ({}, {'auc': metrics_lib.auc,
                          'accuracy': metrics_lib.accuracy})]
rows = X_test.take(np.arange(120))
out['importances'] = feature_importance.get_score_importances(
    dt, rows, y_test[:120], 'AUC', n_iter=1, mode='max')

boards = {}
ms = ModelSet(metric='AUC', best_mode='auto')
ms.push(ModelInfo('val', 'a', None, {'AUC': 0.7, 'loss': 0.5}))
ms.push(ModelInfo('test', 'b', None, {'AUC': 0.9}))
ms.push(ModelInfo('val', 'c', None, {'logloss': 0.4}))
boards['modelset'] = ms.leaderboard()
for metric, rewards in (('AUC', (0.7, float('nan'), 0.9, 0.65)),
                        ('logloss', (0.4, 0.3, float('nan'), 0.5))):
    hdt = HyperDT(reward_metric=metric, device='cpu')
    for i, reward in enumerate(rewards):
        hdt.history.append(Trial(
            trial_no=i + 1, sample={'config': {'nets': ['dnn_nets'] * (i + 1)}},
            reward=reward, elapsed=0.5 * i, succeeded=reward == reward))
    boards[f'hyper_dt_{metric}'] = hdt.leaderboard()
boards['hyper_dt_empty'] = HyperDT(reward_metric='AUC',
                                  device='cpu').leaderboard()
out['boards'] = boards

dt_mod.DeepTable._deep_model = deep_model
quick = quicktest.test(device='cpu')
out['quicktest'] = (quick.task, type(quick).__name__)
table = cl.read_parquet(os.path.join(DATA, 'table.parquet'))
out['parquet'] = {n: (table.kinds[n], table[n]) for n in table.columns}
out['modules'] = sorted(m for m in ('pandas', 'sklearn', 'pyarrow')
                        if sys.modules.get(m) is not None)
with open(os.path.join(OUT, 'result.pkl'), 'wb') as f:
    pickle.dump(out, f)
print('ok')
'''


def _start(mode, data, out):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1',
               MKL_NUM_THREADS='1', PYTHONPATH=str(REPO))
    return subprocess.Popen(
        [sys.executable, '-c',
         f'BLOCKED = {BLOCKED!r}\nPROBE_LAYERS = {PROBE_LAYERS!r}\n' + SCRIPT,
         mode, str(data), str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _parquet_frame():
    return pd.DataFrame({'x': np.arange(6, dtype=np.int32),
                         'f': [0.5, np.nan, 2.0, 3.0, np.nan, 1.0],
                         's': ['a', None, 'b', 'a', 'c', None]})


def _jax_pair(paths, config, chunk_size):
    """The port's and the JAX package's fitted streaming preprocessors."""
    port_config, jax_config = ModelConfig(**config), JaxModelConfig(**config)
    port = streaming.fit_preprocessor_streaming(
        DefaultPreprocessor(port_config, use_cache=False),
        streaming.ChunkedSource(paths, chunk_size=chunk_size), 'y')
    ref = jax_streaming.fit_preprocessor_streaming(
        JaxPreprocessor(jax_config, use_cache=False),
        jax_streaming.ChunkedSource(paths, chunk_size=chunk_size), 'y')
    return (port_config, port), (jax_config, ref)


def _unlabelled(frame):
    """The frame's columns without its pandas index (the blocked run
    unpickles them without pandas)."""
    columns = cl.as_columns(frame, rename=False)
    columns.index = None
    return columns


@pytest.fixture(scope='module')
def runs(shards):
    tmp, sources, synth = shards
    (config, pre), (jax_config, jax_pre) = _jax_pair(synth, FIT_CONFIG, 200)
    init = tmp / 'init.pt'
    torch.save(_jax_init_state(pre, config, jax_pre, jax_config), init)
    inputs = {'sources': {name: (_unlabelled(src)
                                 if isinstance(src, pd.DataFrame) else src,
                                 target, config, chunk)
                          for name, (src, target, config, chunk)
                          in sources.items()},
              'init': str(init), 'synth': synth, 'fit_config': FIT_CONFIG}
    with open(tmp / 'inputs.pkl', 'wb') as f:
        pickle.dump(inputs, f)
    _parquet_frame().to_parquet(tmp / 'table.parquet')
    procs = {}
    for mode in ('blocked', 'frame'):
        (tmp / mode).mkdir()
        procs[mode] = _start(mode, tmp, tmp / mode)
    results = {}
    for mode, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=240)
        finally:
            proc.kill()
        assert proc.returncode == 0, stderr[-4000:]
        assert stdout.split()[-1] == 'ok'
        with open(tmp / mode / 'result.pkl', 'rb') as f:
            results[mode] = pickle.load(f)
    return results


def test_blocked_run_imports_neither_pandas_nor_sklearn(runs):
    assert runs['blocked']['modules'] == []
    assert 'pandas' in runs['frame']['modules']
    assert runs['blocked']['quicktest'] == runs['frame']['quicktest'] == \
        ('binary', 'DeepTable')
    # Parquet reads without pandas and pyarrow (data/parquet.py), as
    # pd.read_parquet reads it
    expected = cl.as_columns(_parquet_frame(), rename=False)
    for mode in ('blocked', 'frame'):
        got = runs[mode]['parquet']
        assert list(got) == expected.columns
        for name in expected.columns:
            kind, values = got[name]
            assert kind == expected.kinds[name], name
            missing = cl.isna(expected[name])
            np.testing.assert_array_equal(cl.isna(values), missing)
            np.testing.assert_array_equal(values[~missing],
                                          expected[name][~missing],
                                          err_msg=name)


def test_read_table_reads_a_csv_path_as_pandas(shards):
    """``make_experiment``'s csv path through ``columns.read_csv``."""
    from deeptables_torch.models import hyper_dt
    path = shards[1]['criteo'][0][0]
    got = hyper_dt._read_table(path)
    assert isinstance(got, cl.Columns)
    _assert_chunk_is_frame(got, pd.read_csv(path))


# ---------------------------------------------------------------- vs JAX

@pytest.mark.parametrize('data', ['messy', 'typed', 'bool_csv', 'criteo'])
def test_chunks_match_jax(runs, shards, data):
    src, target, config, chunk = shards[1][data]
    got = runs['blocked'][data]
    ref = jax_streaming.ChunkedSource(src, chunk_size=chunk)
    ref_chunks = list(ref.iter_chunks())
    assert len(got['chunks']) == len(ref_chunks) > 1
    for a, b in zip(got['chunks'], ref_chunks):
        _assert_chunk_is_frame(a, b)
    _assert_chunk_is_frame(got['sample'], ref.sample(250))


@pytest.mark.parametrize('data', ['messy', 'typed', 'bool_csv', 'criteo'])
def test_streaming_stats_match_jax(runs, shards, data):
    src, target, config, chunk = shards[1][data]
    stats, y_stats, n_rows = runs['blocked'][data]['stats']
    ref_stats, ref_y, ref_n = jax_streaming.collect_streaming_stats(
        jax_streaming.ChunkedSource(src, chunk_size=chunk), target,
        JaxModelConfig(**config), seed=3)
    assert n_rows == ref_n and list(stats) == list(ref_stats)
    for name in ref_stats:
        assert _state(vars(stats[name])) == _state(vars(ref_stats[name])), \
            name
        st, ref_st = stats[name], ref_stats[name]
        assert (st.resolved_dtype, st.wants_string_fill, st.nunique,
                st.mean) == (ref_st.resolved_dtype, ref_st.wants_string_fill,
                             ref_st.nunique, ref_st.mean), name
    assert _state(vars(y_stats)) == _state(vars(ref_y))


@pytest.mark.parametrize('exact', [True, False], ids=['exact', 'sample'])
@pytest.mark.parametrize('data', ['messy', 'typed', 'bool_csv', 'criteo'])
def test_streaming_preprocessor_matches_jax(runs, shards, data, exact):
    src, target, config, chunk = shards[1][data]
    port = runs['blocked'][data][exact]
    ref = JaxPreprocessor(JaxModelConfig(**config), use_cache=False)
    fit = functools.partial(
        jax_streaming.fit_preprocessor_streaming, ref,
        jax_streaming.ChunkedSource(src, chunk_size=chunk), target,
        sample_rows=500, exact=exact)
    if isinstance(port, str):
        # a bool column without missing values reaches SimpleImputer in the
        # sample's in-memory fit, which refuses it in both packages
        assert (data, exact) == ('bool_csv', False)
        with pytest.raises(ValueError) as error:
            fit()
        assert str(error.value) == port
        return
    fit()
    assert _columns(port) == _columns(ref)
    assert _state(port.X_transformers) == _state(ref.X_transformers)
    full = _frame_of(src)
    X = full.drop(columns=[target])
    _assert_frames_equal(port.transform_X(X.copy()), ref.transform_X(X.copy()))
    np.testing.assert_array_equal(port.transform_y(full[target]),
                                  ref.transform_y(full[target]))


@pytest.fixture(scope='module')
def jax_stream_fit(shards):
    """The JAX package's DeepTable fit over its StreamingDataLoader, as the
    runs fit theirs."""
    tmp, _, synth = shards
    (_, _), (jax_config, jax_pre) = _jax_pair(synth, FIT_CONFIG, 200)
    source = jax_streaming.ChunkedSource(synth, chunk_size=200)
    train = jax_streaming.StreamingDataLoader(source, jax_pre, 'y',
                                              batch_size=64, seed=3)
    val = jax_streaming.StreamingDataLoader(
        jax_streaming.ChunkedSource(synth[:1], chunk_size=200), jax_pre, 'y',
        batch_size=64, shuffle_in_chunk=False, drop_remainder=False)
    dt = JaxDeepTable(JaxModelConfig(home_dir=str(tmp / 'jax'), **FIT_CONFIG))
    _, history = dt.fit(train, epochs=2, verbose=0, validation_data=val)
    return dt, history, val, jax_pre


@pytest.mark.parametrize('part', ['history', 'state', 'evaluate_predict',
                                  'cv', 'leaderboard'])
def test_stream_fit_blocked_equals_frame(runs, part):
    blocked, frame = runs['blocked'], runs['frame']
    if part == 'history':
        assert blocked['fit']['history'] == frame['fit']['history']
    elif part == 'state':
        assert list(blocked['fit']['state']) == list(frame['fit']['state'])
        for k, v in blocked['fit']['state'].items():
            np.testing.assert_array_equal(v, frame['fit']['state'][k],
                                          err_msg=k)
    elif part == 'evaluate_predict':
        assert blocked['fit']['evaluate'] == frame['fit']['evaluate']
        np.testing.assert_array_equal(blocked['fit']['predict'],
                                      frame['fit']['predict'])
    elif part == 'cv':
        assert blocked['cv']['scores'] == frame['cv']['scores']
        assert len(blocked['cv']['scores']) == 3
        assert all(np.isfinite(v) for s in blocked['cv']['scores']
                   for v in s.values())
    else:
        for key in ('fit', 'cv'):
            board = blocked[key]['leaderboard']
            assert isinstance(board, cl.Columns)
            _assert_chunk_is_frame(board, frame[key]['leaderboard'])


@pytest.mark.parametrize('key', ['loss', 'val_loss', 'val_auc'])
def test_stream_fit_history_matches_jax(runs, jax_stream_fit, key):
    _, history, _, _ = jax_stream_fit
    got = runs['blocked']['fit']['history'][key]
    assert len(got) == 2
    np.testing.assert_allclose(got, history.history[key], rtol=1e-4)


def test_stream_fit_state_and_scores_match_jax(runs, shards,
                                               jax_stream_fit):
    dt, _, val, jax_pre = jax_stream_fit
    (config, pre), _ = _jax_pair(shards[2], FIT_CONFIG, 200)
    fit = runs['blocked']['fit']
    expected = bridge.state_dict_from_flax(
        jax.device_get(dt.get_model().variables), pre.categorical_columns,
        pre.continuous_columns, config)
    assert set(fit['state']) == set(expected)
    for key, value in fit['state'].items():
        np.testing.assert_allclose(value, expected[key].numpy(), rtol=0,
                                   atol=2e-4, err_msg=key)
    score = dict(dt.evaluate(val))
    assert sorted(fit['evaluate']) == sorted(score)
    for key in score:
        np.testing.assert_allclose(fit['evaluate'][key], score[key],
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(fit['predict'],
                               dt.get_model().predict(val), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- probe

def test_probe_blocked_equals_frame(runs):
    blocked, frame = runs['blocked']['probe'], runs['frame']['probe']
    assert blocked == frame
    assert set(blocked[0]) == set(PROBE_LAYERS)
    assert all(0 < v['accuracy'] <= 1 for v in blocked[0].values())
    assert all(np.isfinite(v['auc']) for v in blocked[1].values())


@pytest.fixture(scope='module')
def bank_dt(tmp_path_factory):
    """A port DeepTable and a JAX one whose weights it holds (bridged),
    fitted on bank rows, with 100 rows to score on."""
    df = load_bank(400)
    y = df.pop('y')
    kwargs = dict(nets=['linear', 'dnn_nets'], metrics=['AUC'],
                  embedding_dropout=0,
                  dnn_params={'hidden_units': ((16, 0, False),),
                              'activation': 'relu'},
                  home_dir=str(tmp_path_factory.mktemp('bank_dt')))
    jax_dt = JaxDeepTable(JaxModelConfig(**kwargs))
    jax_dt.fit(df, y, epochs=1, verbose=0)
    port_dt = DeepTable(ModelConfig(**kwargs), device='cpu')
    port_dt.fit(df, y, epochs=1, verbose=0)
    pre = port_dt.preprocessor
    port_dt.get_model().module.load_state_dict(bridge.state_dict_from_flax(
        jax.device_get(jax_dt.get_model().variables),
        pre.categorical_columns, pre.continuous_columns, port_dt.config))
    return port_dt, jax_dt, df, y


def test_probe_evaluate_matches_jax(bank_dt):
    """The port's probe (scipy) and the JAX package's (scikit-learn) on the
    same features: AUC within 1e-6 (scikit-learn's ``roc_auc_score`` given
    to both, and the port's ``metrics.auc``), accuracy equal."""
    from sklearn.metrics import accuracy_score, roc_auc_score
    dt, _, df, y = bank_dt
    args = (dt, df.iloc[:300], y.iloc[:300], df.iloc[300:], y.iloc[300:])
    layers = ['flatten_embeddings', 'dnn_nets_out']
    for score_fn in ({}, {'auc': roc_auc_score, 'accuracy': accuracy_score}):
        got = dt_mod.probe_evaluate(*args, layers=layers, score_fn=score_fn)
        want = jax_dt_mod.probe_evaluate(*args, layers=layers,
                                         score_fn=score_fn)
        assert sorted(got) == sorted(want) == sorted(layers)
        for layer in layers:
            assert sorted(got[layer]) == sorted(want[layer])
            for metric, value in want[layer].items():
                tol = 1e-6 if metric == 'auc' else 0
                assert abs(got[layer][metric] - value) <= tol, \
                    (layer, metric)
    own = dt_mod.probe_evaluate(*args, layers=layers,
                                score_fn={'auc': metrics_lib.auc})
    for layer in layers:
        assert abs(own[layer]['auc'] - got[layer]['auc']) <= 1e-6


@pytest.mark.parametrize('case', ['binary_float32', 'binary_float64',
                                  'binary_wide', 'multiclass'])
def test_logistic_regression_matches_sklearn(case):
    """``_logistic_regression`` against ``LogisticRegression(random_state=0,
    max_iter=1000)``: probabilities within 1e-6, labels equal but where
    p is within 1e-6 of 0.5."""
    from sklearn.linear_model import LogisticRegression
    rng = np.random.default_rng(['binary_float32', 'binary_float64',
                                 'binary_wide', 'multiclass'].index(case))
    n, f, k = {'binary_float32': (1500, 24, 2), 'binary_float64': (1200, 12, 2),
               'binary_wide': (800, 200, 2), 'multiclass': (1500, 16, 3)}[case]
    dtype = np.float64 if case == 'binary_float64' else np.float32
    X = (rng.normal(size=(n, f)) * rng.uniform(0.1, 3, f)).astype(dtype)
    y = (X @ rng.normal(size=(f, k)) + 2 * rng.normal(size=(n, k))).argmax(1)
    X_test = rng.normal(size=(400, f)).astype(dtype)
    clf = LogisticRegression(random_state=0, max_iter=1000).fit(X, y)
    model = dt_mod._logistic_regression(X, y)
    proba, labels = dt_mod._logistic_predict(model, X_test)
    want = clf.predict_proba(X_test)
    assert proba.dtype == want.dtype
    np.testing.assert_allclose(proba, want, rtol=0, atol=1e-6)
    near = (np.abs(want - 0.5) < 1e-6).any(axis=1)
    np.testing.assert_array_equal(labels[~near],
                                  clf.predict(X_test)[~near])


# ---------------------------------------------------------------- reporting

@pytest.mark.parametrize('board', ['modelset', 'hyper_dt_AUC',
                                   'hyper_dt_logloss', 'hyper_dt_empty'])
def test_leaderboards_blocked_equal_frames(runs, board):
    got = runs['blocked']['boards'][board]
    want = runs['frame']['boards'][board]
    assert isinstance(got, cl.Columns) and isinstance(want, pd.DataFrame)
    if board == 'hyper_dt_empty':
        assert len(got) == len(want) == 0 and got.columns == []
        return
    pd.testing.assert_frame_equal(cl.to_frame(got), want)
    if board.startswith('hyper_dt'):
        rewards = want['reward'].to_numpy()
        finite = rewards[np.isfinite(rewards)]
        assert list(finite) == sorted(finite, reverse=board.endswith('AUC'))
        assert np.isnan(rewards[-1])


@pytest.mark.parametrize('mode', ['order', 'rate'])
def test_target_rate_encoding_on_columns_matches_jax(mode):
    rng = np.random.default_rng(11)
    n = 300
    df = pd.DataFrame({'c': rng.choice(list('abcdefgh'), n),
                       'd': rng.integers(0, 30, n).astype(float),
                       'e': rng.choice(['u', 'v'], n),
                       'y': rng.integers(0, 2, n)})
    df.loc[rng.random(n) < 0.1, 'd'] = np.nan
    df.loc[rng.random(n) < 0.1, 'c'] = np.nan
    want = jax_preprocessing.target_rate_encodeing(['c', 'd', 'e'], 'y', df,
                                                   mode=mode)
    got = preprocessing.target_rate_encodeing(['c', 'd', 'e'], 'y', df,
                                              mode=mode)
    pd.testing.assert_frame_equal(got, want)
    columns = preprocessing.target_rate_encodeing(
        ['c', 'd', 'e'], 'y', cl.as_columns(df), mode=mode)
    assert isinstance(columns, cl.Columns)
    pd.testing.assert_frame_equal(cl.to_frame(columns), want)


def test_score_importances_on_columns_match_the_frame_and_jax(bank_dt,
                                                              runs):
    """Bit-equal on ``Columns`` and on the DataFrame (the same
    permutations); within 1e-5 of the JAX package's loop over the JAX
    ``DeepTable`` whose weights the port's holds."""
    dt, jax_dt, df, y = bank_dt
    X, y = df.iloc[:100], y.iloc[:100]
    frame = feature_importance.get_score_importances(dt, X, y, 'AUC',
                                                     n_iter=1, mode='max')
    columns = feature_importance.get_score_importances(
        dt, cl.as_columns(X), y.to_numpy(), 'AUC', n_iter=1, mode='max')
    np.testing.assert_array_equal(columns, frame)
    ref = jax_fi.get_score_importances(jax_dt, X, y, 'AUC', n_iter=1,
                                       mode='max')
    got = {name: float(v) for name, v in frame}
    want = {name: float(v) for name, v in ref}
    assert sorted(got) == sorted(want) == sorted(X.columns)
    for name in want:
        assert abs(got[name] - want[name]) <= 1e-5, name
    blocked = runs['blocked']['importances']
    np.testing.assert_array_equal(blocked, runs['frame']['importances'])
    values = blocked[:, 1].astype(float)
    assert np.isfinite(values).all()
    assert list(values) == sorted(values, reverse=True)
