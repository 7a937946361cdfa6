"""The port's Parquet reader (``deeptables_torch/data/parquet.py``) against
``pd.read_parquet`` (pandas 3, pyarrow) on the CPU.

``columns.read_parquet`` must give exactly what
``columns.as_columns(pd.read_parquet(path), rename=False)`` gives: the
same names in the same order, the same kinds, values and categories. It is
held so on the committed files of ``tests/torch_data/``
(``tests/torch_parquet_fixtures.py``) and on files written here with each
writer setting it reads; codecs, encodings and schemas it does not read
raise by name. The fixtures' digests, which ``chip_smoke.py`` holds the
reader to on the card, are recomputed from pandas, and ``ChunkedSource``
streams Parquet in a subprocess with pandas and pyarrow blocked.
"""

import decimal
import importlib.util
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deeptables_torch.data import columns as cl
from deeptables_torch.data import parquet, streaming
from deeptables_torch.models import hyper_dt
from deeptables_torch.tools import parity_quality

import torch_parquet_fixtures as fixtures

REPO = Path(__file__).resolve().parents[1]
FILES = sorted(p.name for p in fixtures.DATA.glob('*.parquet'))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _same_values(got, expected):
    if got.dtype != expected.dtype or got.shape != expected.shape:
        return False
    if expected.dtype.kind != 'O':
        return np.array_equal(got, expected,
                              equal_nan=expected.dtype.kind in 'fmM')
    for a, b in zip(got, expected):
        nan = isinstance(a, float) and isinstance(b, float) and a != a
        if not (nan and b != b) and not (type(a) is type(b) and a == b):
            return False
    return True


def _assert_reads_as_pandas(path):
    expected = cl.as_columns(pd.read_parquet(path), rename=False)
    got = cl.read_parquet(str(path))
    assert isinstance(got, cl.Columns)
    assert got.columns == expected.columns
    for name in expected.columns:
        assert got.kinds[name] == expected.kinds[name], name
        assert _same_values(got[name], expected[name]), \
            (name, got[name][:6], expected[name][:6])
        categories = expected.categories.get(name)
        assert (name in got.categories) == (categories is not None), name
        if categories is not None:
            assert _same_values(np.asarray(got.categories[name]),
                                np.asarray(categories)), name
    index = expected.index
    if type(index).__name__ != 'RangeIndex' or index.start or \
            index.step != 1:
        np.testing.assert_array_equal(got.index, np.asarray(index))
    else:
        assert got.index is None
    assert parquet.num_rows(str(path)) == len(expected)


@pytest.mark.parametrize('name', FILES)
def test_fixture_reads_as_pandas(name):
    _assert_reads_as_pandas(fixtures.DATA / name)


WRITES = {
    'snappy': {},
    'gzip': {'compression': 'gzip'},
    'uncompressed': {'compression': None},
    'page_v2': {'data_page_version': '2.0'},
    'page_v2_gzip': {'data_page_version': '2.0', 'compression': 'gzip'},
    'page_v2_uncompressed': {'data_page_version': '2.0',
                             'compression': None},
    'no_dictionary': {'use_dictionary': False},
    'dictionary_fallback': {'dictionary_pagesize_limit': 256,
                            'data_page_size': 512},
    'row_groups': {'row_group_size': 70},
    'small_pages_v2': {'row_group_size': 150, 'data_page_size': 300,
                       'data_page_version': '2.0'},
    'format_1_0': {'version': '1.0'},
}


@pytest.mark.parametrize('rows', [0, 1, 311])
@pytest.mark.parametrize('setting', list(WRITES))
def test_written_file_reads_as_pandas(tmp_path, setting, rows):
    frame = fixtures.kinds_frame(rows, seed=len(setting))
    path = tmp_path / f'{setting}.parquet'
    frame.to_parquet(path, **WRITES[setting])
    _assert_reads_as_pandas(path)


@pytest.mark.parametrize('case', ['all_null', 'stored_index',
                                  'string_index', 'range_index',
                                  'categorical_fallback'])
def test_written_edge_reads_as_pandas(tmp_path, case):
    rs = np.random.RandomState(3)
    frame = fixtures.kinds_frame(120, seed=4)
    kwargs = {}
    if case == 'all_null':
        for name in ('f64', 'b_none', 'b_nullable', 's', 's_object', 'cat',
                     'Int64', 'Float32', 'when'):
            frame[name] = frame[name].where(np.zeros(len(frame), bool))
    elif case == 'stored_index':
        frame.index = pd.Index(rs.permutation(len(frame)), name='key')
    elif case == 'string_index':
        frame.index = [f'r{i}' for i in range(len(frame))]
    elif case == 'range_index':
        frame = frame.iloc[5::2]
    else:
        frame = pd.DataFrame({'c': pd.Categorical(
            [f'k{v:04d}' for v in rs.randint(0, 3000, 2000)])})
        kwargs = {'dictionary_pagesize_limit': 1000, 'row_group_size': 700}
    path = tmp_path / f'{case}.parquet'
    frame.to_parquet(path, **kwargs)
    _assert_reads_as_pandas(path)


@pytest.mark.parametrize('codec', ['zstd', 'lz4', 'brotli'])
def test_codecs_not_read_raise_by_name(tmp_path, codec):
    path = tmp_path / 'c.parquet'
    fixtures.kinds_frame(20).to_parquet(path, compression=codec)
    name = {'lz4': 'LZ4'}.get(codec, codec.upper())
    with pytest.raises(ValueError, match=name):
        cl.read_parquet(str(path))


@pytest.mark.parametrize('column, encoding', [
    ('i64', 'DELTA_BINARY_PACKED'), ('f64', 'BYTE_STREAM_SPLIT'),
    ('s', 'DELTA_LENGTH_BYTE_ARRAY'), ('s', 'DELTA_BYTE_ARRAY')])
def test_encodings_not_read_raise_by_name(tmp_path, column, encoding):
    path = tmp_path / 'e.parquet'
    table = pa.Table.from_pandas(fixtures.kinds_frame(50)[[column]])
    pq.write_table(table, path, use_dictionary=False,
                   column_encoding={column: encoding})
    with pytest.raises(ValueError, match=encoding):
        cl.read_parquet(str(path))


def test_nested_schema_and_other_types_raise(tmp_path):
    path = tmp_path / 'n.parquet'
    pq.write_table(pa.table({'x': [[1, 2], [3]]}), path)
    with pytest.raises(ValueError, match='nested'):
        cl.read_parquet(str(path))
    amounts = [decimal.Decimal('1.50'), decimal.Decimal('2.25')]
    pq.write_table(pa.table({'d': pa.array(amounts, pa.decimal128(5, 2))}),
                   path)
    with pytest.raises(ValueError, match='FIXED_LEN_BYTE_ARRAY|DECIMAL'):
        cl.read_parquet(str(path))
    path.write_bytes(b'not parquet at all')
    with pytest.raises(ValueError, match='Parquet'):
        cl.read_parquet(str(path))


@pytest.mark.parametrize('data', ['random', 'repeats', 'text', 'empty'])
def test_snappy_decompress_matches_pyarrows_compress(data):
    rs = np.random.RandomState(1)
    raw = {'random': rs.bytes(70000),
           'repeats': b'abc' * 30000 + bytes(5000) + b'xy' * 7,
           'text': ' '.join(f'word{v}' for v in rs.randint(0, 300, 20000))
           .encode(),
           'empty': b''}[data]
    packed = pa.compress(raw, codec='snappy', asbytes=True)
    assert parquet.snappy_decompress(packed) == raw


def test_fixture_digests_are_pandas_tables():
    """``PARQUET_DIGESTS`` in chip_smoke.py are the digests of
    ``pd.read_parquet``'s tables of the committed files, and every file is
    listed."""
    cs = _chip_smoke()
    assert sorted(cs.PARQUET_DIGESTS) == FILES
    assert tuple(cs.PARQUET_BANK) == fixtures.BANK_SHARDS
    for name in FILES:
        table = cl.as_columns(pd.read_parquet(fixtures.DATA / name),
                              rename=False)
        assert cs.columns_digest(parity_quality, table) == \
            cs.PARQUET_DIGESTS[name], name
    assert sum((fixtures.DATA / n).stat().st_size for n in FILES) < 2 << 20


def test_read_table_reads_a_parquet_path():
    path = str(fixtures.DATA / fixtures.BANK_SHARDS[0])
    got = hyper_dt._read_table(path)
    expected = cl.as_columns(pd.read_parquet(path), rename=False)
    assert got.columns == expected.columns
    for name in expected.columns:
        assert _same_values(got[name], expected[name]), name


STREAM = r'''
import pickle, sys
for name in ('pandas', 'pyarrow', 'sklearn'):
    sys.modules[name] = None
from deeptables_torch.data import streaming
paths, out = sys.argv[1:-1], sys.argv[-1]
source = streaming.ChunkedSource(paths, chunk_size=3000)
chunks = [{n: (c.kinds[n], c[n]) for n in c.columns}
          for c in source.iter_chunks()]
with open(out, 'wb') as f:
    pickle.dump({'n_rows': source.n_rows(), 'chunks': chunks,
                 'modules': [m for m in ('pandas', 'pyarrow', 'sklearn')
                             if sys.modules.get(m) is not None]}, f)
print('ok')
'''


def test_chunked_source_streams_parquet_without_pandas(tmp_path):
    paths = [str(fixtures.DATA / n) for n in fixtures.BANK_SHARDS]
    out = tmp_path / 'chunks.pkl'
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1',
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', STREAM, *paths, str(out)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, 'rb') as f:
        result = pickle.load(f)
    assert result['modules'] == []
    expected = [c for c in streaming.ChunkedSource(
        [pd.read_parquet(p) for p in paths], chunk_size=3000).iter_chunks()]
    assert result['n_rows'] == sum(len(c) for c in expected) == \
        fixtures.BANK_ROWS
    assert len(result['chunks']) == len(expected)
    for got, chunk in zip(result['chunks'], expected):
        assert list(got) == chunk.columns
        for name in chunk.columns:
            kind, values = got[name]
            assert kind == chunk.kinds[name], name
            assert _same_values(values, chunk[name]), name
