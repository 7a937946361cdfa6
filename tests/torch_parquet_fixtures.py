"""The Parquet files under ``tests/torch_data/``, and how they were written
(pandas 3.0.3 and pyarrow 25.0.0).

``python tests/torch_parquet_fixtures.py`` writes them again. The bank
table in two SNAPPY shards feeds a streaming fit; the edge-case files cover
what ``deeptables_torch/data/parquet.py`` reads: every kind with nulls,
GZIP, uncompressed, data page v2, no dictionary, a dictionary that falls
back to PLAIN, several row groups, a stored index, a range index that
does not start at 0 and zero rows.
``test_torch_parquet.py`` holds the reader to ``pd.read_parquet`` on them,
and ``chip_smoke.py`` holds it to their digests (``PARQUET_DIGESTS``).
"""

from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / 'torch_data'
BANK_SHARDS = ('bank_0.parquet', 'bank_1.parquet')
BANK_ROWS = 20000


def kinds_frame(n, seed=0):
    """A DataFrame with a column of every kind the reader types, most with
    nulls: integers of each width, floats, booleans (plain, object with
    None, pandas' nullable), strings, categoricals, nullable integers and
    floats, timestamps, an all-null column and constant columns."""
    import pandas as pd
    rs = np.random.RandomState(seed)
    text = rs.choice(['a', 'bb', 'ccc', 'é', '', None], n)

    def holes(values, share=0.2):
        return list(np.where(rs.rand(n) < share, None, values))

    return pd.DataFrame({
        'i64': rs.randint(-10 ** 9, 10 ** 9, n).astype(np.int64) * 1000,
        'i32': rs.randint(-50, 50, n).astype(np.int32),
        'i16': rs.randint(-5, 5, n).astype(np.int16),
        'i8': rs.randint(-5, 5, n).astype(np.int8),
        'u8': rs.randint(0, 255, n).astype(np.uint8),
        'u16': rs.randint(0, 60000, n).astype(np.uint16),
        'u32': rs.randint(0, 2 ** 32 - 1, n, dtype=np.uint64)
        .astype(np.uint32),
        'u64': rs.randint(0, 2 ** 63, n, dtype=np.uint64) * 2 + 1,
        'f32': np.where(rs.rand(n) < .2, np.nan, rs.randn(n))
        .astype(np.float32),
        'f64': np.where(rs.rand(n) < .2, np.nan, rs.randn(n)),
        'b': rs.rand(n) < .5,
        'b_none': pd.array(holes(rs.rand(n) < .5), dtype=object),
        'b_nullable': pd.array(holes(rs.rand(n) < .5), dtype='boolean'),
        's': pd.array(text, dtype='str'),
        's_object': pd.Series(list(text), dtype=object),
        's_long': [f'{i}-' * (i % 7) for i in range(n)],
        'cat': pd.Categorical(rs.choice(['q', 'p', None, 'r'], n),
                              categories=['r', 'q', 'p', 'unused']),
        'cat_int': pd.Categorical(rs.choice([3, 1, 2], n)),
        'Int64': pd.array(holes(rs.randint(0, 9, n)), dtype='Int64'),
        'UInt8': pd.array(holes(rs.randint(0, 9, n)), dtype='UInt8'),
        'Float32': pd.array(holes(rs.rand(n)), dtype='Float32'),
        'when': pd.to_datetime(rs.randint(1.5e9, 1.7e9, n), unit='s')
        .where(rs.rand(n) > .2),
        'when_ns': pd.to_datetime(rs.randint(1.5e9, 1.7e9, n), unit='s')
        .astype('datetime64[ns]'),
        'empty': [None] * n,
        # one value: dictionary indices of bit width 0
        'const': np.full(n, 3.5),
        'const_s': ['same'] * n,
    })


def edge_cases():
    """{file name: (DataFrame, DataFrame.to_parquet's arguments)}."""
    import pandas as pd
    base = kinds_frame(400)
    rs = np.random.RandomState(5)
    wide = pd.DataFrame({
        'cat': pd.Categorical([f'k{v:05d}' for v in
                               rs.randint(0, 5000, 1500)]),
        'code': [f'v{v:05d}' for v in rs.randint(0, 5000, 1500)],
        'x': rs.randn(1500)})
    return {
        'kinds_snappy.parquet': (base, {}),
        'kinds_gzip.parquet': (base, {'compression': 'gzip'}),
        'kinds_uncompressed.parquet': (base, {'compression': None}),
        'kinds_page_v2.parquet': (base, {'data_page_version': '2.0'}),
        'kinds_no_dictionary.parquet': (base, {'use_dictionary': False}),
        'dictionary_fallback.parquet': (
            wide, {'dictionary_pagesize_limit': 2000,
                   'data_page_size': 4096}),
        'row_groups.parquet': (base, {'row_group_size': 90,
                                      'data_page_version': '2.0'}),
        'index.parquet': (base.set_index(
            pd.Index(rs.permutation(len(base)) * 3, name='key')), {}),
        'range_index.parquet': (base.iloc[::3], {}),
        'zero_rows.parquet': (base.iloc[:0], {}),
    }


def bank_shards():
    """The bank table (``load_bank(20000)``) as two SNAPPY shards."""
    from deeptables_torch.data import datasets
    table = datasets.load_bank(BANK_ROWS)
    half = len(table) // 2
    return {BANK_SHARDS[0]: (table.iloc[:half].reset_index(drop=True), {}),
            BANK_SHARDS[1]: (table.iloc[half:].reset_index(drop=True), {})}


def write(out=DATA):
    out.mkdir(parents=True, exist_ok=True)
    for name, (frame, kwargs) in {**bank_shards(), **edge_cases()}.items():
        frame.to_parquet(out / name, **kwargs)


if __name__ == '__main__':
    write()
