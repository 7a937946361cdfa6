"""The Parquet files under ``tests/torch_data/``, and how they were written
(pandas 3.0.3 and pyarrow 25.0.0).

``python tests/torch_parquet_fixtures.py`` writes them again. The bank
table in two SNAPPY shards feeds a streaming fit; the edge-case files cover
what ``deeptables_torch/data/parquet.py`` reads: every kind with nulls,
GZIP, uncompressed, data page v2, no dictionary, a dictionary that falls
back to PLAIN, several row groups, a stored index, a range index that
does not start at 0 and zero rows. Since then, the codecs and encodings
that ``csrc/parquet_codecs.cpp`` and the numpy decoders read:

- ``kinds_zstd.parquet`` and ``kinds_lz4_raw.parquet``: the kinds frame in
  ZSTD and in LZ4_RAW (pyarrow's ``compression='lz4'``);
- ``kinds_brotli.parquet``: the kinds frame in BROTLI at level 11;
- ``kinds_lz4_hadoop.parquet``: the LZ4_RAW file with its footer's codec
  rewritten from 7 to 5 (LZ4), which pyarrow reads through its fall-back
  from Hadoop's framing to a bare block;
- ``kinds_delta.parquet``: the kinds frame without dictionary, data page
  v2, its integers DELTA_BINARY_PACKED (``i32``: BYTE_STREAM_SPLIT), its
  floats BYTE_STREAM_SPLIT, its strings DELTA_BYTE_ARRAY (``s_object``:
  DELTA_LENGTH_BYTE_ARRAY);
- ``int96.parquet``: timestamps as INT96 (Impala's and Spark's), with
  nulls, dictionary-encoded and not;
- the Criteo-layout shards of ``chip_smoke.py``'s ``parquet`` phase: a
  label, 13 dense and 26 hex-token categorical columns
  (``chip_smoke.criteo_tokens``) of ``load_criteo_synthetic``'s rows, with
  the missing shares of its CSV shards (``STREAM_CSV_MISSING``):
  ``criteo_train_0.parquet`` (ZSTD, dictionary-encoded),
  ``criteo_train_1.parquet`` (ZSTD, no dictionary: DELTA_BYTE_ARRAY tokens,
  BYTE_STREAM_SPLIT dense columns, a DELTA_BINARY_PACKED label, page v2),
  16,384 rows each (ZSTD level 19), and ``criteo_val.parquet`` (LZ4_RAW,
  4,096 rows).

``test_torch_parquet.py`` holds the reader to ``pd.read_parquet`` on them,
and ``chip_smoke.py`` holds it to their digests (``PARQUET_DIGESTS``).
"""

import importlib.util
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / 'torch_data'
REPO = Path(__file__).resolve().parents[1]
BANK_SHARDS = ('bank_0.parquet', 'bank_1.parquet')
BANK_ROWS = 20000
CRITEO_SHARDS = ('criteo_train_0.parquet', 'criteo_train_1.parquet')
CRITEO_VAL = 'criteo_val.parquet'
CRITEO_ROWS, CRITEO_VAL_ROWS, CRITEO_SEED = 16384, 4096, 41
# the files written since the codecs and encodings above are read
NEW_FILES = ('kinds_zstd.parquet', 'kinds_lz4_raw.parquet',
             'kinds_lz4_hadoop.parquet', 'kinds_delta.parquet',
             'int96.parquet', 'kinds_brotli.parquet') + CRITEO_SHARDS + (
                 CRITEO_VAL,)
# the compact protocol's ColumnMetaData.codec (field 4, an i32, after field
# 3): LZ4_RAW (7) and LZ4 (5) as zig-zag varints
CODEC_LZ4_RAW, CODEC_LZ4 = b'\x15\x0e', b'\x15\x0a'


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


def delta_encodings(frame):
    """``column_encoding`` for the kinds frame without dictionary."""
    import pyarrow as pa
    table = pa.Table.from_pandas(frame)
    out = {}
    for field in table.schema:
        kind = field.type
        if pa.types.is_integer(kind):
            out[field.name] = 'DELTA_BINARY_PACKED'
        elif pa.types.is_floating(kind):
            out[field.name] = 'BYTE_STREAM_SPLIT'
        elif pa.types.is_string(kind) or pa.types.is_large_string(kind):
            out[field.name] = 'DELTA_BYTE_ARRAY'
    out.update(i32='BYTE_STREAM_SPLIT', s_object='DELTA_LENGTH_BYTE_ARRAY')
    return out


def int96_frame(n=300, seed=6):
    import pandas as pd
    rs = np.random.RandomState(seed)
    when = pd.to_datetime(rs.randint(-2e9, 4e9, n), unit='s')
    return pd.DataFrame({
        'when': when.where(rs.rand(n) > .2),
        'when_ns': (when + pd.to_timedelta(rs.randint(0, 10 ** 9, n),
                                           unit='ns')).astype(
            'datetime64[ns]'),
        'x': rs.randn(n)})


def codec_edges():
    """{file name: (DataFrame, DataFrame.to_parquet's arguments)}."""
    base = kinds_frame(400)
    return {
        'kinds_zstd.parquet': (base, {'compression': 'zstd'}),
        'kinds_lz4_raw.parquet': (base, {'compression': 'lz4'}),
        'kinds_brotli.parquet': (base, {'compression': 'brotli',
                                        'compression_level': 11}),
        'kinds_delta.parquet': (base, {
            'use_dictionary': False, 'data_page_version': '2.0',
            'column_encoding': delta_encodings(base)}),
        'int96.parquet': (int96_frame(), {
            'use_deprecated_int96_timestamps': True,
            'row_group_size': 150}),
    }


def chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def criteo_frames():
    """The Criteo-layout shards: {name: DataFrame}."""
    import pandas as pd
    from deeptables_torch.data.datasets import load_criteo_synthetic
    cs = chip_smoke()
    n = len(CRITEO_SHARDS) * CRITEO_ROWS + CRITEO_VAL_ROWS
    cat, dense, y, _ = load_criteo_synthetic(n_rows=n, seed=CRITEO_SEED,
                                             return_arrays=True)
    rng = np.random.default_rng(CRITEO_SEED)
    dense = np.where(rng.random(dense.shape) < cs.STREAM_CSV_MISSING['dense'],
                     np.nan, dense).astype(np.float32)
    tokens = cs.criteo_tokens(cat).astype(object)
    tokens[rng.random(cat.shape) < cs.STREAM_CSV_MISSING['categorical']] = \
        None
    data = {'label': y.astype(np.int64)}
    data.update({f'I{j + 1}': dense[:, j] for j in range(dense.shape[1])})
    data.update({f'C{j + 1}': pd.array(tokens[:, j], dtype='str')
                 for j in range(cat.shape[1])})
    frame = pd.DataFrame(data)
    bounds = [(k * CRITEO_ROWS, (k + 1) * CRITEO_ROWS)
              for k in range(len(CRITEO_SHARDS))] + [(n - CRITEO_VAL_ROWS, n)]
    return {name: frame.iloc[lo:hi].reset_index(drop=True)
            for name, (lo, hi) in zip(CRITEO_SHARDS + (CRITEO_VAL,), bounds)}


def criteo_shards():
    """{file name: (DataFrame, DataFrame.to_parquet's arguments)}."""
    frames = criteo_frames()
    train_1 = frames[CRITEO_SHARDS[1]]
    encodings = {name: ('DELTA_BYTE_ARRAY' if name.startswith('C') else
                        'BYTE_STREAM_SPLIT' if name.startswith('I') else
                        'DELTA_BINARY_PACKED') for name in train_1.columns}
    return {
        CRITEO_SHARDS[0]: (frames[CRITEO_SHARDS[0]], {
            'compression': 'zstd', 'compression_level': 19}),
        CRITEO_SHARDS[1]: (train_1, {
            'compression': 'zstd', 'compression_level': 19,
            'use_dictionary': False, 'data_page_version': '2.0',
            'column_encoding': encodings}),
        CRITEO_VAL: (frames[CRITEO_VAL], {'compression': 'lz4',
                                          'compression_level': 12}),
    }


def as_lz4_hadoop(raw: bytes, n_chunks: int) -> bytes:
    """An LZ4_RAW file with its footer's codec fields rewritten to LZ4:
    each of the ``n_chunks`` column chunks' ``codec`` bytes, one byte
    each; the pages stay bare LZ4 blocks."""
    length = int.from_bytes(raw[-8:-4], 'little')
    start = len(raw) - 8 - length
    footer = raw[start:-8]
    if footer.count(CODEC_LZ4_RAW) != n_chunks:
        raise ValueError(f'found {footer.count(CODEC_LZ4_RAW)} codec fields '
                         f'for {n_chunks} column chunks')
    return raw[:start] + footer.replace(CODEC_LZ4_RAW, CODEC_LZ4) + raw[-8:]


def write_lz4_hadoop(out=DATA):
    """``kinds_lz4_hadoop.parquet`` from ``kinds_lz4_raw.parquet``; pyarrow
    must read both to the same table (it names codec 5 ``UNKNOWN``)."""
    import pandas as pd
    import pyarrow.parquet as pq
    source = out / 'kinds_lz4_raw.parquet'
    meta = pq.ParquetFile(source).metadata
    path = out / 'kinds_lz4_hadoop.parquet'
    path.write_bytes(as_lz4_hadoop(source.read_bytes(),
                                   meta.num_row_groups * meta.num_columns))
    codec = pq.ParquetFile(path).metadata.row_group(0).column(0).compression
    if codec == 'LZ4_RAW' or not pd.read_parquet(path).equals(
            pd.read_parquet(source)):
        raise ValueError('the rewritten file does not read as the source')


def bank_shards():
    """The bank table (``load_bank(20000)``) as two SNAPPY shards."""
    from deeptables_torch.data import datasets
    table = datasets.load_bank(BANK_ROWS)
    half = len(table) // 2
    return {BANK_SHARDS[0]: (table.iloc[:half].reset_index(drop=True), {}),
            BANK_SHARDS[1]: (table.iloc[half:].reset_index(drop=True), {})}


def write(out=DATA):
    out.mkdir(parents=True, exist_ok=True)
    for name, (frame, kwargs) in {**bank_shards(), **edge_cases(),
                                  **codec_edges(),
                                  **criteo_shards()}.items():
        frame.to_parquet(out / name, **kwargs)
    write_lz4_hadoop(out)


if __name__ == '__main__':
    write()
