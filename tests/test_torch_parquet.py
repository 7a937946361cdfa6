"""The port's Parquet reader (``deeptables_torch/data/parquet.py``) against
``pd.read_parquet`` (pandas 3, pyarrow) on the CPU.

``columns.read_parquet`` must give exactly what
``columns.as_columns(pd.read_parquet(path), rename=False)`` gives: the
same names in the same order, the same kinds, values and categories. It is
held so on the committed files of ``tests/torch_data/``
(``tests/torch_parquet_fixtures.py``) and on files written here with each
writer setting it reads (ZSTD, LZ4, BROTLI at every level, the DELTA
encodings, BYTE_STREAM_SPLIT and INT96 among them); codecs and schemas it
does not read raise by name. The native ZSTD decoder is held to
``zstandard`` and the LZ4 and BROTLI ones to pyarrow's codecs on a corpus
(BROTLI also on streams written here: every dictionary transform, the
window sizes, metadata and uncompressed meta-blocks, context maps), and
corrupt pages raise ``ValueError``; BROTLI's dictionary is RFC 7932's. The
fixtures' digests, which ``chip_smoke.py`` holds the reader to on the card,
are recomputed from pandas; the port's ``ChunkedSource`` gives the JAX
package's chunks, and streams Parquet in a subprocess with pandas, pyarrow
and the compression packages blocked.
"""

import decimal
import importlib.util
import os
import pickle
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import zstandard

from deeptables_torch.data import columns as cl
from deeptables_torch.data import parquet, streaming
from deeptables_torch.models import hyper_dt
from deeptables_torch.tools import parity_quality
from deeptables_tpu.data import streaming as jax_streaming

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
    'zstd': {'compression': 'zstd'},
    'zstd_page_v2_small': {'compression': 'zstd', 'data_page_version': '2.0',
                           'data_page_size': 300, 'row_group_size': 150},
    'lz4': {'compression': 'lz4'},
    'lz4_page_v2': {'compression': 'lz4', 'data_page_version': '2.0'},
    'int96': {'use_deprecated_int96_timestamps': True},
    'int96_no_dictionary_zstd': {'use_deprecated_int96_timestamps': True,
                                 'use_dictionary': False,
                                 'compression': 'zstd'},
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


@pytest.mark.parametrize('codec', ['brotli', 'lzo'])
def test_codecs_not_read_raise_by_name(tmp_path, codec):
    """LZO raises by name; BROTLI, once refused so, reads as pandas."""
    path = tmp_path / 'c.parquet'
    if codec == 'lzo':  # pyarrow writes no LZO: an LZ4_RAW file relabelled
        fixtures.kinds_frame(20).to_parquet(path, compression='lz4')
        raw = path.read_bytes()
        path.write_bytes(raw.replace(fixtures.CODEC_LZ4_RAW, b'\x15\x06'))
        with pytest.raises(ValueError, match=codec.upper()):
            cl.read_parquet(str(path))
        return
    fixtures.kinds_frame(20).to_parquet(path, compression=codec)
    _assert_reads_as_pandas(path)


# each value encoding on each physical type that takes it, pages v1 and v2
ENCODED = [('i64', 'DELTA_BINARY_PACKED'), ('i32', 'DELTA_BINARY_PACKED'),
           ('u64', 'DELTA_BINARY_PACKED'), ('Int64', 'DELTA_BINARY_PACKED'),
           ('f64', 'BYTE_STREAM_SPLIT'), ('f32', 'BYTE_STREAM_SPLIT'),
           ('i32', 'BYTE_STREAM_SPLIT'), ('i64', 'BYTE_STREAM_SPLIT'),
           ('s', 'DELTA_LENGTH_BYTE_ARRAY'), ('s_long', 'DELTA_BYTE_ARRAY'),
           ('s', 'DELTA_BYTE_ARRAY'), ('s_object', 'DELTA_BYTE_ARRAY')]


@pytest.mark.parametrize('page', ['1.0', '2.0'])
@pytest.mark.parametrize('column, encoding', ENCODED)
def test_encodings_read_as_pandas(tmp_path, column, encoding, page):
    path = tmp_path / 'e.parquet'
    frame = fixtures.kinds_frame(1100, seed=len(encoding))[[column]]
    pq.write_table(pa.Table.from_pandas(frame), path, use_dictionary=False,
                   column_encoding={column: encoding},
                   data_page_version=page, data_page_size=2000)
    encodings = {e for rg in range(pq.ParquetFile(path).num_row_groups)
                 for e in pq.ParquetFile(path).metadata.row_group(rg)
                 .column(0).encodings}
    assert encoding in encodings
    _assert_reads_as_pandas(path)


@pytest.mark.parametrize('dtype', [np.int32, np.int64])
def test_delta_binary_packed_wraps_and_takes_every_width(tmp_path, dtype):
    """Deltas of every bit width up to the type's, sums that wrap in the
    type's width, a run of equal values (width 0), as pyarrow writes
    them."""
    rs = np.random.RandomState(8)
    info = np.iinfo(dtype)
    values = np.concatenate([
        [info.min, info.max, info.min, 0, info.max, -1],
        rs.randint(info.min, info.max, 700, dtype=dtype),
        np.cumsum(rs.randint(0, 3, 400)), np.full(300, 5),
        (1 << rs.randint(0, 31, 500)) * rs.choice([-1, 1], 500)]).astype(dtype)
    path = tmp_path / 'dbp.parquet'
    pq.write_table(pa.table({'v': values}), path, use_dictionary=False,
                   column_encoding={'v': 'DELTA_BINARY_PACKED'},
                   compression=None)
    got = cl.read_parquet(str(path))['v']
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, values)


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
    listed; the first files stay under 2 MiB, those written since the
    codecs and encodings of ``csrc/parquet_codecs.cpp`` are read under 4 MB
    together."""
    cs = _chip_smoke()
    assert sorted(cs.PARQUET_DIGESTS) == FILES
    assert tuple(cs.PARQUET_BANK) == fixtures.BANK_SHARDS
    for name in FILES:
        table = cl.as_columns(pd.read_parquet(fixtures.DATA / name),
                              rename=False)
        assert cs.columns_digest(parity_quality, table) == \
            cs.PARQUET_DIGESTS[name], name
    first = [n for n in FILES if n not in fixtures.NEW_FILES]
    assert sum((fixtures.DATA / n).stat().st_size for n in first) < 2 << 20
    assert set(fixtures.NEW_FILES) <= set(FILES)
    assert sum((fixtures.DATA / n).stat().st_size
               for n in fixtures.NEW_FILES) < 4_000_000
    assert tuple(cs.PARQUET_CRITEO) == fixtures.CRITEO_SHARDS
    assert cs.PARQUET_CRITEO_VAL == fixtures.CRITEO_VAL


def _corpus(name):
    rs = np.random.RandomState(2)
    return {
        'empty': b'',
        'one_byte_repeated': b'q' * 300_000,
        'incompressible': rs.bytes(200_000),
        'text': ' '.join(f'word{v}' for v in rs.randint(0, 5000, 90_000))
        .encode(),
        'columns': np.concatenate([
            rs.randint(0, 40, 60_000).astype('<i4').view(np.uint8),
            np.cumsum(rs.randint(0, 9, 30_000)).astype('<i8').view(np.uint8),
            rs.randn(20_000).astype('<f4').view(np.uint8)]).tobytes(),
        'mixed': (b'abc' * 3000 + rs.bytes(2000)) * 30,
    }[name]


CORPUS = ['empty', 'one_byte_repeated', 'incompressible', 'text', 'columns',
          'mixed']


@pytest.mark.parametrize('level', [-5, 1, 3, 19, 22])
@pytest.mark.parametrize('data', CORPUS)
def test_zstd_decoder_equals_zstandard(data, level):
    """Every level, with and without the content size and the checksum;
    at 19 and 22 also a long window with long-distance matching, and a
    stream of several blocks without a content size."""
    raw = _corpus(data)
    packed = [zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=size).compress(raw)
        for checksum in (False, True) for size in (False, True)]
    if level >= 19:
        params = zstandard.ZstdCompressionParameters.from_level(
            level, window_log=27, enable_ldm=True)
        packed.append(zstandard.ZstdCompressor(
            compression_params=params).compress(raw))
        chunks = zstandard.ZstdCompressor(level=level).compressobj()
        packed.append(b''.join(chunks.compress(raw[i:i + 50_000])
                               for i in range(0, len(raw), 50_000))
                      + chunks.flush())
    for page in packed:
        assert parquet.native_decompress(6, page, len(raw)) == raw


def test_zstd_decoder_reads_frames_in_a_row_and_skippable_frames():
    parts = [_corpus('text')[:70_000], b'', _corpus('incompressible')[:9000],
             b'end']
    skippable = struct.pack('<II', 0x184D2A57, 5) + b'12345'
    page = skippable + b''.join(
        zstandard.ZstdCompressor(level=3, write_checksum=True).compress(p)
        for p in parts) + skippable
    assert parquet.native_decompress(6, page, sum(map(len, parts))) == \
        b''.join(parts)
    assert parquet.native_decompress(6, b'', 0) == b''


@pytest.mark.parametrize('data', CORPUS)
def test_lz4_decoders_equal_pyarrow(data):
    """LZ4_RAW (codec 7) against pyarrow's ``lz4_raw``; LZ4 (codec 5) in
    Hadoop's framing (big-endian lengths before each block), and as one
    bare block, Arrow's fall-back."""
    raw = _corpus(data)
    block = pa.compress(raw, codec='lz4_raw', asbytes=True)
    assert parquet.native_decompress(7, block, len(raw)) == raw
    assert parquet.native_decompress(5, block, len(raw)) == raw
    framed = b''
    for i in range(0, max(len(raw), 1), 64_000):
        part = raw[i:i + 64_000]
        packed = pa.compress(part, codec='lz4_raw', asbytes=True)
        framed += struct.pack('>II', len(part), len(packed)) + packed
    assert parquet.native_decompress(5, framed, len(raw)) == raw


def _corruptions(page, rs, n=40):
    """Truncations, and pages with a few bytes overwritten."""
    for k in range(n):
        if k % 2 == 0:
            yield page[:rs.randint(0, len(page))]
        else:
            bad = bytearray(page)
            for _ in range(rs.randint(1, 4)):
                bad[rs.randint(0, len(bad))] ^= rs.randint(1, 256)
            yield bytes(bad)


@pytest.mark.parametrize('codec', ['ZSTD', 'LZ4_RAW', 'LZ4', 'SNAPPY',
                                   'GZIP', 'BROTLI'])
def test_corrupt_pages_raise_value_error(codec):
    """A corrupt page raises ValueError, never reads past its buffer and
    never gives a page of the wrong size. ZSTD frames carry their checksum,
    so a changed byte is caught; LZ4, SNAPPY and GZIP are cut short."""
    rs = np.random.RandomState(4)
    raw = _corpus('columns')
    ids = {name: key for key, name in parquet.CODECS.items()}
    if codec == 'ZSTD':
        page = zstandard.ZstdCompressor(level=3,
                                        write_checksum=True).compress(raw)
        pages = list(_corruptions(page, rs))
    else:
        arrow_codec = {'LZ4_RAW': 'lz4_raw', 'LZ4': 'lz4_raw',
                       'SNAPPY': 'snappy', 'GZIP': 'gzip',
                       'BROTLI': 'brotli'}[codec]
        page = pa.compress(raw, codec=arrow_codec, asbytes=True)
        pages = [page[:rs.randint(1, len(page) - 1)] for _ in range(40)]
    for bad in pages:
        with pytest.raises(ValueError):
            parquet._decompress(ids[codec], bad, len(raw))


# -- BROTLI (csrc/parquet_codecs.cpp, RFC 7932) ------------------------------

def _dictionary_words(rs, n):
    """``n`` words (bytes) of RFC 7932's dictionary, some capitalised or
    upper case: text whose BROTLI streams refer into the dictionary through
    its transforms."""
    words = parquet.brotli_dictionary()
    out = []
    for _ in range(n):
        length = int(rs.randint(4, 13))
        bits = {4: 10, 5: 10, 6: 11, 7: 11, 8: 10, 9: 10, 10: 10, 11: 10,
                12: 10}[length]
        offset = sum(k << {4: 10, 5: 10, 6: 11, 7: 11, 8: 10, 9: 10, 10: 10,
                           11: 10}[k] for k in range(4, length))
        index = int(rs.randint(0, 1 << bits))
        word = words[offset + index * length:offset + (index + 1) * length]
        style = rs.randint(0, 6)
        out.append(word.capitalize() if style == 0 else
                   word.upper() if style == 1 else word)
    return out


def _text_frame(n, seed):
    """The kinds frame beside sentences of dictionary words."""
    rs = np.random.RandomState(seed)
    words = [w.decode('latin-1') for w in _dictionary_words(rs, 4 * n)]
    glue = [' ', ' the ', ', ', ' of ', '. ', ' and ', '="', "'"]
    text = [''.join(words[4 * i + k] + glue[rs.randint(0, len(glue))]
                    for k in range(4)) for i in range(n)]
    frame = fixtures.kinds_frame(n, seed=seed)
    frame['text'] = text
    frame['noise'] = [rs.bytes(24).hex() for _ in range(n)]
    return frame


@pytest.mark.parametrize('page', ['1.0', '2.0'])
@pytest.mark.parametrize('level', range(12))
def test_brotli_levels_read_as_pandas(tmp_path, level, page):
    """Every compression level, pages v1 and v2, text that brings
    dictionary references and transforms, incompressible hex."""
    path = tmp_path / 'b.parquet'
    _text_frame(300, seed=level).to_parquet(
        path, compression='brotli', compression_level=level,
        data_page_version=page, use_dictionary=level % 2 == 0)
    _assert_reads_as_pandas(path)


@pytest.mark.parametrize('level', [0, 1, 5, 9, 11])
@pytest.mark.parametrize('data', CORPUS + ['words'])
def test_brotli_decoder_equals_pyarrow(data, level):
    raw = (b' '.join(_dictionary_words(np.random.RandomState(3), 20_000))
           if data == 'words' else _corpus(data))
    if level >= 9:  # the slow encoder's levels on a part of each
        raw = raw[:60_000]
    page = pa.Codec('brotli', compression_level=level).compress(
        raw, asbytes=True)
    assert parquet.native_decompress(4, page, len(raw)) == raw


class _Bits:
    """Bits written least significant first, as BROTLI reads them."""

    def __init__(self):
        self.value, self.n = 0, 0

    def put(self, value, n):
        self.value |= (value & ((1 << n) - 1)) << self.n
        self.n += n

    def align(self):
        self.n = -(-self.n // 8) * 8

    def bytes(self):
        return self.value.to_bytes(-(-self.n // 8), 'little')


def _wbits(bits, wbits):
    if wbits == 16:
        bits.put(0, 1)
    elif wbits >= 18:
        bits.put(1, 1)
        bits.put(wbits - 17, 3)
    else:
        bits.put(1, 1)
        bits.put(0, 3)
        bits.put(0 if wbits == 17 else wbits - 8, 3)


def _simple_code(bits, alphabet, symbols):
    bits.put(1, 2)  # HSKIP 1: a simple prefix code
    bits.put(len(symbols) - 1, 2)
    for symbol in symbols:
        bits.put(symbol, (alphabet - 1).bit_length())


def _meta_header(bits, mlen, last=True):
    bits.put(int(last), 1)
    if last:
        bits.put(0, 1)
    bits.put(0, 2)  # four nibbles
    bits.put(mlen - 1, 16)
    if not last:
        bits.put(0, 1)  # compressed


def _word_stream(length, word_id, mlen, wbits=22, metadata=b''):
    """One meta-block whose one command copies a static dictionary word
    (``length`` bytes, ``word_id``: transform and index), every prefix code
    a single symbol; a metadata meta-block first if ``metadata``."""
    bits = _Bits()
    _wbits(bits, wbits)
    if metadata:
        bits.put(0, 1)
        bits.put(3, 2)  # MNIBBLES 0: metadata
        bits.put(0, 1)
        bits.put(1, 2)  # MSKIPBYTES
        bits.put(len(metadata) - 1, 8)
        bits.align()
        bits.put(int.from_bytes(metadata, 'little'), 8 * len(metadata))
    _meta_header(bits, mlen)
    bits.put(0, 3)  # one block type each
    bits.put(0, 6)  # NPOSTFIX, NDIRECT
    bits.put(0, 2)  # the literal context mode
    bits.put(0, 2)  # one literal tree, one distance tree
    _simple_code(bits, 256, [ord('x')])
    copy_base = [2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18, 22, 30]
    copy_extra = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3]
    code = max(c for c in range(len(copy_base)) if copy_base[c] <= length)
    cell = {0: 2, 1: 3}[code // 8]
    _simple_code(bits, 704, [cell * 64 + (code & 7)])
    distance = word_id  # distance - 1: nothing written before it
    for x in range(48):
        ndistbits = 1 + (x >> 1)
        offset = ((2 + (x & 1)) << ndistbits) - 4
        if offset <= distance < offset + (1 << ndistbits):
            break
    _simple_code(bits, 64, [16 + x])
    bits.put(length - copy_base[code], copy_extra[code])
    bits.put(distance - offset, ndistbits)
    return bits.bytes()


def _arrow_brotli(stream, size):
    return pa.decompress(stream, decompressed_size=size, codec='brotli',
                         asbytes=True)


def _word_case(length, word_id, **kwargs):
    """The stream and pyarrow's output: its meta-block length is the one
    length pyarrow's decoder takes; None where the transformed word is
    empty (a meta-block holds at least a byte)."""
    for mlen in range(1, length + 16):
        stream = _word_stream(length, word_id, mlen, **kwargs)
        try:
            return stream, _arrow_brotli(stream, mlen)
        except (OSError, pa.ArrowException):
            continue
    return None, None


def test_brotli_every_dictionary_transform_equals_pyarrow():
    """Each of Appendix B's 121 transforms on words of several lengths
    (omitting more than a word holds, uppercasing UTF-8 lead bytes), the
    window sizes, a metadata meta-block first."""
    rs = np.random.RandomState(7)
    bits_by_length = {4: 10, 9: 10, 13: 9, 21: 6}
    cases = 0
    for transform in range(121):
        lengths = 0
        for length, nbits in bits_by_length.items():
            word_id = (transform << nbits) | int(rs.randint(0, 1 << nbits))
            wbits = [10, 15, 16, 17, 18, 24][cases % 6]
            stream, expected = _word_case(
                length, word_id, wbits=wbits,
                metadata=b'meta' if cases % 5 == 0 else b'')
            if stream is None:
                continue
            assert parquet.native_decompress(4, stream, len(expected)) == \
                expected
            cases += 1
            lengths += 1
        # omitting up to nine bytes may leave a short word empty
        assert lengths >= 2, transform
    assert cases > 440
    bad = _word_stream(4, 121 << 10, 4)
    with pytest.raises(ValueError, match='BROTLI.*transform'):
        parquet.native_decompress(4, bad, 4)


def test_brotli_context_map_and_uncompressed_blocks_equal_pyarrow():
    """A literal context map (runs of zeros, inverse move-to-front) read
    in each context mode, and an uncompressed meta-block before it."""
    rs = np.random.RandomState(9)
    for mode in range(4):
        for rlemax in (0, 2):
            bits = _Bits()
            _wbits(bits, 16)
            raw = bytes(rs.randint(0, 256, 37).astype(np.uint8))
            bits.put(0, 1)
            bits.put(0, 2)
            bits.put(len(raw) - 1, 16)
            bits.put(1, 1)  # uncompressed
            bits.align()
            bits.put(int.from_bytes(raw, 'little'), 8 * len(raw))
            n = 40
            _meta_header(bits, n)
            bits.put(0, 3)
            bits.put(0, 6)
            bits.put(mode, 2)
            bits.put(1, 1)  # NTREESL - 1 = 1
            bits.put(0, 3)
            bits.put(int(rlemax > 0), 1)
            if rlemax:
                bits.put(rlemax - 1, 4)
                _simple_code(bits, 2 + rlemax, [0, 2, 3])
                # codes by (length, symbol): 0 -> '0', 2 -> '01', 3 -> '11'
                for k in range(16):
                    if k % 3 == 0:
                        bits.put(1, 1)
                        bits.put(1, 1)  # symbol 3: tree 1
                    else:
                        bits.put(0, 1)
                        bits.put(1, 1)  # symbol 2: a run of 2**2 + extra
                        bits.put(k % 4 == 1, 2)
            else:
                _simple_code(bits, 2, [0, 1])
                for k in range(64):
                    bits.put(int(rs.rand() < 0.5), 1)
            bits.put(1, 1)  # inverse move-to-front
            bits.put(0, 1)  # one distance tree
            _simple_code(bits, 256, [ord('a')])
            _simple_code(bits, 256, [ord('b')])
            _simple_code(bits, 704, [4 * 64 + (12 - 8) * 8])  # insert 34+
            _simple_code(bits, 64, [0])
            bits.put(n - 34, 4)
            stream = bits.bytes()
            try:
                expected = raw + _arrow_brotli(stream, len(raw) + n)[len(raw):]
            except (OSError, pa.ArrowException):
                # a written map longer than 64 entries: refused alike
                with pytest.raises(ValueError, match='BROTLI'):
                    parquet.native_decompress(4, stream, len(raw) + n)
                continue
            assert parquet.native_decompress(4, stream, len(expected)) == \
                expected


def test_brotli_corrupt_streams_raise_by_name():
    """Cut streams raise ValueError naming BROTLI; changed bytes raise so or
    decode to some page of the right size (BROTLI has no checksum); a
    large-window stream raises by name."""
    rs = np.random.RandomState(5)
    raw = _corpus('columns')
    page = pa.Codec('brotli', compression_level=9).compress(raw, asbytes=True)
    for cut in rs.randint(0, len(page) - 1, 40):
        with pytest.raises(ValueError, match='BROTLI'):
            parquet.native_decompress(4, page[:cut], len(raw))
    for bad in _corruptions(page, rs, 60):
        try:
            out = parquet.native_decompress(4, bad, len(raw))
        except ValueError as e:
            assert 'BROTLI' in str(e)
        else:
            assert len(out) == len(raw)
    bits = _Bits()
    bits.put(0b0010001, 7)  # the large-window marker
    with pytest.raises(ValueError, match='BROTLI.*large-window'):
        parquet.native_decompress(4, bits.bytes() + bytes(8), 10)


def test_brotli_dictionary_is_rfc_7932s(monkeypatch, tmp_path):
    import hashlib
    words = parquet.brotli_dictionary()
    assert len(words) == 122_784
    assert hashlib.sha256(words).hexdigest() == \
        parquet.BROTLI_DICTIONARY_SHA256
    assert words.startswith(b'timedownlifeleftback')
    bad = tmp_path / 'dictionary.zlib'
    bad.write_bytes(zlib.compress(words[:-1] + b'?'))
    monkeypatch.setattr(parquet, 'BROTLI_DICTIONARY', bad)
    monkeypatch.setattr(parquet, '_codecs', None)
    with pytest.raises(ValueError, match='SHA-256'):
        parquet.codec_library()


@pytest.mark.parametrize('name', ['kinds_page_v2.parquet',
                                  fixtures.CRITEO_SHARDS[1],
                                  fixtures.CRITEO_VAL])
def test_compressed_pages_decompress_to_their_sizes(name):
    """``compressed_pages`` (which chip_smoke.py times the ZSTD decoder on)
    gives every page of the file, each decompressing to its size."""
    path = fixtures.DATA / name
    pages = list(parquet.compressed_pages(str(path)))
    meta = pq.ParquetFile(path).metadata
    assert len(pages) >= meta.num_row_groups * meta.num_columns
    for codec, body, size in pages:
        assert len(parquet._decompress(codec, body, size)) == size


def test_corrupt_zstd_file_raises(tmp_path):
    raw = (fixtures.DATA / 'kinds_zstd.parquet').read_bytes()
    path = tmp_path / 'bad.parquet'
    meta = parquet._Thrift(raw[-8 - int.from_bytes(raw[-8:-4], 'little'):
                               -8]).struct()
    chunk = meta[4][0][1][0][3]
    start = chunk.get(11) or chunk[9]
    path.write_bytes(raw[:start + 40] + bytes(60) + raw[start + 100:])
    with pytest.raises(ValueError, match='ZSTD'):
        cl.read_parquet(str(path))


def test_codec_library_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises with the compiler's message; nothing falls
    back to a decoder in Python."""
    source = tmp_path / 'parquet_codecs.cpp'
    source.write_text('this is not C++\n')
    monkeypatch.setattr(parquet, 'CODEC_SOURCE', source)
    monkeypatch.setattr(parquet, '_codecs', None)
    monkeypatch.setattr(parquet._build, 'BUILD_ROOT', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='parquet_codecs.cpp failed'):
        parquet.codec_library()


@pytest.mark.parametrize('name', fixtures.NEW_FILES)
def test_chunked_source_equals_the_jax_packages(name):
    """The port's ``ChunkedSource`` over a new fixture gives the JAX
    package's chunks (``pd.read_parquet``) as ``Columns``."""
    path = str(fixtures.DATA / name)
    port = list(streaming.ChunkedSource([path], chunk_size=3000)
                .iter_chunks())
    jax = list(jax_streaming.ChunkedSource([path], chunk_size=3000)
               .iter_chunks())
    assert len(port) == len(jax) > 0
    for got, frame in zip(port, jax):
        expected = cl.as_columns(frame, rename=False)
        assert got.columns == expected.columns
        for column in expected.columns:
            assert got.kinds[column] == expected.kinds[column], column
            assert _same_values(got[column], expected[column]), column


def test_read_table_reads_a_parquet_path():
    path = str(fixtures.DATA / fixtures.BANK_SHARDS[0])
    got = hyper_dt._read_table(path)
    expected = cl.as_columns(pd.read_parquet(path), rename=False)
    assert got.columns == expected.columns
    for name in expected.columns:
        assert _same_values(got[name], expected[name]), name


STREAM = r'''
import pickle, sys
for name in BLOCKED:
    sys.modules[name] = None
from deeptables_torch.data import streaming
paths, out = sys.argv[1:-1], sys.argv[-1]
source = streaming.ChunkedSource(paths, chunk_size=3000)
chunks = [{n: (c.kinds[n], c[n]) for n in c.columns}
          for c in source.iter_chunks()]
with open(out, 'wb') as f:
    pickle.dump({'n_rows': source.n_rows(), 'chunks': chunks,
                 'modules': [m for m in BLOCKED
                             if sys.modules.get(m) is not None],
                 'brotli_maps': [line for line in open('/proc/self/maps')
                                 if 'brotli' in line.lower()]}, f)
print('ok')
'''
BLOCKED = ('pandas', 'pyarrow', 'sklearn', 'zstandard', 'lz4', 'brotli')


def _stream_without_pandas(tmp_path, paths):
    """The chunks ``ChunkedSource`` streams from ``paths`` in a subprocess
    with BLOCKED blocked, against those of the DataFrames pandas reads."""
    out = tmp_path / 'chunks.pkl'
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1',
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c',
                           f'BLOCKED = {BLOCKED!r}\n' + STREAM, *paths,
                           str(out)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, 'rb') as f:
        result = pickle.load(f)
    assert result['modules'] == []
    expected = [c for c in streaming.ChunkedSource(
        [pd.read_parquet(p) for p in paths], chunk_size=3000).iter_chunks()]
    assert result['n_rows'] == sum(len(c) for c in expected)
    assert len(result['chunks']) == len(expected)
    for got, chunk in zip(result['chunks'], expected):
        assert list(got) == chunk.columns
        for name in chunk.columns:
            kind, values = got[name]
            assert kind == chunk.kinds[name], name
            assert _same_values(values, chunk[name]), name
    return result


def test_chunked_source_streams_parquet_without_pandas(tmp_path):
    paths = [str(fixtures.DATA / n) for n in fixtures.BANK_SHARDS]
    result = _stream_without_pandas(tmp_path, paths)
    assert result['n_rows'] == fixtures.BANK_ROWS


def test_chunked_source_streams_brotli_without_pandas(tmp_path):
    """The BROTLI kinds file with pandas, pyarrow and the compression
    packages blocked; no brotli library is mapped into the process."""
    result = _stream_without_pandas(
        tmp_path, [str(fixtures.DATA / 'kinds_brotli.parquet')])
    assert result['n_rows'] == 400
    assert result['brotli_maps'] == []


def test_chunked_source_streams_zstd_and_lz4_without_pandas(tmp_path):
    """The Criteo-layout shards (ZSTD with and without dictionary, LZ4_RAW)
    with pandas, pyarrow and the compression packages blocked."""
    paths = [str(fixtures.DATA / n)
             for n in fixtures.CRITEO_SHARDS + (fixtures.CRITEO_VAL,)]
    result = _stream_without_pandas(tmp_path, paths)
    assert result['n_rows'] == len(fixtures.CRITEO_SHARDS) * \
        fixtures.CRITEO_ROWS + fixtures.CRITEO_VAL_ROWS
