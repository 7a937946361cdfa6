# -*- coding:utf-8 -*-
"""A Parquet reader on numpy and the standard library: what
``DataFrame.to_parquet`` (pyarrow) writes, read as ``Columns`` equal to
``columns.as_columns(pd.read_parquet(path), rename=False)``, without pandas
or pyarrow.

It reads flat schemas of the Parquet format up to 2.6:

- the footer's Thrift compact protocol (decoded in Python);
- data pages v1 and v2, any number of row groups;
- pages uncompressed, SNAPPY (decompressed here), GZIP (``zlib``), ZSTD,
  LZ4_RAW, LZ4 (Hadoop's framing, else one bare block, as Arrow reads it)
  and BROTLI; ZSTD, LZ4 and BROTLI by ``csrc/parquet_codecs.cpp``, host
  C++ built with the host compiler at first use (a failed build raises
  with the compiler's message), BROTLI with RFC 7932's static dictionary
  from ``csrc/brotli_dictionary.zlib`` (zlib-compressed), whose SHA-256 is
  checked when it is loaded;
- PLAIN and RLE_DICTIONARY / PLAIN_DICTIONARY values, also a column chunk
  that falls back from its dictionary to PLAIN part way through;
  DELTA_BINARY_PACKED (INT32, INT64), DELTA_LENGTH_BYTE_ARRAY and
  DELTA_BYTE_ARRAY (BYTE_ARRAY), BYTE_STREAM_SPLIT (FLOAT, DOUBLE, INT32,
  INT64), in numpy;
- the RLE / bit-packed hybrid of definition levels and dictionary indices;
- BOOLEAN, INT32, INT64, INT96 (Impala's timestamps: ``datetime64[ns]``, as
  ``pd.read_parquet`` gives them), FLOAT, DOUBLE and BYTE_ARRAY with the
  String logical type (and INT32 with the Null type, pyarrow's all-null
  column).

The ``pandas`` key-value metadata, where the file has it, names the index
columns, which are dropped (a stored index, or a range other than
``0..n``, becomes ``Columns.index`` as a numpy array), and
each column's pandas dtype, from which the column's kind follows as
``as_columns`` gives it for what ``pd.read_parquet`` returns: a
categorical of strings is ``category[str]`` with the file's categories;
nullable integers and floats, and integers with nulls, are ``float64``
with NaN; a boolean column with nulls is ``object`` (``None``, or NaN for
pandas' nullable ``boolean``); timestamps are ``datetime64[<unit>]`` with
NaT; an all-null column is ``object`` of ``None``. The LZO codec,
FIXED_LEN_BYTE_ARRAY and nested schemas raise ``ValueError`` naming
them.
"""

import ctypes
import hashlib
import json
import struct
import subprocess
import threading
import zlib

import numpy as np

from . import columns as cl
from ..ops.kernels import _build

MAGIC = b'PAR1'
CODECS = {0: 'UNCOMPRESSED', 1: 'SNAPPY', 2: 'GZIP', 3: 'LZO', 4: 'BROTLI',
          5: 'LZ4', 6: 'ZSTD', 7: 'LZ4_RAW'}
ENCODINGS = {0: 'PLAIN', 2: 'PLAIN_DICTIONARY', 3: 'RLE', 4: 'BIT_PACKED',
             5: 'DELTA_BINARY_PACKED', 6: 'DELTA_LENGTH_BYTE_ARRAY',
             7: 'DELTA_BYTE_ARRAY', 8: 'RLE_DICTIONARY',
             9: 'BYTE_STREAM_SPLIT'}
TYPES = {0: 'BOOLEAN', 1: 'INT32', 2: 'INT64', 3: 'INT96', 4: 'FLOAT',
         5: 'DOUBLE', 6: 'BYTE_ARRAY', 7: 'FIXED_LEN_BYTE_ARRAY'}
PLAIN_DTYPES = {'INT32': '<i4', 'INT64': '<i8', 'FLOAT': '<f4',
                'DOUBLE': '<f8'}
PAGE_DATA, PAGE_INDEX, PAGE_DICTIONARY, PAGE_DATA_V2 = 0, 1, 2, 3
REQUIRED, OPTIONAL, REPEATED = 0, 1, 2
TIME_UNITS = {1: 'ms', 2: 'us', 3: 'ns'}  # LogicalType TimeUnit's fields
JULIAN_UNIX_EPOCH = 2440588  # the Julian day of 1970-01-01
NS_PER_DAY = 86400 * 10 ** 9
CODEC_SOURCE = _build.CSRC_DIR / 'parquet_codecs.cpp'
NATIVE_CODECS = {4: 'pq_brotli_decompress', 5: 'pq_lz4_hadoop_decompress',
                 6: 'pq_zstd_decompress', 7: 'pq_lz4_raw_decompress'}
# RFC 7932 Appendix A, the dictionary BROTLI streams refer into
BROTLI_DICTIONARY = _build.CSRC_DIR / 'brotli_dictionary.zlib'
BROTLI_DICTIONARY_SHA256 = ('20e42eb1b511c21806d4d227d07e5dd0'
                            '6877d8ce7b3a817f378f313653f35c70')
NULLABLE_INTS = ('Int8', 'Int16', 'Int32', 'Int64', 'UInt8', 'UInt16',
                 'UInt32', 'UInt64')


# -- Thrift compact protocol ------------------------------------------------

class _Thrift:
    """A reader of Thrift's compact protocol: a struct becomes a dict from
    field id to value (lists as lists, binary as bytes)."""

    def __init__(self, buf, pos=0):
        self.buf = buf
        self.pos = pos

    def byte(self):
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self):
        shift = result = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def zigzag(self):
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, kind):
        if kind in (1, 2):  # a bool element of a list or map: one byte
            return self.byte() == 1
        if kind == 3:
            return struct.unpack('<b', bytes([self.byte()]))[0]
        if kind in (4, 5, 6):
            return self.zigzag()
        if kind == 7:
            v = struct.unpack_from('<d', self.buf, self.pos)[0]
            self.pos += 8
            return v
        if kind == 8:
            n = self.varint()
            v = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return v
        if kind in (9, 10):
            head = self.byte()
            size, elem = head >> 4, head & 0x0F
            if size == 15:
                size = self.varint()
            return [self.value(elem) for _ in range(size)]
        if kind == 11:
            size = self.varint()
            if size == 0:
                return {}
            types = self.byte()
            return {self.value(types >> 4): self.value(types & 0x0F)
                    for _ in range(size)}
        if kind == 12:
            return self.struct()
        raise ValueError(f'Parquet: unknown Thrift type {kind}')

    def struct(self):
        out = {}
        fid = 0
        while True:
            head = self.byte()
            if head == 0:
                return out
            kind = head & 0x0F
            delta = head >> 4
            fid = fid + delta if delta else self.zigzag()
            out[fid] = (kind == 1) if kind in (1, 2) else self.value(kind)


# -- codecs -----------------------------------------------------------------

def snappy_decompress(data) -> bytes:
    """Snappy's raw block format (what Parquet pages hold)."""
    data = memoryview(data)
    t = _Thrift(data)
    n = t.varint()
    pos = t.pos
    out = bytearray(n)
    o = 0
    end = len(data)
    while pos < end:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                length = int.from_bytes(data[pos:pos + extra], 'little')
                pos += extra
            length += 1
            out[o:o + length] = data[pos:pos + length]
            pos += length
            o += length
            continue
        if kind == 1:
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            length = (tag >> 2) + 1
            offset = data[pos] | (data[pos + 1] << 8)
            pos += 2
        else:
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], 'little')
            pos += 4
        if offset == 0 or offset > o:
            raise ValueError('Parquet: corrupt SNAPPY page')
        start = o - offset
        if offset >= length:
            out[o:o + length] = out[start:start + length]
        else:  # the copy overlaps what it writes: a repeating pattern
            pattern = bytes(out[start:o])
            reps = -(-length // offset)
            out[o:o + length] = (pattern * reps)[:length]
        o += length
    if o != n:
        raise ValueError('Parquet: corrupt SNAPPY page')
    return bytes(out)


_codecs = None
_codecs_lock = threading.Lock()


def codec_library():
    """The native ZSTD, LZ4 and BROTLI decoders
    (``csrc/parquet_codecs.cpp``), built at first use; BROTLI's dictionary
    is handed over once its digest is checked."""
    global _codecs
    with _codecs_lock:
        if _codecs is not None:
            return _codecs
        try:
            path = _build.build_host_library(CODEC_SOURCE)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f'building {CODEC_SOURCE.name} failed:\n'
                               f'{e.stderr}') from e
        lib = ctypes.CDLL(str(path))
        for name in NATIVE_CODECS.values():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        words = brotli_dictionary()
        lib.pq_brotli_set_dictionary.restype = ctypes.c_int64
        lib.pq_brotli_set_dictionary.argtypes = [ctypes.c_char_p,
                                                 ctypes.c_int64]
        if lib.pq_brotli_set_dictionary(words, len(words)) != 0:
            raise ValueError('BROTLI: the decoder refused its dictionary')
        _codecs = lib
        return _codecs


def brotli_dictionary() -> bytes:
    """RFC 7932's static dictionary (122,784 bytes), its SHA-256 checked."""
    words = zlib.decompress(BROTLI_DICTIONARY.read_bytes())
    if hashlib.sha256(words).hexdigest() != BROTLI_DICTIONARY_SHA256:
        raise ValueError(f'{BROTLI_DICTIONARY.name}: not RFC 7932\'s BROTLI '
                         f'dictionary (SHA-256 differs)')
    return words


def native_decompress(codec, data, size) -> bytes:
    """``data`` decompressed by the native decoder of ``codec`` (4, 5, 6
    or 7) into exactly ``size`` bytes; a corrupt page raises
    ``ValueError``."""
    data = bytes(data)
    out = bytearray(size)
    dst = (ctypes.c_char * size).from_buffer(out) if size else None
    err = ctypes.create_string_buffer(256)
    got = getattr(codec_library(), NATIVE_CODECS[codec])(
        data, len(data), dst, size, err, len(err))
    name = CODECS[codec]
    if got < 0:
        raise ValueError(f'Parquet: corrupt {name} page: '
                         f'{err.value.decode()}')
    if got != size:
        raise ValueError(f'Parquet: corrupt {name} page: {got} bytes for '
                         f'its {size}')
    return bytes(out)


def _decompress(codec, data, size):
    if codec == 0:
        return bytes(data)
    if codec == 1:
        try:
            out = snappy_decompress(data)
        except IndexError as e:  # a page cut short
            raise ValueError('Parquet: corrupt SNAPPY page') from e
        if len(out) != size:
            raise ValueError('Parquet: corrupt SNAPPY page')
        return out
    if codec == 2:
        try:
            out = zlib.decompress(bytes(data), 47)  # gzip or zlib header
        except zlib.error as e:
            raise ValueError(f'Parquet: corrupt GZIP page: {e}') from e
        if len(out) != size:
            raise ValueError('Parquet: corrupt GZIP page')
        return out
    if codec in NATIVE_CODECS:
        return native_decompress(codec, data, size)
    raise ValueError(f'Parquet: the {CODECS.get(codec, codec)} codec is not '
                     f'read (only UNCOMPRESSED, SNAPPY, GZIP, BROTLI, LZ4, '
                     f'ZSTD and LZ4_RAW)')


# -- encodings --------------------------------------------------------------

def _unpack_bits(buf, bit_width, count):
    """``count`` little-endian bit-packed values of ``bit_width`` bits (up
    to 64), as uint64."""
    if bit_width == 0:
        return np.zeros(count, np.uint64)
    nbytes = (count * bit_width + 7) // 8
    raw = np.frombuffer(buf, np.uint8, min(nbytes, len(buf)))
    if len(raw) < nbytes:  # a last run cut short of its padding
        raw = np.concatenate([raw, np.zeros(nbytes - len(raw), np.uint8)])
    bits = np.unpackbits(raw, bitorder='little')[:count * bit_width]
    weights = np.left_shift(np.uint64(1), np.arange(bit_width,
                                                    dtype=np.uint64))
    return bits.reshape(count, bit_width).astype(np.uint64) @ weights


def rle_hybrid(buf, bit_width, count):
    """The RLE / bit-packed hybrid: ``count`` values from ``buf``."""
    t = _Thrift(buf)
    width = (bit_width + 7) // 8
    parts = []
    got = 0
    while got < count:
        if t.pos >= len(buf):
            raise ValueError('Parquet: an RLE run ends early')
        header = t.varint()
        if header & 1:
            groups = header >> 1
            n = groups * 8
            values = _unpack_bits(buf[t.pos:], bit_width, n).astype(np.int64)
            t.pos += groups * bit_width
        else:
            n = header >> 1
            value = int.from_bytes(buf[t.pos:t.pos + width], 'little')
            t.pos += width
            values = np.full(n, value, np.int64)
        parts.append(values)
        got += n
    out = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return out[:count]


def _plain(buf, ptype, count):
    """``count`` PLAIN values of physical type ``ptype`` (INT96 as int64
    nanoseconds since the Unix epoch)."""
    if ptype in PLAIN_DTYPES:
        dtype = np.dtype(PLAIN_DTYPES[ptype])
        return np.frombuffer(buf, dtype, count).astype(
            dtype.newbyteorder('='))
    if ptype == 'INT96':
        # 8 bytes of nanoseconds in the day, then the 4-byte Julian day
        raw = np.frombuffer(buf, np.dtype([('ns', '<i8'), ('day', '<i4')]),
                            count)
        days = raw['day'].astype(np.int64) - JULIAN_UNIX_EPOCH
        return days * NS_PER_DAY + raw['ns']
    if ptype == 'BOOLEAN':
        return _unpack_bits(buf, 1, count).astype(bool)
    if ptype == 'BYTE_ARRAY':
        out = np.empty(count, object)
        mv = memoryview(buf)
        pos = 0
        for i in range(count):
            n = int.from_bytes(mv[pos:pos + 4], 'little')
            pos += 4
            out[i] = bytes(mv[pos:pos + n])
            pos += n
        return out
    raise ValueError(f'Parquet: physical type {ptype} is not read')


def _uleb(buf, pos):
    """(an unsigned LEB128 varint, the position after it)."""
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError('Parquet: a DELTA header ends early')
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _zigzag(n):
    return (n >> 1) ^ -(n & 1)


def delta_binary_packed(buf, pos, bits):
    """DELTA_BINARY_PACKED at ``pos`` of ``buf``: (the values as a signed
    array of ``bits`` bits, the position after them). The deltas add up
    modulo 2**64, then wrap to the type's width, as the format's modular
    arithmetic does."""
    block, pos = _uleb(buf, pos)
    n_mini, pos = _uleb(buf, pos)
    total, pos = _uleb(buf, pos)
    first, pos = _uleb(buf, pos)
    first = _zigzag(first)
    if block <= 0 or block % 128 or n_mini <= 0 or block % n_mini or \
            (block // n_mini) % 32:
        raise ValueError(f'Parquet: a corrupt DELTA_BINARY_PACKED header '
                         f'(blocks of {block} in {n_mini} miniblocks)')
    per = block // n_mini
    starts, widths, mins = [], [], []
    need = total - 1
    while need > 0:
        min_delta, pos = _uleb(buf, pos)
        if pos + n_mini > len(buf):
            raise ValueError('Parquet: a DELTA_BINARY_PACKED block ends '
                             'early')
        block_widths = bytes(buf[pos:pos + n_mini])
        pos += n_mini
        for width in block_widths:
            if need <= 0:
                break  # the last block's unneeded miniblocks are absent
            if width > 64:
                raise ValueError(f'Parquet: a DELTA_BINARY_PACKED '
                                 f'miniblock {width} bits wide')
            starts.append(pos)
            widths.append(width)
            mins.append(_zigzag(min_delta) & 0xFFFFFFFFFFFFFFFF)
            pos += per * width // 8
            if pos > len(buf):
                raise ValueError('Parquet: a DELTA_BINARY_PACKED miniblock '
                                 'ends early')
            need -= per
    deltas = np.zeros((len(starts), per), np.uint64)
    widths = np.array(widths, np.int64)
    data = np.frombuffer(buf, np.uint8)
    for width in np.unique(widths[widths > 0]):
        rows = np.nonzero(widths == width)[0]
        nbytes = per * int(width) // 8
        gathered = data[np.array(starts)[rows, None]
                        + np.arange(nbytes)].reshape(-1)
        deltas[rows] = _unpack_bits(gathered, int(width),
                                    len(rows) * per).reshape(len(rows), per)
    deltas += np.array(mins, np.uint64)[:, None]
    values = np.empty(total, np.uint64)
    if total:
        values[0] = first & 0xFFFFFFFFFFFFFFFF
        np.cumsum(deltas.reshape(-1)[:total - 1], out=values[1:])
        values[1:] += values[0]
    return values.astype(f'u{bits // 8}').view(f'i{bits // 8}'), pos


def _byte_arrays(data, lengths):
    """(the byte strings of ``lengths`` one after another in ``data``, the
    bytes they take)."""
    ends = np.cumsum(lengths, dtype=np.int64)
    if len(lengths) and (ends[-1] > len(data) or lengths.min() < 0):
        raise ValueError('Parquet: byte arrays past their page')
    data = bytes(data[:int(ends[-1])] if len(lengths) else b'')
    out = np.empty(len(lengths), object)
    out[:] = [data[a:b] for a, b in zip((ends - lengths).tolist(),
                                        ends.tolist())]
    return out, len(data)


def delta_length_byte_array(buf, pos):
    """DELTA_LENGTH_BYTE_ARRAY: (the values, the position after them)."""
    lengths, pos = delta_binary_packed(buf, pos, 32)
    values, used = _byte_arrays(buf[pos:], lengths)
    return values, pos + used


def delta_byte_array(buf, pos):
    """DELTA_BYTE_ARRAY: each value the previous one's prefix of the given
    length, then its suffix."""
    prefixes, pos = delta_binary_packed(buf, pos, 32)
    suffixes, pos = delta_length_byte_array(buf, pos)
    if len(prefixes) != len(suffixes):
        raise ValueError('Parquet: a corrupt DELTA_BYTE_ARRAY page')
    if len(prefixes) and prefixes.min() < 0:
        raise ValueError('Parquet: a negative DELTA_BYTE_ARRAY prefix')
    values = []
    previous = b''
    for p, suffix in zip(prefixes.tolist(), suffixes.tolist()):
        if p > len(previous):
            raise ValueError('Parquet: a DELTA_BYTE_ARRAY prefix past the '
                             'previous value')
        previous = previous[:p] + suffix if p else suffix
        values.append(previous)
    out = np.empty(len(values), object)
    out[:] = values
    return out, pos


def byte_stream_split(buf, ptype, count):
    """BYTE_STREAM_SPLIT: byte k of every value in stream k."""
    dtype = np.dtype(PLAIN_DTYPES[ptype])
    width = dtype.itemsize
    if count * width > len(buf):
        raise ValueError('Parquet: a BYTE_STREAM_SPLIT page ends early')
    streams = np.frombuffer(buf, np.uint8, count * width).reshape(width,
                                                                  count)
    return np.ascontiguousarray(streams.T).view(dtype).reshape(count) \
        .astype(dtype.newbyteorder('='))


def _values(data, pos, encoding, ptype, k):
    """``k`` non-null values of a data page by a value encoding that needs
    no dictionary."""
    if encoding == 0:
        return _plain(data[pos:], ptype, k)
    if encoding == 3 and ptype == 'BOOLEAN':  # RLE, length-prefixed
        length = int.from_bytes(data[pos:pos + 4], 'little')
        return rle_hybrid(data[pos + 4:pos + 4 + length], 1, k).astype(bool)
    if encoding == 5 and ptype in ('INT32', 'INT64'):
        values, _ = delta_binary_packed(data, pos, 32 if ptype == 'INT32'
                                        else 64)
    elif encoding == 6 and ptype == 'BYTE_ARRAY':
        values, _ = delta_length_byte_array(data, pos)
    elif encoding == 7 and ptype == 'BYTE_ARRAY':
        values, _ = delta_byte_array(data, pos)
    elif encoding == 9 and ptype in PLAIN_DTYPES:
        return byte_stream_split(data[pos:], ptype, k)
    else:
        raise ValueError(f'Parquet: the {ENCODINGS.get(encoding, encoding)} '
                         f'encoding of {ptype} is not read')
    if len(values) != k:
        raise ValueError(f'Parquet: a {ENCODINGS[encoding]} page holds '
                         f'{len(values)} values for {k}')
    return values


# -- the file ---------------------------------------------------------------

def _footer(f):
    f.seek(0, 2)
    size = f.tell()
    if size < 12:
        raise ValueError('Parquet: the file is too short')
    f.seek(size - 8)
    tail = f.read(8)
    if tail[4:] != MAGIC:
        raise ValueError('not a Parquet file (no PAR1 at its end)')
    length = int.from_bytes(tail[:4], 'little')
    f.seek(size - 8 - length)
    return _Thrift(f.read(length)).struct()


def _key_values(meta):
    return {kv[1].decode(): kv.get(2, b'').decode()
            for kv in meta.get(5, [])}


def num_rows(path) -> int:
    """The rows of a Parquet file, from its footer alone."""
    with open(path, 'rb') as f:
        return _footer(f)[3]


def _leaves(schema):
    """The flat schema's columns: (name, element) in order."""
    root, rest = schema[0], schema[1:]
    if root.get(5, 0) != len(rest):
        raise ValueError('Parquet: nested schemas are not read')
    leaves = []
    for el in rest:
        name = el[4].decode()
        if el.get(5) or el.get(3, 0) == REPEATED:
            raise ValueError(f'Parquet: column {name!r} is nested or '
                             f'repeated; nested schemas are not read')
        leaves.append((name, el))
    return leaves


def _pages(f, md):
    """(header, body) of each page of the column chunk whose metadata is
    ``md``, the dictionary page first where there is one."""
    f.seek(md.get(11) or md[9])
    raw = f.read(md[7])
    t = _Thrift(raw)
    while t.pos < len(raw):
        header = t.struct()
        body = raw[t.pos:t.pos + header[3]]
        t.pos += header[3]
        yield header, body


def _read_chunk(f, chunk, ptype, optional, num_rows):
    """One column chunk, page by page: (the non-null values, a mask of the
    rows that have one, whether the values were PLAIN) for each data page,
    and the dictionary page's values (None without one)."""
    md = chunk[3]
    codec = md[4]
    dictionary = None
    values, present, plain = [], [], []
    rows = 0
    for header, body in _pages(f, md):
        kind, size = header[1], header[2]
        if kind == PAGE_DICTIONARY:
            page = header[7]
            _check_encoding(page[2], (0, 2))
            dictionary = _plain(_decompress(codec, body, size), ptype,
                                page[1])
            continue
        if kind == PAGE_INDEX:
            continue
        if kind == PAGE_DATA:
            page = header[5]
            n, encoding = page[1], page[2]
            data = _decompress(codec, body, size)
            pos = 0
            if optional:
                _check_encoding(page[3], (3,))
                length = int.from_bytes(data[:4], 'little')
                levels = rle_hybrid(data[4:4 + length], 1, n)
                pos = 4 + length
        elif kind == PAGE_DATA_V2:
            page = header[8]
            n, encoding = page[1], page[4]
            dlen, rlen = page[5], page[6]
            if rlen:
                raise ValueError('Parquet: repetition levels (nested '
                                 'columns) are not read')
            levels = rle_hybrid(body[:dlen], 1, n) if optional else None
            rest = body[dlen + rlen:]
            data = _decompress(codec, rest, size - dlen - rlen) \
                if page.get(7, True) else bytes(rest)
            pos = 0
        else:
            raise ValueError(f'Parquet: page type {kind} is not read')
        mask = levels.astype(bool) if optional else np.ones(n, bool)
        k = int(mask.sum())
        if encoding in (2, 8):
            if dictionary is None:
                raise ValueError('Parquet: a dictionary-encoded page without '
                                 'a dictionary page')
            bit_width = data[pos]
            idx = rle_hybrid(data[pos + 1:], bit_width, k)
            page_values = dictionary[idx]
        else:
            page_values = _values(data, pos, encoding, ptype, k)
        values.append(page_values)
        present.append(mask)
        plain.append(encoding not in (2, 8))
        rows += n
    if rows != num_rows:
        raise ValueError(f'Parquet: a column chunk holds {rows} values for '
                         f'{num_rows} rows')
    return values, present, plain, dictionary


def _check_encoding(encoding, allowed):
    if encoding not in allowed:
        raise ValueError(f'Parquet: the {ENCODINGS.get(encoding, encoding)} '
                         f'encoding is not read here')


def _logical(el):
    """(logical type name, its fields) of a schema element."""
    lt = el.get(10)
    if lt:
        (fid, fields), = lt.items()
        return {1: 'STRING', 2: 'MAP', 3: 'LIST', 4: 'ENUM', 5: 'DECIMAL',
                6: 'DATE', 7: 'TIME', 8: 'TIMESTAMP', 10: 'INTEGER',
                11: 'UNKNOWN', 12: 'JSON', 13: 'BSON', 14: 'UUID',
                15: 'FLOAT16'}.get(fid, str(fid)), fields
    converted = el.get(6)
    legacy = {0: ('STRING', {}), 9: ('TIMESTAMP', {1: True, 2: {1: {}}}),
              10: ('TIMESTAMP', {1: True, 2: {2: {}}}),
              15: ('INTEGER', {1: 8, 2: True}),
              16: ('INTEGER', {1: 16, 2: True}),
              17: ('INTEGER', {1: 32, 2: True}),
              18: ('INTEGER', {1: 64, 2: True}),
              11: ('INTEGER', {1: 8, 2: False}),
              12: ('INTEGER', {1: 16, 2: False}),
              13: ('INTEGER', {1: 32, 2: False}),
              14: ('INTEGER', {1: 64, 2: False})}
    if converted is None:
        return None, {}
    if converted not in legacy:
        raise ValueError(f'Parquet: converted type {converted} is not read')
    return legacy[converted]


def _categories(chunks):
    """A categorical's categories as pyarrow's dictionary reader gathers
    them: each chunk's dictionary page in its order, then the values of
    pages that fell back to PLAIN in the order they come, each new value
    once."""
    seen = {}
    for values, _, plain, dictionary in chunks:
        for b in (() if dictionary is None else dictionary):
            seen.setdefault(b, None)
        for page, is_plain in zip(values, plain):
            if is_plain:
                for b in page:
                    seen.setdefault(b, None)
    return np.array([b.decode('utf-8') for b in seen], object)


def _column(name, el, chunks, pandas_col):
    """(values, kind, categories) of one column, as ``as_columns`` gives
    the column ``pd.read_parquet`` returns."""
    ptype = TYPES[el[1]]
    logical, fields = _logical(el)
    values = [v for vs, _, _, _ in chunks for v in vs]
    present = np.concatenate([np.zeros(0, bool)] + [
        p for _, ps, _, _ in chunks for p in ps])
    n = len(present)
    has_null = not present.all()
    pandas_type = (pandas_col or {}).get('pandas_type')
    numpy_type = (pandas_col or {}).get('numpy_type')

    def spread(dtype, fill):
        out = np.full(n, fill, dtype=dtype)
        if values:
            out[present] = np.concatenate(values)
        return out

    if logical == 'UNKNOWN':  # the Null type: every value missing
        return np.full(n, None, object), 'object', None
    if ptype == 'BYTE_ARRAY':
        if logical not in ('STRING', 'JSON', 'ENUM'):
            raise ValueError(f'Parquet: column {name!r} is binary without '
                             f'the String type, which is not read')
        decoded = [np.array([b.decode('utf-8') for b in v], object)
                   for v in values]
        out = np.full(n, np.nan, object)
        if decoded:
            out[present] = np.concatenate(decoded)
        if pandas_type == 'categorical':
            categories = _categories(chunks)
            # pandas types no categories as object, strings as str
            inner = 'str' if len(categories) else 'object'
            return out, f'category[{inner}]', categories
        return out, 'str', None
    if ptype == 'BOOLEAN':
        if not has_null and numpy_type != 'boolean':
            return spread(bool, False), 'bool', None
        # pandas' nullable boolean as_columns gives with NaN; a column
        # with nulls otherwise comes back as objects with None
        out = np.full(n, np.nan if numpy_type == 'boolean' else None, object)
        if values:
            out[present] = [bool(v) for v in np.concatenate(values)]
        return out, 'object', None
    if ptype == 'INT96':
        out = np.full(n, np.datetime64('NaT'), 'datetime64[ns]')
        if values:
            out[present] = np.concatenate(values).view('datetime64[ns]')
        return out, 'datetime64[ns]', None
    if ptype in ('FLOAT', 'DOUBLE'):
        dtype = np.float32 if ptype == 'FLOAT' else np.float64
        if numpy_type in ('Float32', 'Float64'):
            dtype = np.float64
        return spread(dtype, np.nan), np.dtype(dtype).name, None
    if ptype in ('INT32', 'INT64'):
        if logical == 'TIMESTAMP':
            if fields.get(1):
                raise ValueError(f'Parquet: column {name!r} holds '
                                 f'timestamps with a time zone, which are '
                                 f'not read')
            (unit_id, _), = fields[2].items()
            dtype = f'datetime64[{TIME_UNITS[unit_id]}]'
            out = np.full(n, np.datetime64('NaT'), dtype)
            if values:
                out[present] = np.concatenate(values).astype(np.int64) \
                    .view(dtype)
            return out, dtype, None
        if logical not in (None, 'INTEGER'):
            raise ValueError(f'Parquet: column {name!r} has the {logical} '
                             f'type, which is not read')
        if logical == 'INTEGER':
            bits, signed = fields[1], fields[2]
        else:
            bits, signed = (32 if ptype == 'INT32' else 64), True
        dtype = np.dtype(f'{"i" if signed else "u"}{bits // 8}')
        raw = np.concatenate(values) if values \
            else np.zeros(0, PLAIN_DTYPES[ptype])
        if not signed:
            raw = raw.view(raw.dtype.str.replace('i', 'u'))
        raw = raw.astype(dtype)
        if has_null or numpy_type in NULLABLE_INTS:
            out = np.full(n, np.nan)
            out[present] = raw
            return out, 'float64', None
        return raw, dtype.name, None
    raise ValueError(f'Parquet: column {name!r} has physical type {ptype}, '
                     f'which is not read')


def compressed_pages(path):
    """Each page of the file as (codec id, its compressed bytes, the size
    they decompress to): the values part of a v2 page (codec 0 where the
    page is stored uncompressed), the whole body of a v1 or dictionary
    page."""
    with open(path, 'rb') as f:
        meta = _footer(f)
        for group in meta.get(4, []):
            for chunk in group[1]:
                md = chunk[3]
                for header, body in _pages(f, md):
                    size, codec = header[2], md[4]
                    if header[1] == PAGE_DATA_V2:
                        levels = header[8][5] + header[8][6]
                        body, size = body[levels:], size - levels
                        codec = codec if header[8].get(7, True) else 0
                    yield codec, body, size


def read_parquet(path) -> cl.Columns:
    """A Parquet file as ``Columns`` (see the module's docstring)."""
    with open(path, 'rb') as f:
        head = f.read(4)
        if head != MAGIC:
            raise ValueError(f'not a Parquet file: {path}')
        meta = _footer(f)
        leaves = _leaves(meta[2])
        kv = _key_values(meta)
        pandas_meta = json.loads(kv['pandas']) if 'pandas' in kv else {}
        by_field = {c.get('field_name', c.get('name')): c
                    for c in pandas_meta.get('columns', [])}
        index_fields = [c for c in pandas_meta.get('index_columns', [])
                        if isinstance(c, str)]
        chunks = {name: [] for name, _ in leaves}
        for group in meta.get(4, []):
            group_rows = group[3]
            for (name, el), chunk in zip(leaves, group[1]):
                if chunk.get(1):
                    raise ValueError('Parquet: columns in other files are '
                                     'not read')
                ptype = TYPES[el[1]]
                if ptype not in ('BOOLEAN', 'INT32', 'INT64', 'INT96',
                                 'FLOAT', 'DOUBLE', 'BYTE_ARRAY'):
                    raise ValueError(f'Parquet: column {name!r} has '
                                     f'physical type {ptype}, which is not '
                                     f'read')
                optional = el.get(3, REQUIRED) == OPTIONAL
                chunks[name].append(_read_chunk(f, chunk, ptype, optional,
                                                group_rows))
    out = cl.Columns()
    index = []
    for name, el in leaves:
        values, kind, categories = _column(name, el, chunks[name],
                                           by_field.get(name))
        if name in index_fields:
            index.append(values)
        else:
            out.set(name, values, kind, categories)
    if index:
        out.index = index[0] if len(index) == 1 else list(zip(*index))
    for c in pandas_meta.get('index_columns', []):
        if isinstance(c, dict) and c.get('kind') == 'range' and \
                (c['start'], c['step']) != (0, 1):
            out.index = np.arange(c['start'], c['stop'], c['step'])
    return out
