# -*- coding:utf-8 -*-
"""A Parquet reader on numpy and the standard library: what
``DataFrame.to_parquet`` (pyarrow) writes, read as ``Columns`` equal to
``columns.as_columns(pd.read_parquet(path), rename=False)``, without pandas
or pyarrow.

It reads flat schemas of the Parquet format up to 2.6:

- the footer's Thrift compact protocol (decoded in Python);
- data pages v1 and v2, any number of row groups;
- pages uncompressed, SNAPPY (decompressed here) or GZIP (``zlib``);
- PLAIN and RLE_DICTIONARY / PLAIN_DICTIONARY values, also a column chunk
  that falls back from its dictionary to PLAIN part way through;
- the RLE / bit-packed hybrid of definition levels and dictionary indices;
- BOOLEAN, INT32, INT64, FLOAT, DOUBLE and BYTE_ARRAY with the String
  logical type (and INT32 with the Null type, pyarrow's all-null column).

The ``pandas`` key-value metadata, where the file has it, names the index
columns, which are dropped (a stored index, or a range other than
``0..n``, becomes ``Columns.index`` as a numpy array), and
each column's pandas dtype, from which the column's kind follows as
``as_columns`` gives it for what ``pd.read_parquet`` returns: a
categorical of strings is ``category[str]`` with the file's categories;
nullable integers and floats, and integers with nulls, are ``float64``
with NaN; a boolean column with nulls is ``object`` (``None``, or NaN for
pandas' nullable ``boolean``); timestamps are ``datetime64[<unit>]`` with
NaT; an all-null column is ``object`` of ``None``. Other codecs (ZSTD,
LZ4, BROTLI, ...), encodings (DELTA_*, BYTE_STREAM_SPLIT), physical types
and nested schemas raise ``ValueError`` naming them.
"""

import json
import struct
import zlib

import numpy as np

from . import columns as cl

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


def _decompress(codec, data, size):
    if codec == 0:
        return bytes(data)
    if codec == 1:
        return snappy_decompress(data)
    if codec == 2:
        out = zlib.decompress(bytes(data), 47)  # gzip or zlib header
        if len(out) != size:
            raise ValueError('Parquet: corrupt GZIP page')
        return out
    raise ValueError(f'Parquet: the {CODECS.get(codec, codec)} codec is not '
                     f'read (only UNCOMPRESSED, SNAPPY and GZIP)')


# -- encodings --------------------------------------------------------------

def _unpack_bits(buf, bit_width, count):
    """``count`` little-endian bit-packed values of ``bit_width`` bits."""
    if bit_width == 0:
        return np.zeros(count, np.int64)
    nbytes = (count * bit_width + 7) // 8
    raw = np.frombuffer(buf, np.uint8, min(nbytes, len(buf)))
    if len(raw) < nbytes:  # a last run cut short of its padding
        raw = np.concatenate([raw, np.zeros(nbytes - len(raw), np.uint8)])
    bits = np.unpackbits(raw, bitorder='little')[:count * bit_width]
    weights = (1 << np.arange(bit_width, dtype=np.int64))
    return bits.reshape(count, bit_width).astype(np.int64) @ weights


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
            values = _unpack_bits(buf[t.pos:], bit_width, n)
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
    """``count`` PLAIN values of physical type ``ptype``."""
    if ptype in PLAIN_DTYPES:
        dtype = np.dtype(PLAIN_DTYPES[ptype])
        return np.frombuffer(buf, dtype, count).astype(
            dtype.newbyteorder('='))
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


def _read_chunk(f, chunk, ptype, optional, num_rows):
    """One column chunk, page by page: (the non-null values, a mask of the
    rows that have one, whether the values were PLAIN) for each data page,
    and the dictionary page's values (None without one)."""
    md = chunk[3]
    codec = md[4]
    start = md.get(11) or md[9]  # the dictionary page first, if any
    f.seek(start)
    raw = f.read(md[7])
    t = _Thrift(raw)
    dictionary = None
    values, present, plain = [], [], []
    rows = 0
    while rows < md[5]:
        header = t.struct()
        kind, size, csize = header[1], header[2], header[3]
        body = raw[t.pos:t.pos + csize]
        t.pos += csize
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
        if encoding == 0:
            page_values = _plain(data[pos:], ptype, k)
        elif encoding == 3 and ptype == 'BOOLEAN':  # RLE, length-prefixed
            length = int.from_bytes(data[pos:pos + 4], 'little')
            page_values = rle_hybrid(data[pos + 4:pos + 4 + length], 1,
                                     k).astype(bool)
        elif encoding in (2, 8):
            if dictionary is None:
                raise ValueError('Parquet: a dictionary-encoded page without '
                                 'a dictionary page')
            bit_width = data[pos]
            idx = rle_hybrid(data[pos + 1:], bit_width, k)
            page_values = dictionary[idx]
        else:
            raise ValueError(f'Parquet: the '
                             f'{ENCODINGS.get(encoding, encoding)} encoding '
                             f'is not read (only PLAIN and dictionary)')
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
                if ptype not in ('BOOLEAN', 'INT32', 'INT64', 'FLOAT',
                                 'DOUBLE', 'BYTE_ARRAY'):
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
