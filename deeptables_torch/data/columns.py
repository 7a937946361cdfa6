# -*- coding:utf-8 -*-
"""A table of named numpy columns: the port's stand-in for the pandas
``DataFrame`` that the JAX package's preprocessor works on.

``as_columns(X)`` takes what ``pd.DataFrame(X)`` takes (a DataFrame, a dict
of 1-D arrays, a 2-D array) and returns a :class:`Columns`: an ordered
mapping from column name to a 1-D numpy array, with each column's *kind*,
the name of the dtype pandas would give it:

- a numpy dtype's name (``'float64'``, ``'int32'``, ``'bool'``, ...);
- ``'str'``: strings, held as an object array, missing values ``NaN``
  (pandas 3 infers this dtype for columns of strings);
- ``'object'``: anything else held as Python objects;
- ``'category[<dtype>]'``: a pandas ``Categorical``, its values held as an
  object array of numpy scalars of the categories' dtype, missing ``NaN``,
  with the categories kept in ``Columns.categories``.

Non-string column names are renamed ``x_<name>`` and duplicate names are
refused, as the JAX preprocessor does (``preprocessor.py:176-190``). The
helpers below emulate the few pandas and scikit-learn conversions the
preprocessor's results depend on: ``Series.astype(str)`` (``as_str``),
``nunique`` (``nunique``), ``pd.to_numeric`` (``to_float``),
``np.asarray(df)`` (``to_2d``), the dtypes ``pd.DataFrame`` infers for a
2-D array (``Columns.from_2d``), ``pd.read_csv`` (``read_csv``),
``pd.concat`` (``concat``), ``pd.DataFrame`` of records
(``from_records``) and ``pd.read_parquet`` (``read_parquet``, by
``data/parquet.py``). pandas is imported only by ``to_frame``,
``records_table`` and the conversion of a DataFrame, which only a
DataFrame reaches.
"""

import csv
import hashlib
import io
import itertools
import os

import numpy as np

from ..utils import dt_logging

logger = dt_logging.get_logger(__name__)

FLOAT_DTYPES = (np.dtype(np.float64), np.dtype(np.float32),
                np.dtype(np.float16))


def is_frame(X) -> bool:
    """Whether ``X`` is a pandas DataFrame (without importing pandas)."""
    return type(X).__name__ == 'DataFrame' and hasattr(X, 'iloc')


def _is_nan(v) -> bool:
    return isinstance(v, (float, np.floating)) and v != v


def isna(values) -> np.ndarray:
    """Missing entries as pandas' ``isna`` sees them: NaN, and ``None`` in
    object arrays."""
    values = np.asarray(values)
    if values.dtype.kind in 'fc':
        return np.isnan(values)
    if values.dtype.kind == 'O':
        try:
            # NaN alone is unequal to itself; element by element in C
            out = np.not_equal(values, values) | np.equal(values, None)
            if out.dtype == bool and out.shape == values.shape:
                return out
        except (TypeError, ValueError):
            pass
        return np.fromiter((v is None or _is_nan(v) for v in values.flat),
                           bool, values.size).reshape(values.shape)
    return np.zeros(values.shape, bool)


def _all_str(values) -> bool:
    """pandas 3 infers ``str`` for an object column whose values are all
    strings or missing, with at least one string."""
    seen = False
    for v in values:
        if isinstance(v, str):
            seen = True
        elif not (v is None or _is_nan(v)):
            return False
    return seen


def _str_values(values) -> np.ndarray:
    """An object array of strings with ``NaN`` for missing (``None`` too)."""
    out = np.asarray(values, dtype=object).copy()
    out[isna(out)] = np.nan
    return out


def kind_of(values) -> str:
    """The kind pandas gives a numpy array as a column."""
    kind = values.dtype.kind
    if kind in 'US':
        return 'str'
    if kind == 'O':
        return 'str' if _all_str(values) else 'object'
    return values.dtype.name


def _category_inner(kind: str) -> str:
    return kind[len('category['):-1]


class Columns:
    """Ordered named columns of equal length: 1-D numpy arrays (a var-len
    column once encoded is a 2-D int32 array, one row a sample), with each
    column's kind, and the index of the DataFrame they came from, if any."""

    def __init__(self, data=(), index=None):
        self._data = {}
        self.kinds = {}
        self.categories = {}
        self.index = index
        for name, values in dict(data).items():
            self[name] = values

    # -- construction -----------------------------------------------------
    def set(self, name, values, kind=None, categories=None):
        values = np.asarray(values)
        if values.ndim == 0:
            values = values.reshape(1)
        if kind is None:
            kind = kind_of(values)
        if kind == 'str' and values.dtype.kind != 'O':
            values = values.astype(object)
        elif kind == 'str':
            values = _str_values(values)
        self._put(name, values, kind, categories)

    def _put(self, name, values, kind, categories=None):
        self._data[name] = values
        self.kinds[name] = kind
        if categories is None:
            self.categories.pop(name, None)
        else:
            self.categories[name] = categories

    def __setitem__(self, name, values):
        self.set(name, values)

    @classmethod
    def from_2d(cls, values, names, index=None):
        """The columns ``pd.DataFrame(values, columns=names)`` holds: one
        dtype for a numeric array; for an object array, ``str`` where a
        column holds strings only, else ``object``."""
        values = np.asarray(values)
        out = cls(index=index)
        for j, name in enumerate(names):
            out.set(name, values[:, j])
        return out

    # -- mapping ----------------------------------------------------------
    @property
    def columns(self):
        return list(self._data)

    def __getitem__(self, key):
        if isinstance(key, (list, tuple)):
            return self.select(key)
        return self._data[key]

    def __contains__(self, name):
        return name in self._data

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def __len__(self):
        return self.n_rows

    @property
    def n_rows(self) -> int:
        if not self._data:
            return 0 if self.index is None else len(self.index)
        return len(next(iter(self._data.values())))

    @property
    def shape(self):
        return self.n_rows, len(self._data)

    ndim = 2

    def __repr__(self):
        return f'Columns({self.n_rows} rows: {self.kinds})'

    # -- selection --------------------------------------------------------
    def _like(self, names, rows=None):
        out = Columns(index=self.index if rows is None or self.index is None
                      else self.index[rows])
        for name in names:
            values = self._data[name]
            out._put(name, values if rows is None else values[rows],
                     self.kinds[name], self.categories.get(name))
        return out

    def select(self, names):
        missing = [n for n in names if n not in self._data]
        if missing:
            raise KeyError(f'columns are missing: {missing}')
        return self._like(list(names))

    def take(self, rows):
        """The rows at ``rows`` (positions), as ``DataFrame.iloc``."""
        return self._like(self.columns, np.asarray(rows))

    def copy(self):
        """A new mapping over the same arrays: the preprocessor replaces
        columns and never writes into an array."""
        return self._like(self.columns)

    def pop(self, name):
        values = self._data.pop(name)
        self.kinds.pop(name)
        self.categories.pop(name, None)
        return values

    def drop(self, columns):
        drop = set([columns] if isinstance(columns, str) else columns)
        return self._like([n for n in self.columns if n not in drop])

    def signature(self) -> str:
        """A digest of the names, kinds and values (the fit cache's key)."""
        h = hashlib.md5()
        for name, values in self._data.items():
            h.update(repr((name, self.kinds[name], values.shape)).encode())
            if values.dtype.kind == 'O':
                h.update(repr([(type(v).__name__, repr(v))
                               for v in values.flat]).encode())
            else:
                h.update(np.ascontiguousarray(values).tobytes())
        return h.hexdigest()


# -- conversion at the boundary ------------------------------------------

def _from_series(s):
    """(values, kind, categories) of a pandas Series."""
    dtype = s.dtype
    if isinstance(dtype, np.dtype):
        values = s.to_numpy()
        return values, ('object' if dtype.kind == 'O' else dtype.name), None
    name = getattr(dtype, 'name', str(dtype))
    if name == 'category':
        categories = s.cat.categories.to_numpy()
        codes = s.cat.codes.to_numpy()
        values = np.empty(len(s), dtype=object)
        present = codes >= 0
        values[present] = list(categories[codes[present]])
        values[~present] = np.nan
        inner = str(s.cat.categories.dtype)
        return values, f'category[{inner}]', categories
    if name in ('str', 'string'):
        return s.to_numpy(dtype=object, na_value=np.nan), 'str', None
    if name in ('Int8', 'Int16', 'Int32', 'Int64', 'UInt8', 'UInt16',
                'UInt32', 'UInt64', 'Float32', 'Float64'):
        return s.to_numpy(dtype='float64', na_value=np.nan), 'float64', None
    return s.to_numpy(dtype=object, na_value=np.nan), 'object', None


def _is_series(v) -> bool:
    return type(v).__name__ == 'Series' and hasattr(v, 'iloc')


def as_columns(X, rename=True) -> Columns:
    """``X`` (a DataFrame, a dict of 1-D arrays or Series, a 2-D array, or
    ``Columns``) as ``Columns``; a ``Columns`` whose names need no renaming
    is returned as it is.

    With ``rename``, non-string names become ``x_<name>`` (a warning says
    so); duplicate names raise ``ValueError``."""
    if isinstance(X, Columns):
        if not rename or all(isinstance(n, str) for n in X.columns):
            return X
        names = ['x_' + str(n) for n in X.columns]
        logger.warning(f'Column index of X has been converted: {names}')
        out = Columns(index=X.index)
        for name, old in zip(names, X.columns):
            out._put(name, X[old], X.kinds[old], X.categories.get(old))
        return out
    if is_frame(X):
        names = list(X.columns)
        index = X.index
        parts = [X.iloc[:, j] for j in range(len(names))]
    elif isinstance(X, dict):
        names = list(X)
        index = None
        parts = list(X.values())
    else:
        values = np.asarray(X)
        if values.ndim == 1:
            values = values.reshape(-1, 1)
        if values.ndim != 2:
            raise ValueError('X must be a 2D dataset.')
        names = list(range(values.shape[1]))
        index = None
        parts = [values[:, j] for j in range(values.shape[1])]
    if len(set(names)) != len(names):
        seen, dup = set(), []
        for n in names:
            if n in seen and n not in dup:
                dup.append(n)
            seen.add(n)
        raise ValueError(f'Columns with duplicate names in X: {dup}')
    if rename and not all(isinstance(n, str) for n in names):
        names = ['x_' + str(n) for n in names]
        logger.warning(f'Column index of X has been converted: {names}')
    out = Columns(index=index)
    n_rows = None
    for name, part in zip(names, parts):
        if _is_series(part):
            values, kind, categories = _from_series(part)
        else:
            values = np.asarray(part)
            if values.ndim != 1:
                raise ValueError(f'column {name!r} is not 1-D: '
                                 f'shape {values.shape}.')
            kind, categories = kind_of(values), None
        if n_rows is None:
            n_rows = len(values)
        elif len(values) != n_rows:
            raise ValueError(f'column {name!r} has {len(values)} rows, '
                             f'expected {n_rows}.')
        out.set(name, values, kind, categories)
    return out


def to_frame(cols: Columns):
    """A pandas DataFrame of ``cols`` (their kinds as dtypes, the index they
    came with); a 2-D column becomes an object column of its rows."""
    import pandas as pd
    n = cols.n_rows
    index = cols.index if cols.index is not None else pd.RangeIndex(n)
    data = {}
    for name, values in cols.items():
        kind = cols.kinds[name]
        if values.ndim == 2:
            rows = np.empty(n, dtype=object)
            for i in range(n):
                rows[i] = values[i]
            data[name] = pd.Series(rows, index=index, dtype=object)
        elif kind == 'str':
            data[name] = pd.Series(values, index=index, dtype='str')
        elif kind.startswith('category['):
            data[name] = pd.Series(pd.Categorical(
                values, categories=cols.categories.get(name)), index=index)
        elif kind == 'object':
            data[name] = pd.Series(values, index=index, dtype=object)
        else:
            data[name] = pd.Series(values, index=index)
    return pd.DataFrame(data, index=index)


# -- the pandas conversions the preprocessor depends on --------------------

def unique(values) -> np.ndarray:
    """The distinct non-missing values in order of first appearance
    (``pd.unique`` after ``dropna``)."""
    values = np.asarray(values)
    values = values[~isna(values)]
    if values.dtype.kind == 'O':
        return np.array(list(dict.fromkeys(values.tolist())), dtype=object)
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def nunique(values) -> int:
    """``Series.nunique()``: distinct values, missing ones not counted."""
    values = np.asarray(values)
    if values.dtype.kind == 'O':
        return len(unique(values))
    return len(np.unique(values[~isna(values)]))


def as_str(values) -> np.ndarray:
    """``Series.astype(str)`` as a numpy unicode array: numbers as Python
    prints them, numpy scalars as numpy prints them; a missing value becomes
    ``'nan'`` (pandas before 3 gave ``'nan'``; pandas 3 keeps it missing,
    which the label encoders then fail to sort)."""
    values = np.asarray(values)
    if values.dtype.kind in 'fciub':
        return values.astype(str)
    if values.dtype.kind == 'U':
        return values
    if not values.size:
        return np.array([], dtype='<U1')
    out = np.frompyfunc(str, 1, 1)(values).astype(str)
    missing = isna(values)
    if missing.any():
        out = out.astype(f'<U{max(out.dtype.itemsize // 4, 3)}')
        out[missing] = 'nan'
    return out


def to_float(values) -> np.ndarray:
    """``pd.to_numeric(values, errors='coerce')`` as float64: text that does
    not parse as a number becomes NaN."""
    values = np.asarray(values)
    try:
        return values.astype(np.float64)
    except (TypeError, ValueError):
        out = np.empty(len(values), dtype=np.float64)
        for i, v in enumerate(values.tolist()):
            try:
                out[i] = np.nan if v is None else float(v)
            except (TypeError, ValueError):
                out[i] = np.nan
        return out


def _dtype_key(cols: Columns, name):
    """What pandas' ``find_common_type`` compares for a column: its numpy
    dtype, ``('str',)``, or ``('category', categories dtype, categories)``."""
    kind = cols.kinds[name]
    if kind == 'str':
        return ('str',)
    if kind.startswith('category['):
        inner = _category_inner(kind)
        categories = cols.categories.get(name)
        cats = () if categories is None else tuple(categories.tolist())
        return ('category', inner, cats)
    return np.dtype(kind)


def _inner_key(inner: str):
    return ('str',) if inner in ('str', 'string') else np.dtype(inner)


def _common_key(keys):
    """pandas' ``find_common_type`` over column dtypes (numpy dtypes,
    ``str``, categoricals); a result that is not a numpy dtype is what
    ``np.asarray`` makes object."""
    if all(k == keys[0] for k in keys):
        return keys[0]
    keys = list(dict.fromkeys(keys))
    if any(isinstance(k, tuple) for k in keys):
        for k in keys:
            if k == ('str',):
                if all(o == ('str',) or (isinstance(o, np.dtype)
                                         and o.kind in 'U') for o in keys):
                    return ('str',)
            elif isinstance(k, tuple):
                inner = [_inner_key(o[1]) if isinstance(o, tuple)
                         and o[0] == 'category' else o for o in keys]
                return _common_key(inner)
        return np.dtype(object)
    if any(k.kind == 'b' for k in keys) and \
            any(k.kind in 'iufc' for k in keys):
        return np.dtype(object)
    try:
        common = np.result_type(*keys)
    except TypeError:
        return np.dtype(object)
    return np.dtype(object) if common.kind in 'mMSU' else common


def _column_as(cols: Columns, name, dtype):
    values = cols[name]
    if dtype.kind == 'O':
        if values.dtype.kind == 'O':
            return np.array([v.item() if isinstance(v, np.generic) else v
                             for v in values], dtype=object) \
                if cols.kinds[name].startswith('category[') else values
        return values.astype(object)
    if values.dtype.kind == 'O' and isna(values).any() \
            and dtype.kind in 'iub':
        raise ValueError(f'Cannot convert column {name!r} with missing '
                         f'values to {dtype}.')
    return values.astype(dtype)


def to_2d(cols: Columns, dtype=None) -> np.ndarray:
    """``np.asarray(df, dtype)`` of the DataFrame of ``cols``: the columns'
    common type as pandas finds it (a categorical alone gives its values'
    numpy type, float64 if integer categories miss values), a new
    column-major array."""
    names = cols.columns
    n = cols.n_rows
    if dtype is None:
        if len(names) == 1:
            key = _dtype_key(cols, names[0])
            if isinstance(key, np.dtype):
                dtype = key
            elif key == ('str',):
                dtype = np.dtype(object)
            else:
                inner = _inner_key(key[1])
                if inner == ('str',) or inner.kind in 'OU':
                    dtype = np.dtype(object)
                elif isna(cols[names[0]]).any():
                    dtype = np.dtype(np.float64) if inner.kind in 'iuf' \
                        else np.dtype(object)
                else:
                    dtype = inner
        else:
            key = _common_key([_dtype_key(cols, c) for c in names])
            dtype = key if isinstance(key, np.dtype) else np.dtype(object)
    dtype = np.dtype(dtype)
    # column-major, as pandas lays a frame's values out: a reduction over
    # the rows then sums each column pairwise, as it does on the frame's
    out = np.empty((len(names), n), dtype=dtype).T
    for j, name in enumerate(names):
        out[:, j] = _column_as(cols, name, dtype)
    return out


def numpy_dtype(cols: Columns, name):
    """The column's numpy dtype as a DataFrame column, None where pandas
    gives it an extension dtype (``str``, categorical)."""
    key = _dtype_key(cols, name)
    return key if isinstance(key, np.dtype) else None


# -- pd.read_csv and pd.concat ---------------------------------------------

# pandas' default missing-value strings (``pandas._libs.parsers.
# STR_NA_VALUES``) and its default spellings of True and False
NA_VALUES = ('', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN',
             '-nan', '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN',
             'None', 'n/a', 'nan', 'null')
TRUE_VALUES = ('True', 'TRUE', 'true')
FALSE_VALUES = ('False', 'FALSE', 'false')
_TOKENS = {'U': (NA_VALUES, TRUE_VALUES, FALSE_VALUES, '_'),
           'S': tuple(tuple(t.encode() for t in group) for group in
                      (NA_VALUES, TRUE_VALUES, FALSE_VALUES)) + (b'_',)}
# bytes read at a time by the vectorised tokenizer
CSV_BLOCK_BYTES = 8 << 20


def _python_ints(text):
    """The fields as Python ints, or None where one is not an integer."""
    try:
        return [int(s) for s in text.tolist()]
    except ValueError:
        return None


# the powers of ten that pandas' parser scales by (correctly rounded)
_POW10 = np.array([float(f'1e{k}') for k in range(309)])


def _chars(text):
    """An ASCII ``S`` array's bytes as an ``(n, itemsize)`` uint8 matrix."""
    width = text.dtype.itemsize
    if not width:
        return np.zeros((len(text), 0), np.uint8)
    return np.ascontiguousarray(text).view(np.uint8).reshape(len(text), width)


def _ascii_to_str(text):
    """An ASCII ``S`` array as a ``U`` array of the same text (each byte
    widened, which ``astype('U')`` does a field at a time)."""
    width = max(text.dtype.itemsize, 1)
    return np.ascontiguousarray(text, dtype=f'S{width}').view(np.uint8) \
        .astype(np.uint32).view(f'U{width}').reshape(len(text))


def _pandas_floats(text, floats=None):
    """The float64 values pandas' default ("high") parser,
    ``precise_xstrtod``, gives numeric text (an ASCII ``S`` array that
    Python's ``float`` takes; ``floats``, where given, Python's values of
    it): up to 17 significant digits summed as ``x * 10 + d`` in float64,
    then multiplied or divided by a power of ten (``1e308`` twice past it).
    This is not always the nearest float to the text, which Python's
    ``float`` gives; but a text of at most 15 digits and no exponent is an
    exact integer over an exact power of ten, one rounding, so there the
    two agree and Python's value is kept. The others are parsed by that
    algorithm, vectorised over the characters."""
    out = text.astype(np.float64) if floats is None else floats.copy()
    chars = _chars(text)
    is_digit = (chars >= 48) & (chars <= 57)
    # 'e', 'E' (an exponent), 'i', 'I' (inf, infinity)
    slow = (is_digit.sum(axis=1) > 15) \
        | np.isin(chars, (69, 101, 73, 105)).any(axis=1)
    if slow.any():
        out[slow] = _xstrtod(chars[slow])
    return out


def _xstrtod(chars):
    """``precise_xstrtod`` of the rows of an ``(n, width)`` uint8 matrix of
    numeric text (see ``_pandas_floats``)."""
    n, width = chars.shape
    lead, whole, frac, exp_sign, exp_digits = range(5)
    state = np.zeros(n, np.int8)
    value = np.zeros(n)
    digits = np.zeros(n, np.int64)
    exponent = np.zeros(n, np.int64)
    exp_value = np.zeros(n, np.int64)
    negative = np.zeros(n, bool)
    exp_negative = np.zeros(n, bool)
    for j in range(width):
        c = chars[:, j]
        is_digit = (c >= 48) & (c <= 57)
        d = c.astype(np.float64) - 48
        sign = (c == 43) | (c == 45)
        dot = c == 46
        e = (c == 101) | (c == 69)
        at_lead = state == lead
        negative |= at_lead & (c == 45)
        mantissa = (state <= whole) & is_digit
        fraction = (state == frac) & is_digit
        take = (mantissa | fraction) & (digits < 17)
        value = np.where(take, value * 10. + d, value)
        digits += take
        exponent += (mantissa & ~take).astype(np.int64) \
            - (fraction & take).astype(np.int64)
        in_exp = ((state == exp_sign) | (state == exp_digits)) & is_digit
        exp_value = np.where(in_exp, np.minimum(exp_value * 10 + (c - 48),
                                                10 ** 6), exp_value)
        exp_negative |= (state == exp_sign) & (c == 45)
        new = state.copy()
        new[at_lead & (sign | is_digit)] = whole
        new[(state <= whole) & dot] = frac
        new[((state == whole) | (state == frac)) & e] = exp_sign
        new[((state == exp_sign) & sign) | in_exp] = exp_digits
        state = new
    value = np.where(negative, -value, value)
    exponent += np.where(exp_negative, -exp_value, exp_value)
    out = np.empty(n)
    big = exponent > 308
    out[big] = np.where(negative[big], -np.inf, np.inf)
    up = (exponent > 0) & ~big
    with np.errstate(over='ignore'):
        out[up] = value[up] * _POW10[exponent[up]]
    down = (exponent <= 0) & (exponent >= -308)
    out[down] = value[down] / _POW10[-exponent[down]]
    tiny = (exponent < -308) & (exponent >= -616)
    out[tiny] = value[tiny] / _POW10[-308 - exponent[tiny]] / _POW10[308]
    out[exponent < -616] = 0.
    # 'inf', 'infinity', either sign, any case
    named = np.isin(chars, (73, 105)).any(axis=1)
    out[named] = np.where(negative[named], -np.inf, np.inf)
    return out


def _isin(text, tokens):
    """``np.isin(text, tokens)``, tested only where the first character is
    one that a token starts with."""
    if text.dtype.kind == 'S' and text.dtype.itemsize:
        firsts = np.frombuffer(b''.join(t[:1] for t in tokens) + b'\0',
                               np.uint8)
        first = np.ascontiguousarray(text).view(np.uint8)[
            ::text.dtype.itemsize]
        candidates = np.flatnonzero(np.isin(first, firsts))
        out = np.zeros(len(text), bool)
        out[candidates] = np.isin(text[candidates], tokens)
        return out
    return np.isin(text, tokens)


def _parse_field_column(text):
    """(values, kind) of one column's fields (a numpy ``U`` array, or an
    ASCII ``S`` array), as pandas' C parser infers them: int64 (float64 once
    a field is missing; past int64 uint64, text once a field is missing, or
    Python ints, NaN where missing), float64, bool
    (object with NaN once a field is missing), float64 for a column with no
    value, else ``'str'`` with each field's text as written."""
    na_tokens, true_tokens, false_tokens, underscore = _TOKENS[text.dtype.kind]
    n = len(text)
    na = _isin(text, na_tokens)
    has_na = bool(na.any())
    present = text[~na] if has_na else text
    if present.size == 0:
        return np.full(n, np.nan), 'float64'
    ints = floats = big = None
    try:
        ints = present.astype(np.int64)
    except OverflowError:
        big = _python_ints(present)
    except ValueError:
        pass
    if ints is None:
        try:
            floats = present.astype(np.float64)
        except ValueError:
            pass
    # numpy checks numbers as Python does, which also takes '1_000' and
    # spellings of NaN that pandas does not
    numeric = (ints is not None or big is not None or (
        floats is not None and not np.isnan(floats).any())) \
        and not (np.strings.find(present, underscore) >= 0).any()
    if numeric and present.dtype.kind == 'U':
        try:
            present = present.astype('S')
        except UnicodeEncodeError:
            numeric = False
    if numeric and big is not None:
        if min(big) >= 0 and max(big) < 1 << 64:
            if not has_na:
                return np.array(big, dtype=np.uint64), 'uint64'
            # pandas keeps a uint64 column with a missing field as text,
            # the missing fields' text too
            return (_ascii_to_str(text) if text.dtype.kind == 'S'
                    else text).astype(object), 'str'
        out = np.full(n, np.nan, dtype=object)
        out[np.flatnonzero(~na)] = big
        return out, 'object'
    if numeric:
        if ints is not None and not has_na:
            return ints, 'int64'
        out = np.full(n, np.nan)
        out[~na] = _pandas_floats(present, floats)
        return out, 'float64'
    is_true = _isin(present, true_tokens)
    if (is_true | _isin(present, false_tokens)).all():
        if not has_na:
            return is_true, 'bool'
        out = np.full(n, np.nan, dtype=object)
        out[~na] = is_true.tolist()
        return out, 'object'
    out = (_ascii_to_str(text) if text.dtype.kind == 'S' else text) \
        .astype(object)
    out[na] = np.nan
    return out, 'str'


def _header_names(row):
    """pandas' column names of a header row: an empty name becomes
    ``Unnamed: <position>``, a repeated one ``<name>.<k>`` (pandas'
    ``_dedup_names``)."""
    counts = {}
    names = []
    for j, name in enumerate(row):
        name = name or f'Unnamed: {j}'
        count = counts.get(name, 0)
        while count > 0:
            counts[name] = count + 1
            name = f'{name}.{count}'
            count = counts.get(name, 0)
        names.append(name)
        counts[name] = count + 1
    return names


def _row_fields(rows, width):
    """Each column's fields (``U`` arrays) of rows split by ``csv``: a short
    row's missing trailing fields are missing values, a long row an
    error."""
    if any(len(r) != width for r in rows):
        for r in rows:
            if len(r) > width:
                raise ValueError(f'Error tokenizing data: expected {width} '
                                 f'fields, saw {len(r)}: {r}')
        rows = [r + [''] * (width - len(r)) for r in rows]
    if not rows:
        return [np.array([], dtype=str) for _ in range(width)]
    return [np.array(column, dtype=str) for column in zip(*rows)]


def _gather(buf, starts, ends):
    """The byte strings ``buf[starts[i]:ends[i]]`` as an ``S`` array."""
    lens = ends - starts
    width = max(int(lens.max()), 1) if len(lens) else 1
    offsets = np.arange(width)
    out = np.take(buf, starts[:, None] + offsets, mode='clip')
    out[offsets >= lens[:, None]] = 0
    return out.view(f'S{width}').reshape(-1)


def _lines(buf):
    """(starts, ends) of the lines of a block of whole lines (a uint8 array
    without lone ``\r``) that pandas reads: a ``\r`` before a newline
    dropped, lines of spaces and tabs alone skipped as blank."""
    ends = np.flatnonzero(buf == 10)
    starts = np.concatenate([[0], ends[:-1] + 1])
    cr = np.zeros(len(ends), bool)
    cr[ends > starts] = buf[ends[ends > starts] - 1] == 13
    ends = ends - cr
    keep = ends > starts
    first = np.where(keep, buf[np.minimum(starts, len(buf) - 1)], 0)
    for i in np.flatnonzero((first == 32) | (first == 9)):
        keep[i] = bool(buf[starts[i]:ends[i]].tobytes().strip(b' \t'))
    return starts[keep], ends[keep]


def _block_fields(block: bytes, width):
    """Each column's fields (``S`` arrays) of a block of whole lines,
    vectorised: split at newlines and commas (``_lines``). A block of other
    text (non-ASCII, a lone ``\r``, rows of other lengths) goes through
    ``csv``."""
    if not block.isascii() or block.count(b'\r') != block.count(b'\r\n'):
        return _text_fields(block, width)
    buf = np.frombuffer(block, np.uint8)
    starts, ends = _lines(buf)
    commas = np.flatnonzero(buf == 44)
    if len(commas) != (width - 1) * len(starts) or len(starts) and (
            np.searchsorted(commas, ends) - np.searchsorted(commas, starts)
            != width - 1).any():
        return _text_fields(block, width)
    commas = commas.reshape(len(starts), width - 1)
    field_starts = np.concatenate([starts[:, None], commas + 1], axis=1)
    field_ends = np.concatenate([commas, ends[:, None]], axis=1)
    return [_gather(buf, field_starts[:, j], field_ends[:, j])
            for j in range(width)]


def _text_fields(block: bytes, width):
    text = io.StringIO(block.decode('utf-8'), newline='')
    return _row_fields(list(_csv_records(text)), width)


def _csv_records(lines):
    """The rows ``csv`` reads from lines of text, less the lines pandas
    skips as blank: empty ones and, unquoted, ones of spaces and tabs."""
    line = None

    def feed():
        nonlocal line
        for line in lines:
            yield line
    for row in csv.reader(feed()):
        if row and (len(row) > 1 or row[0].strip(' \t')
                    or '"' in line):
            yield row


def _blocks(f, first=b''):
    """Blocks of whole lines (each ending in a newline) of a binary file."""
    carry = first
    while True:
        data = f.read(CSV_BLOCK_BYTES)
        if not data:
            if carry:
                yield carry if carry.endswith(b'\n') else carry + b'\n'
            return
        data = carry + data
        cut = data.rfind(b'\n') + 1
        if cut:
            yield data[:cut]
        carry = data[cut:]


def _has_quotes(path):
    with open(path, 'rb') as f:
        while True:
            data = f.read(CSV_BLOCK_BYTES)
            if not data:
                return False
            if b'"' in data:
                return True


def _field_blocks(path, header):
    """(names, iterator of per-column field arrays) of a CSV file: a file
    without quotes through the vectorised tokenizer, a file with quotes (or
    a text file object) through ``csv``."""
    if isinstance(path, (str, bytes, os.PathLike)) and not _has_quotes(path):
        f = open(path, 'rb')
        first = b''
        while not first.strip(b' \t\r\n'):
            first = f.readline()
            if not first:
                f.close()
                raise ValueError('No columns to parse from file')
        row = next(csv.reader([first.decode('utf-8')]))
        names = _header_names(row) if header == 0 else list(range(len(row)))

        def fields():
            with f:
                for block in _blocks(f, b'' if header == 0 else first):
                    yield _block_fields(block, len(names))
        return names, fields()
    opened = not hasattr(path, 'read')
    f = open(path, newline='', encoding='utf-8') if opened else path
    records = _csv_records(f)
    first = next(records, None)
    if first is None:
        raise ValueError('No columns to parse from file')
    if header == 0:
        names = _header_names(first)
    else:
        names = list(range(len(first)))
        records = itertools.chain([first], records)

    def fields():
        try:
            while True:
                rows = list(itertools.islice(records, 1 << 16))
                if not rows:
                    return
                yield _row_fields(rows, len(names))
        finally:
            if opened:
                f.close()
    return names, fields()


def _typed_chunk(names, fields):
    out = Columns()
    for name, text in zip(names, fields):
        if len(text):
            values, kind = _parse_field_column(text)
        else:
            values, kind = np.array([], dtype=object), 'object'
        out._put(name, values, kind)
    return out


def _csv_chunks(path, chunksize, header):
    names, blocks = _field_blocks(path, header)
    pending, n_pending = [], 0
    for fields in blocks:
        pending.append(fields)
        n_pending += len(fields[0]) if fields else 0
        while chunksize and n_pending >= chunksize:
            merged = _merge(pending)
            yield _typed_chunk(names, [a[:chunksize] for a in merged])
            pending = [[a[chunksize:] for a in merged]]
            n_pending -= chunksize
    if n_pending or not chunksize:
        yield _typed_chunk(names, _merge(pending) if pending
                           else [np.array([], dtype=str)] * len(names))


def _merge(blocks):
    """The blocks' fields joined column by column (``S`` made ``U`` where a
    block was read through ``csv``)."""
    if len(blocks) == 1:
        return blocks[0]
    kinds = {a.dtype.kind for fields in blocks for a in fields}
    out = []
    for parts in zip(*blocks):
        if kinds == {'S', 'U'}:
            parts = [_ascii_to_str(a) if a.dtype.kind == 'S' else a
                     for a in parts]
        out.append(np.concatenate(parts))
    return out


def count_csv_rows(path, header=0):
    """The rows ``read_csv(path, header=header)`` gives, counted without
    typing them (lines that are not blank, for a file without quotes)."""
    rows = 0
    if _has_quotes(path):
        with open(path, newline='', encoding='utf-8') as f:
            rows = sum(1 for _ in _csv_records(f))
    else:
        with open(path, 'rb') as f:
            for block in _blocks(f):
                if block.count(b'\r') != block.count(b'\r\n'):
                    rows += sum(1 for _ in _csv_records(io.StringIO(
                        block.decode('utf-8'), newline='')))
                else:
                    rows += len(_lines(np.frombuffer(block, np.uint8))[0])
    return max(rows - (header == 0), 0)


def read_csv(path, chunksize=None, header=0):
    """``pd.read_csv(path, chunksize=chunksize, header=header)`` as
    ``Columns``: one ``Columns`` for the whole file, or with ``chunksize`` an
    iterator of ``Columns`` of that many rows each. ``path`` is a path or a
    text file object.

    A file without quotes is split at newlines and commas by numpy, a block
    of ``CSV_BLOCK_BYTES`` at a time; a file with quotes, or a text file
    object, is read with the standard library's ``csv``
    (``tools/csv_read_rate.py`` times the two). Each column is then
    typed as pandas (3.0) types it, chunk by chunk as it does, so one column
    may be int64 in one chunk and text in the next: pandas' default
    missing-value strings (``NA_VALUES``) are missing; a column of integers
    is int64 (float64 once a field is missing; past int64 uint64, which is
    text once a field is missing, or Python ints), of numbers float64, of
    ``True``/``False`` spellings bool (object with NaN once a field is
    missing), of missing values only float64, and anything else ``'str'``,
    keeping each field's text as written. Quoted fields, ``\r\n`` line ends
    and blank lines (empty, or of spaces and tabs alone) are read as pandas
    reads them; a row short of fields ends in missing values. Unlike
    pandas, a whole file is typed in one piece: pandas' ``low_memory``
    parser types a very large file in internal blocks and may mix types
    within a column (it warns when it does); that is not copied."""
    if header not in (0, None):
        raise ValueError(f'header must be 0 or None: {header!r}')
    chunks = _csv_chunks(path, chunksize, header)
    if chunksize:
        return chunks
    return next(chunks)


def read_parquet(path):
    """``as_columns(pd.read_parquet(path), rename=False)`` on numpy alone
    (``data/parquet.py``: neither pandas nor pyarrow)."""
    from . import parquet
    return parquet.read_parquet(path)


def _concat_kind(parts, name):
    """The kind ``pd.concat`` gives a column, from its kinds in ``parts``."""
    kinds = [p.kinds[name] for p in parts]
    if all(k == kinds[0] for k in kinds) and kinds[0].startswith('category['):
        cats = [p.categories.get(name) for p in parts]
        if all(c is not None and set(c.tolist()) == set(cats[0].tolist())
               for c in cats):
            return kinds[0]
    plain = []
    for p, k in zip(parts, kinds):
        if k.startswith('category['):
            inner = _category_inner(k)
            if inner in ('str', 'string'):
                k = 'str'
            elif np.dtype(inner).kind in 'iub' and isna(p[name]).any():
                k = 'float64'
            else:
                k = np.dtype(inner).name
        plain.append(k)
    if all(k == 'str' for k in plain):
        return 'str'
    if any(k in ('str', 'object') for k in plain):
        return 'object'
    dtypes = [np.dtype(k) for k in plain]
    letters = {d.kind for d in dtypes}
    if letters <= set('iuf') or letters <= set('biu'):
        return np.result_type(*dtypes).name
    return 'object'


def concat(parts):
    """``pd.concat(parts)`` of ``Columns`` with the same column names: each
    column of the kind pandas gives it (int with float float64, bool with
    integers int64, bool with float, text with numbers or a numeric kind
    with ``object`` object; categoricals with the same categories stay
    categorical, others take their categories' kind). The result has no
    index."""
    parts = list(parts)
    if not parts:
        raise ValueError('No objects to concatenate')
    names = parts[0].columns
    for p in parts[1:]:
        if set(p.columns) != set(names):
            raise ValueError(f'the parts have other columns: {p.columns} '
                             f'against {names}')
    out = Columns()
    for name in names:
        kind = _concat_kind(parts, name)
        if kind == 'object' or kind == 'str':
            pieces = [_column_as(p, name, np.dtype(object)) for p in parts]
        elif kind.startswith('category['):
            pieces = [p[name] for p in parts]
        else:
            pieces = [_column_as(p, name, np.dtype(kind))
                      if not p.kinds[name].startswith('category[')
                      else to_float(p[name]).astype(kind) for p in parts]
        out._put(name, np.concatenate(pieces), kind,
                 parts[0].categories.get(name)
                 if kind.startswith('category[') else None)
    return out


def _records_column(values):
    """(values, kind) that ``pd.DataFrame`` infers for a list of Python
    values: numbers of one numpy type keep it, integers are int64 and other
    numbers float64 (a missing one NaN), bools bool, strings ``'str'``
    (missing NaN); anything else, or bools with a missing value, object."""
    missing = [v is None or _is_nan(v) for v in values]
    present = [v for v, m in zip(values, missing) if not m]
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    if not present:
        if all(v is None for v in values):
            return out, 'object'
        return np.full(len(values), np.nan), 'float64'
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        return (np.array(values, dtype=bool), 'bool') if not any(missing) \
            else (out, 'object')
    if all(isinstance(v, (int, float, np.number)) for v in present):
        types = {np.asarray(v).dtype for v in present}
        if not any(missing):
            if len(types) == 1 and all(isinstance(v, np.generic)
                                       for v in present):
                dtype = types.pop()
                return np.array(values, dtype=dtype), dtype.name
            if all(t.kind in 'iu' for t in types):
                return np.array(values, dtype=np.int64), 'int64'
        return np.array([np.nan if m else v for v, m in zip(values, missing)],
                        dtype=np.float64), 'float64'
    if all(isinstance(v, str) for v in present):
        out[np.array(missing)] = np.nan
        return out, 'str'
    return out, 'object'


def from_records(rows):
    """``pd.DataFrame(rows)`` of a list of dicts as ``Columns``: the keys in
    order of first appearance, a key a row lacks missing (NaN), each column
    of the kind pandas infers (``_records_column``)."""
    names = list(dict.fromkeys(k for row in rows for k in row))
    out = Columns()
    for name in names:
        values, kind = _records_column([row.get(name, np.nan)
                                        for row in rows])
        out._put(name, values, kind)
    return out


def records_table(rows):
    """``pd.DataFrame(rows)`` where pandas imports, else ``from_records``
    (as ``data.datasets`` returns its tables)."""
    try:
        import pandas as pd
    except ImportError:
        return from_records(rows)
    return pd.DataFrame(rows)
