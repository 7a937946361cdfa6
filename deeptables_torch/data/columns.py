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
``np.asarray(df)`` (``to_2d``) and the dtypes ``pd.DataFrame`` infers for a
2-D array (``Columns.from_2d``). pandas is imported only by ``to_frame`` and
by the conversion of a DataFrame, which only a DataFrame reaches.
"""

import hashlib

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
    out = ['nan' if (v is None or _is_nan(v)) else str(v)
           for v in values.flat]
    return np.array(out, dtype=str) if out else np.array([], dtype='<U1')


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
