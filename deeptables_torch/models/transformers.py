# -*- coding:utf-8 -*-
"""Self-contained column transformers: the port's copy of
``deeptables_tpu/models/transformers.py`` (the same classes, fits, state
and outputs) on numpy alone.

The upstream deeptables delegates these to hypernets' ``sklearn_ex`` module
(``deeptables/models/preprocessor.py:14,107``: CategorizeEncoder,
MultiLabelEncoder, MultiKBinsDiscretizer, LgbmLeavesEncoder,
MultiVarLenFeatureEncoder, DataFrameWrapper, SimpleImputer,
PassThroughEstimator). The JAX package runs them on pandas and
scikit-learn; here they run on ``data.columns.Columns`` (named numpy
columns) and give the same values: ``ColumnTransformer`` and
``SimpleImputer`` follow scikit-learn's (the blocks' dtypes as
``np.asarray`` of a DataFrame gives them, the means of ``numpy.ma``, the
blocks stacked by ``np.hstack``) and keep the fitted attributes under
scikit-learn's names, so that a fitted pipeline reads the same in both
packages. All transformers are picklable and follow the ``fit_transform``
/ ``transform`` replay contract used by ``DefaultPreprocessor.transform_X``.

Only ``GbmLeavesEncoder`` (``apply_gbm_features=True``, off by default)
needs a library: LightGBM or scikit-learn, imported when it fits.
"""

import inspect
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from ..data import columns as cl
from ..utils import dt_logging

logger = dt_logging.get_logger(__name__)

# the scikit-learn release whose ColumnTransformer and SimpleImputer
# behaviour and fitted state the two classes below reproduce (scikit-learn
# records its version in the state of every estimator it pickles)
SKLEARN_VERSION = '1.9.0'


class PassThroughEstimator:
    """Identity step closing the pipeline (parity: hypernets
    PassThroughEstimator used at reference preprocessor.py:189)."""

    def fit(self, X, y=None):
        return self

    def transform(self, X):
        return X

    def fit_transform(self, X, y=None):
        return X


def _codes(classes, values, unseen):
    """Each value's position in the sorted ``classes``; ``unseen`` where a
    value is not among them."""
    values = np.asarray(values)
    if len(classes) == 0:
        return np.full(len(values), unseen, dtype=np.int64), \
            np.zeros(len(values), bool)
    try:
        idx = np.searchsorted(classes, values)
        idx = np.clip(idx, 0, len(classes) - 1)
        hit = np.asarray(classes[idx] == values, dtype=bool)
    except TypeError:
        mapping = {v: i for i, v in enumerate(classes.tolist())}
        idx = np.array([mapping.get(v, -1) for v in values.tolist()],
                       dtype=np.int64)
        hit = idx >= 0
    return np.where(hit, idx, unseen), hit


class SafeLabelEncoder:
    """Label encoder mapping unseen values at transform time to a dedicated
    code (``len(classes_)``) instead of raising.

    Values are compared as text (``Series.astype(str)``, ``columns.as_str``).
    The preprocessor reserves vocabulary headroom of +2 per column
    (reference preprocessor.py:333) which covers this unseen bucket.
    """

    def __init__(self):
        self.classes_ = None
        self._mapping: Optional[Dict] = None

    def fit(self, y):
        self.classes_ = np.unique(cl.as_str(y))
        self._mapping = {v: i for i, v in enumerate(self.classes_)}
        return self

    def transform(self, y):
        codes, _ = _codes(self.classes_, cl.as_str(y), len(self.classes_))
        return codes.astype(np.int32)

    def fit_transform(self, y):
        return self.fit(y).transform(y)

    def inverse_transform(self, codes):
        codes = np.asarray(codes).reshape(-1)
        out = np.empty(len(codes), dtype=self.classes_.dtype)
        valid = (codes >= 0) & (codes < len(self.classes_))
        out[valid] = self.classes_[codes[valid].astype(int)]
        if (~valid).any():
            out[~valid] = self.classes_[0]
        return out


    @classmethod
    def from_classes(cls, classes):
        """Construct a fitted encoder from a known class list (used by the
        exact two-pass streaming fit — data/streaming.py)."""
        enc = cls()
        enc.classes_ = np.array(list(classes))
        enc._mapping = {v: i for i, v in enumerate(enc.classes_)}
        return enc


class LabelEncoder(SafeLabelEncoder):
    """y-label encoder preserving original dtypes for inverse_transform."""

    def fit(self, y):
        self.classes_ = np.array(sorted(cl.unique(np.asarray(y).reshape(-1))))
        self._mapping = {v: i for i, v in enumerate(self.classes_)}
        return self

    def transform(self, y):
        codes, hit = _codes(self.classes_, np.asarray(y).reshape(-1), -1)
        if not hit.all():
            raise ValueError('y contains previously unseen labels.')
        return codes.astype(np.int32)


class MultiLabelEncoder:
    """Label-encode a set of categorical columns in place
    (parity: hypernets MultiLabelEncoder at reference preprocessor.py:389)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.encoders: Dict[str, SafeLabelEncoder] = {}

    def fit_transform(self, X, y=None):
        for c in self.columns:
            le = SafeLabelEncoder()
            X[c] = le.fit_transform(X[c])
            self.encoders[c] = le
        return X

    def transform(self, X):
        for c in self.columns:
            X[c] = self.encoders[c].transform(X[c])
        return X


class CategorizeEncoder:
    """Copy low-cardinality numeric columns into label-encoded categorical
    twins named ``<col>_cat`` (parity: hypernets CategorizeEncoder at
    reference preprocessor.py:322; suffix verified by
    tests/models/preprocessor_test.py:28-31)."""

    def __init__(self, columns: List[str], remain_numeric: bool = True):
        self.columns = list(columns)
        self.remain_numeric = remain_numeric
        self.encoders: Dict[str, SafeLabelEncoder] = {}
        self.new_columns = []  # list of (name, dtype, nunique)

    def fit_transform(self, X, y=None):
        self.new_columns = []
        for c in self.columns:
            if self.remain_numeric:
                target = f'{c}_cat'
            else:
                target = c
            le = SafeLabelEncoder()
            codes = le.fit_transform(X[c])
            X[target] = codes
            self.encoders[c] = le
            if self.remain_numeric:
                self.new_columns.append(
                    (target, 'int32', len(le.classes_)))
        return X

    def transform(self, X):
        for c in self.columns:
            target = f'{c}_cat' if self.remain_numeric else c
            X[target] = self.encoders[c].transform(X[c])
        return X


class DataFrameWrapper:
    """Run a transformer that returns a 2-D array and re-wrap the result as
    columns with the given names, keeping the index (parity: hypernets
    DataFrameWrapper at reference preprocessor.py:379)."""

    def __init__(self, transformer, columns: List[str]):
        self.transformer = transformer
        self.columns = list(columns)

    def fit_transform(self, X, y=None):
        values = self.transformer.fit_transform(X)
        return cl.Columns.from_2d(values, self.columns, index=X.index)

    def transform(self, X):
        values = self.transformer.transform(X)
        return cl.Columns.from_2d(values, self.columns, index=X.index)


class _SklearnState:
    """scikit-learn's estimator conventions that the fitted state shows:
    the version record last in the pickled state, and ``clone``, a new
    unfitted estimator of the same parameters."""

    def __getstate__(self):
        state = {k: v for k, v in self.__dict__.items()
                 if k != '_sklearn_version'}
        state['_sklearn_version'] = SKLEARN_VERSION
        return state

    def clone(self):
        params = inspect.signature(type(self).__init__).parameters
        return type(self)(**{name: getattr(self, name)
                             for name in list(params)[1:]})


def _check_array(X, dtype):
    """scikit-learn's ``check_array`` of the DataFrame of the columns ``X``:
    ``dtype`` None (as the data is), a tuple of accepted dtypes (the first
    unless the data's is among them) or one dtype. A bool column (pandas
    converts it first) gives the whole block the columns' common numpy type
    (float64 beside a categorical; object beside strings or objects)."""
    kinds = [X.kinds[c] for c in X.columns]
    keys = [cl.numpy_dtype(X, c) for c in X.columns]
    needs_early = any(k == 'bool' or k == 'category[bool]' for k in kinds)
    if all(k is not None for k in keys):
        orig = np.result_type(*keys)
    elif 'str' in kinds:
        orig = np.dtype(object)
    elif needs_early and 'object' in kinds:
        orig = np.dtype(object)
    else:
        orig = None
    if isinstance(dtype, tuple):
        dtype = None if orig is not None and orig in dtype else dtype[0]
    if needs_early:
        # DataFrame.astype(None) is float64
        return cl.to_2d(X, np.dtype(orig if dtype is None else dtype))
    return cl.to_2d(X, dtype)


class SimpleImputer(_SklearnState):
    """scikit-learn's ``SimpleImputer`` over named columns: ``mean``
    (float block, NaN skipped, ``numpy.ma``'s mean), ``most_frequent`` (the
    smallest of the most frequent values) and ``constant``; missing values
    are NaN (``None`` in an object block is not, as in scikit-learn). The
    block is ``np.asarray`` of the DataFrame of the columns, its dtype as
    pandas and scikit-learn choose it (``columns.to_2d``)."""

    def __init__(self, missing_values=np.nan, strategy='mean',
                 fill_value=None, copy=True, add_indicator=False,
                 keep_empty_features=False):
        self.missing_values = missing_values
        self.add_indicator = add_indicator
        self.keep_empty_features = keep_empty_features
        self.strategy = strategy
        self.fill_value = fill_value
        self.copy = copy

    def _validate_input(self, X, in_fit):
        if self.strategy in ('most_frequent', 'constant'):
            dtype = None
            if not in_fit and self._fit_dtype.kind == 'O':
                dtype = self._fit_dtype
        else:
            dtype = cl.FLOAT_DTYPES
        if in_fit:
            self.feature_names_in_ = np.asarray(X.columns, dtype=object)
            self.n_features_in_ = len(X.columns)
        else:
            missing = set(self.feature_names_in_) - set(X.columns)
            if missing:
                raise ValueError(f'columns are missing: {missing}')
        arr = _check_array(X, dtype)
        if in_fit:
            self._fit_dtype = arr.dtype
        if arr.dtype.kind not in ('i', 'u', 'f', 'O'):
            raise ValueError(
                f'SimpleImputer does not support data with dtype '
                f'{arr.dtype}. Please provide either a numeric array (with a '
                f'floating point or integer dtype) or categorical data '
                f'represented either as an array with integer dtype or an '
                f'array of string values with an object dtype.')
        if in_fit and self.strategy == 'constant' \
                and self.fill_value is not None \
                and arr.dtype.kind in 'iuf' \
                and isinstance(self.fill_value, str):
            raise ValueError(f"fill_value={self.fill_value!r} is invalid. "
                             f"Expected a numerical value when imputing "
                             f"numerical data")
        return arr

    @staticmethod
    def _mask(arr):
        if arr.dtype.kind == 'f':
            return np.isnan(arr)
        if arr.dtype.kind in 'iu':
            return np.zeros(arr.shape, bool)
        return cl.isna(arr) & np.frompyfunc(
            lambda v: v is not None, 1, 1)(arr).astype(bool)

    def fit(self, X, y=None):
        arr = self._validate_input(X, in_fit=True)
        if self.fill_value is None:
            fill_value = 0 if arr.dtype.kind in 'iuf' else 'missing_value'
        else:
            fill_value = self.fill_value
        self._fill_dtype = arr.dtype
        mask = self._mask(arr)
        self.indicator_ = None
        if self.strategy == 'mean':
            mean = np.ma.mean(np.ma.masked_array(arr, mask=mask), axis=0)
            stats = np.ma.getdata(mean)
            stats[np.ma.getmask(mean)] = \
                0 if self.keep_empty_features else np.nan
        elif self.strategy == 'most_frequent':
            stats = np.empty(arr.shape[1],
                             dtype=object if arr.dtype.kind == 'O' else None)
            for j in range(arr.shape[1]):
                stats[j] = self._most_frequent(arr[~mask[:, j], j])
        elif self.strategy == 'constant':
            stats = np.full(arr.shape[1], fill_value, dtype=arr.dtype)
        else:
            raise ValueError(f'strategy {self.strategy!r} is not supported.')
        self.statistics_ = stats
        return self

    @staticmethod
    def _most_frequent(values):
        if len(values) == 0:
            return 0
        if values.dtype.kind == 'O':
            counter = Counter(values.tolist())
            most = max(counter.values())
            return min(v for v, c in counter.items() if c == most)
        uniques, counts = np.unique(values, return_counts=True)
        return uniques[np.argmax(counts)]

    def transform(self, X):
        arr = self._validate_input(X, in_fit=False)
        stats = self.statistics_
        mask = self._mask(arr)
        valid = ~self._mask(stats)
        if not self.keep_empty_features and not valid.all():
            logger.warning(f'Skipping features without any observed values: '
                           f'{self.feature_names_in_[~valid]}.')
            arr, mask, stats = arr[:, valid], mask[:, valid], stats[valid]
        stats = stats.astype(self._fill_dtype, copy=False)
        for j in range(arr.shape[1]):
            if mask[:, j].any():
                arr[mask[:, j], j] = stats[j]
        return arr

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


class ColumnTransformer(_SklearnState):
    """scikit-learn's ``ColumnTransformer`` over named columns with
    ``remainder='drop'``: each transformer (a copy, fitted) takes its
    columns, and the blocks it returns are stacked with ``np.hstack``."""

    def __init__(self, transformers, remainder='drop', sparse_threshold=0.3,
                 n_jobs=None, transformer_weights=None, verbose=False,
                 verbose_feature_names_out=True):
        if remainder != 'drop':
            raise ValueError("only remainder='drop' is supported.")
        self.transformers = transformers
        self.remainder = remainder
        self.sparse_threshold = sparse_threshold
        self.n_jobs = n_jobs
        self.transformer_weights = transformer_weights
        self.verbose = verbose
        self.verbose_feature_names_out = verbose_feature_names_out

    def fit_transform(self, X, y=None):
        names = X.columns
        self.feature_names_in_ = np.asarray(names, dtype=object)
        self.n_features_in_ = len(names)
        self._columns = [list(cols) for _, _, cols in self.transformers]
        position = {name: i for i, name in enumerate(names)}
        for cols in self._columns:
            for c in cols:
                if c not in position:
                    raise ValueError(f'A given column is not a column of the '
                                     f'dataframe: {c!r}')
        self._transformer_to_input_indices = {
            name: [position[c] for c in cols]
            for (name, _, _), cols in zip(self.transformers, self._columns)}
        used = {i for idx in self._transformer_to_input_indices.values()
                for i in idx}
        remaining = sorted(set(range(len(names))) - used)
        self._transformer_to_input_indices['remainder'] = remaining
        self._remainder = ('remainder', self.remainder,
                           [names[i] for i in remaining])
        blocks, fitted = [], []
        for (name, est, _), cols in zip(self.transformers, self._columns):
            est = est.clone()
            blocks.append(est.fit_transform(X.select(cols)))
            fitted.append((name, est, cols))
        self.sparse_output_ = False
        self.transformers_ = fitted + \
            ([self._remainder] if remaining else [])
        self.output_indices_ = {}
        start = 0
        for (name, _, _), block in zip(fitted, blocks):
            self.output_indices_[name] = slice(start, start + block.shape[1])
            start += block.shape[1]
        for name in [t[0] for t in self.transformers] + ['remainder']:
            self.output_indices_.setdefault(name, slice(0, 0))
        return self._hstack(blocks, X.n_rows)

    def transform(self, X):
        missing = set(self.feature_names_in_) - set(X.columns)
        if missing:
            raise ValueError(f'columns are missing: {missing}')
        blocks = [est.transform(X.select(cols))
                  for _, est, cols in self.transformers_
                  if not isinstance(est, str)]
        return self._hstack(blocks, X.n_rows)

    @staticmethod
    def _hstack(blocks, n_rows):
        return np.hstack(blocks) if blocks else np.zeros((n_rows, 0))


def build_imputation_transformer(continuous_vars, obj_cats, num_cats):
    """The reference's imputation ColumnTransformer
    (preprocessor.py:345-376): mean for continuous, '' constant for object
    categoricals, 0 constant for numeric categoricals."""
    transformers = []
    if continuous_vars:
        transformers.append(
            ('continuous',
             SimpleImputer(missing_values=np.nan, strategy='mean'),
             continuous_vars))
    if obj_cats:
        transformers.append(
            ('categorical_obj',
             SimpleImputer(missing_values=np.nan, strategy='constant',
                           fill_value=''),
             obj_cats))
    if num_cats:
        transformers.append(
            ('categorical_num',
             SimpleImputer(missing_values=np.nan, strategy='constant',
                           fill_value=0),
             num_cats))
    return ColumnTransformer(transformers)


class FixedImputer:
    """Imputation step fitted from streaming statistics.

    Produces the same output columns as ``DataFrameWrapper(
    ColumnTransformer)`` built by :func:`build_imputation_transformer` —
    exactly ``continuous + obj_cats + num_cats`` (other columns dropped),
    with continuous NaNs replaced by the (streaming-exact) means, object
    categoricals by ``''`` and numeric categoricals by ``0``.
    """

    def __init__(self, means: Dict[str, float], obj_cats: List[str],
                 num_cats: List[str]):
        self.means = dict(means)
        self.obj_cats = list(obj_cats)
        self.num_cats = list(num_cats)
        self.columns = list(means) + self.obj_cats + self.num_cats

    def transform(self, X):
        out = cl.Columns(index=X.index)
        for c, m in self.means.items():
            values = X[c]
            if values.dtype.kind not in 'iub':  # integers hold no NaN
                values = cl.to_float(values)
                values = np.where(np.isnan(values), m, values)
            out[c] = values
        for c in self.obj_cats:
            values = np.asarray(X[c], dtype=object).copy()
            values[cl.isna(values)] = ''
            out.set(c, values, 'object')
        for c in self.num_cats:
            values = X[c]
            missing = cl.isna(values)
            if missing.any():
                values = np.where(missing, 0, values)
            out.set(c, values, X.kinds[c], X.categories.get(c))
        return out

    def fit_transform(self, X, y=None):
        return self.transform(X)


class FixedBinsDiscretizer:
    """Quantile discretizer fitted from precomputed bin edges — the
    streaming analog of sklearn's ``KBinsDiscretizer(strategy='quantile',
    encode='ordinal')``, matching its transform exactly
    (``np.searchsorted(edges[1:-1], x, side='right')``)."""

    def __init__(self, bin_edges: np.ndarray):
        self.bin_edges_ = np.asarray(bin_edges, dtype=np.float64)
        self.n_bins_ = np.array([len(self.bin_edges_) - 1])

    def transform(self, values):
        values = np.asarray(values, dtype=np.float64).reshape(-1, 1)
        codes = np.searchsorted(self.bin_edges_[1:-1], values[:, 0],
                                side='right')
        return codes.reshape(-1, 1)


def quantile_bin_edges(values, counts, n_bins):
    """Bin edges for quantile binning over a weighted value distribution,
    replicating ``np.percentile(..., method='averaged_inverted_cdf')`` over
    the expanded data followed by sklearn's tiny-bin-edge removal.

    ``values`` must be sorted ascending, ``counts`` their multiplicities.
    """
    values = np.asarray(values, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.int64)
    n = int(counts.sum())
    cum = np.cumsum(counts)  # cum[i] = # of elements <= values[i]
    quantiles = np.linspace(0, 100, n_bins + 1)
    edges = np.empty(n_bins + 1)
    for j, q in enumerate(quantiles):
        h = q / 100.0 * n
        # inverted_cdf: smallest v with cdf(v) >= h (h>0); averaged with the
        # right-shifted inverse when h is integral
        if h <= 0:
            edges[j] = values[0]
            continue
        i = int(np.searchsorted(cum, np.ceil(h), side='left'))
        i = min(i, len(values) - 1)
        if abs(h - round(h)) < 1e-9 and int(round(h)) < n:
            i2 = int(np.searchsorted(cum, int(round(h)) + 1, side='left'))
            i2 = min(i2, len(values) - 1)
            edges[j] = 0.5 * (values[i] + values[i2])
        else:
            edges[j] = values[i]
    # sklearn removes bins whose edges are too close (_discretization.py)
    mask = np.ediff1d(edges, to_begin=np.inf) > 1e-8
    return edges[mask]


class MinMaxScalerTransformer:
    """Min-max scale continuous columns in place (parity: hypernets
    MinMaxScalerTransformer at reference preprocessor.py:399)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.min_: Dict[str, float] = {}
        self.scale_: Dict[str, float] = {}

    def fit(self, X, y=None):
        for c in self.columns:
            col = cl.to_float(X[c])
            present = col[~np.isnan(col)]
            mn = float(present.min()) if len(present) else float('nan')
            mx = float(present.max()) if len(present) else float('nan')
            self.min_[c] = mn
            rng = mx - mn
            self.scale_[c] = 1.0 / rng if rng > 0 else 0.0
        return self

    def transform(self, X):
        for c in self.columns:
            X[c] = (cl.to_float(X[c]) - self.min_[c]) * self.scale_[c]
        return X

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)


class MultiKBinsDiscretizer:
    """Add ``<col>_discrete`` ordinal-binned twins of continuous columns
    (parity: hypernets MultiKBinsDiscretizer at reference
    preprocessor.py:410; suffix per preprocessor_test.py:30-32).

    Binning uses :func:`quantile_bin_edges` + :class:`FixedBinsDiscretizer`
    — numerically identical to sklearn's
    ``KBinsDiscretizer(strategy='quantile',
    quantile_method='averaged_inverted_cdf', encode='ordinal')`` (verified
    in tests) — so the in-memory and exact-streaming fits share one edge
    computation and produce bit-identical bins.
    """

    def __init__(self, columns: List[str], bins: int = 10,
                 strategy: str = 'quantile'):
        self.columns = list(columns)
        self.bins = bins
        self.strategy = strategy
        self.discretizers: Dict[str, FixedBinsDiscretizer] = {}
        self.new_columns = []  # (name, new_name, n_bins)

    @staticmethod
    def _values(X, c):
        values = cl.to_float(X[c])
        return np.where(np.isnan(values), 0.0, values)

    def fit_transform(self, X, y=None):
        self.new_columns = []
        for c in self.columns:
            new_name = f'{c}_discrete'
            values = self._values(X, c)
            uq, counts = np.unique(values, return_counts=True)
            n_bins = min(self.bins, max(len(uq), 2))
            kbd = FixedBinsDiscretizer(quantile_bin_edges(uq, counts, n_bins))
            X[new_name] = kbd.transform(values).astype(np.int32).reshape(-1)
            self.discretizers[c] = kbd
            self.new_columns.append((c, new_name, int(kbd.n_bins_[0])))
        return X

    def transform(self, X):
        for c, new_name, _bins in self.new_columns:
            X[new_name] = self.discretizers[c].transform(self._values(X, c)) \
                .astype(np.int32).reshape(-1)
        return X


def _var_len_parts(v, sep):
    """A var-len cell's tokens (a missing cell has none)."""
    if v is None or (isinstance(v, (float, np.floating)) and v != v):
        return []
    return [p for p in str(v).split(sep) if p != '']


class VarLenFeatureEncoder:
    """Split a delimited multi-value column, token-encode (0 = padding,
    unseen → dedicated code), left-align pad to the observed max length."""

    def __init__(self, sep='|'):
        self.sep = sep
        self._mapping: Dict[str, int] = {}
        self.max_element_length = 0

    @property
    def n_classes(self):
        return len(self._mapping)

    def fit(self, values):
        tokens = set()
        max_len = 0
        for v in np.asarray(values, dtype=object):
            parts = _var_len_parts(v, self.sep)
            tokens.update(parts)
            max_len = max(max_len, len(parts))
        # token ids start at 1; 0 is padding
        self._mapping = {t: i + 1 for i, t in enumerate(sorted(tokens))}
        self.max_element_length = max(max_len, 1)
        return self

    @classmethod
    def from_vocab(cls, tokens, max_element_length, sep='|'):
        """Fitted encoder from a known token vocabulary (streaming fit)."""
        enc = cls(sep)
        enc._mapping = {t: i + 1 for i, t in enumerate(sorted(tokens))}
        enc.max_element_length = max(int(max_element_length), 1)
        return enc

    def transform(self, values):
        """The token ids, one row a sample: an int32 array
        ``(n, max_element_length)``."""
        values = np.asarray(values, dtype=object)
        unseen = len(self._mapping) + 1
        out = np.zeros((len(values), self.max_element_length), dtype=np.int32)
        for i, v in enumerate(values):
            parts = _var_len_parts(v, self.sep)
            for j, p in enumerate(parts[:self.max_element_length]):
                out[i, j] = self._mapping.get(p, unseen)
        return out


class MultiVarLenFeatureEncoder:
    """Encode several var-len columns (parity: hypernets
    MultiVarLenFeatureEncoder at reference preprocessor.py:420).

    ``max_length_`` maps column name → padded length.
    """

    def __init__(self, var_len_columns):
        # var_len_columns: list of (name, sep, pool_strategy)
        self.specs = [(v[0], v[1]) for v in var_len_columns]
        self.encoders: Dict[str, VarLenFeatureEncoder] = {}
        self.max_length_: Dict[str, int] = {}

    def fit_transform(self, X, y=None):
        for name, sep in self.specs:
            enc = VarLenFeatureEncoder(sep)
            enc.fit(X[name])
            X[name] = enc.transform(X[name])
            self.encoders[name] = enc
            self.max_length_[name] = enc.max_element_length
        return X

    def transform(self, X):
        for name, _sep in self.specs:
            X[name] = self.encoders[name].transform(X[name])
        return X


def _have_lightgbm() -> bool:
    try:
        import lightgbm  # noqa: F401
        return True
    except Exception:
        return False


class GbmLeavesEncoder:
    """Append per-tree leaf indices as new features
    (parity: hypernets LgbmLeavesEncoder at reference preprocessor.py:436).

    Backend: LightGBM trees when the optional ``lightgbm`` package is
    importable (matching the reference exactly — same optional-import
    pattern as utils/dart_early_stopping.py), else ``'sklearn'``:
    scikit-learn's GradientBoosting algorithm, whose trees ``models/gbm.py``
    grows bit for bit without scikit-learn. Either way the per-sample leaf
    index of every tree becomes a new ``gbm_leaf_<i>`` column,
    label-encoded via a vectorized ``np.searchsorted`` over the sorted
    unique leaf values (unseen leaves map to the out-of-vocabulary code
    ``len(classes)``).
    """

    def __init__(self, cat_vars, cont_vars, task, **gbm_params):
        self.cat_vars = list(cat_vars)
        self.cont_vars = list(cont_vars)
        self.task = task
        params = dict(gbm_params)
        params.setdefault('n_estimators', 10)
        params.setdefault('max_depth', 3)
        # normalize LightGBM-style names (the reference's native vocabulary)
        # to a common form; each backend re-derives its own names at fit
        if 'num_boost_round' in params:
            params['n_estimators'] = params.pop('num_boost_round')
        if 'num_leaves' in params:
            params['max_leaf_nodes'] = params.pop('num_leaves')
        self.gbm_params = params
        self.backend = None
        self.model = None
        self.new_columns: List[str] = []
        self._leaf_encoders: list = []

    def _feature_frame(self, X):
        """The features as one 2-D array: each column numeric, NaN as 0,
        their common numpy type (``np.asarray`` of the DataFrame): the array
        that scikit-learn's ``validate_data`` would cast to float32."""
        cols = [c for c in (self.cat_vars + self.cont_vars) if c in X.columns]
        parts = []
        for c in cols:
            values = np.asarray(X[c])
            if values.dtype.kind not in 'iub':
                values = cl.to_float(values)
                values = np.where(np.isnan(values), 0.0, values)
            parts.append(values)
        if not parts:
            return np.zeros((X.n_rows, 0))
        return np.column_stack(parts)

    def _fit_model(self, feats, y):
        from ..utils import consts
        regression = self.task == consts.TASK_REGRESSION
        if self.backend is None:
            self.backend = 'lightgbm' if _have_lightgbm() else 'sklearn'
        if self.backend == 'lightgbm':
            import lightgbm
            p = dict(self.gbm_params)
            if 'max_leaf_nodes' in p:
                p['num_leaves'] = p.pop('max_leaf_nodes')
            p.setdefault('verbose', -1)
            cls = lightgbm.LGBMRegressor if regression \
                else lightgbm.LGBMClassifier
            self.model = cls(**p)
        else:
            from . import gbm
            cls = gbm.GradientBoostingRegressor if regression \
                else gbm.GradientBoostingClassifier
            self.model = cls(**self.gbm_params)
        self.model.fit(feats, np.asarray(y).reshape(-1))

    def _apply_model(self, feats):
        if self.backend == 'lightgbm':
            leaves = self.model.predict(feats, pred_leaf=True)
        else:
            leaves = self.model.apply(feats)
        return np.asarray(leaves).reshape(len(feats), -1)

    @staticmethod
    def _leaf_codes(classes, col):
        """Vectorized value→index mapping; unseen values → len(classes)."""
        idx = np.searchsorted(classes, col)
        idx = np.clip(idx, 0, len(classes) - 1)
        return np.where(classes[idx] == col, idx,
                        len(classes)).astype(np.int32)

    def fit_transform(self, X, y):
        feats = self._feature_frame(X)
        self._fit_model(feats, y)
        leaves = self._apply_model(feats)
        self.new_columns = []
        self._leaf_encoders = []
        for t in range(leaves.shape[1]):
            name = f'gbm_leaf_{t}'
            classes = np.unique(leaves[:, t])
            X[name] = self._leaf_codes(classes, leaves[:, t])
            self.new_columns.append(name)
            self._leaf_encoders.append(classes)
        return X

    def transform(self, X):
        feats = self._feature_frame(X)
        leaves = self._apply_model(feats)
        for t, name in enumerate(self.new_columns):
            classes = self._leaf_encoders[t]
            if isinstance(classes, dict):  # pre-round-4 pickled state
                classes = np.array(sorted(classes))
            X[name] = self._leaf_codes(np.asarray(classes), leaves[:, t])
        return X
