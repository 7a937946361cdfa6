# -*- coding:utf-8 -*-
"""Self-contained DataFrame transformers: the port's copy of
``deeptables_tpu/models/transformers.py`` (the same classes, fits and
outputs), importing the port's own logging and constants.

The upstream deeptables delegates these to hypernets' ``sklearn_ex`` module
(``deeptables/models/preprocessor.py:14,107``: CategorizeEncoder,
MultiLabelEncoder, MultiKBinsDiscretizer, LgbmLeavesEncoder,
MultiVarLenFeatureEncoder, DataFrameWrapper, SimpleImputer,
PassThroughEstimator).  This module implements that transformer surface on
pandas/numpy/sklearn.  All transformers are picklable and follow the
``fit_transform`` / ``transform`` replay contract used by
``DefaultPreprocessor.transform_X``.

With ``preprocessor.py``, the one module of the port that imports pandas
and scikit-learn at module level: it runs on the host's CPU only, and no
module on the card's path imports it.
"""

from typing import Dict, List, Optional

import numpy as np
import pandas as pd
from sklearn.compose import ColumnTransformer
from sklearn.impute import SimpleImputer as SkSimpleImputer

from ..utils import dt_logging

logger = dt_logging.get_logger(__name__)


class PassThroughEstimator:
    """Identity step closing the pipeline (parity: hypernets
    PassThroughEstimator used at reference preprocessor.py:189)."""

    def fit(self, X, y=None):
        return self

    def transform(self, X):
        return X

    def fit_transform(self, X, y=None):
        return X


class SafeLabelEncoder:
    """Label encoder mapping unseen values at transform time to a dedicated
    code (``len(classes_)``) instead of raising.

    The preprocessor reserves vocabulary headroom of +2 per column
    (reference preprocessor.py:333) which covers this unseen bucket.
    """

    def __init__(self):
        self.classes_ = None
        self._mapping: Optional[Dict] = None

    def fit(self, y):
        arr = pd.Series(y).astype('str')
        self.classes_ = np.array(sorted(arr.unique()))
        self._mapping = {v: i for i, v in enumerate(self.classes_)}
        return self

    def transform(self, y):
        arr = pd.Series(y).astype('str')
        unseen = len(self.classes_)
        return arr.map(self._mapping).fillna(unseen).astype(np.int32).values

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
        arr = pd.Series(y)
        self.classes_ = np.array(sorted(pd.unique(arr.dropna())))
        self._mapping = {v: i for i, v in enumerate(self.classes_)}
        return self

    def transform(self, y):
        arr = pd.Series(y)
        out = arr.map(self._mapping)
        if out.isnull().any():
            raise ValueError('y contains previously unseen labels.')
        return out.astype(np.int32).values


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
    """Run an (sklearn) transformer and re-wrap the result as a DataFrame
    with the given columns (parity: hypernets DataFrameWrapper at reference
    preprocessor.py:379)."""

    def __init__(self, transformer, columns: List[str]):
        self.transformer = transformer
        self.columns = list(columns)

    def fit_transform(self, X, y=None):
        values = self.transformer.fit_transform(X)
        return pd.DataFrame(values, columns=self.columns, index=X.index)

    def transform(self, X):
        values = self.transformer.transform(X)
        return pd.DataFrame(values, columns=self.columns, index=X.index)


def build_imputation_transformer(continuous_vars, obj_cats, num_cats):
    """The reference's imputation ColumnTransformer
    (preprocessor.py:345-376): mean for continuous, '' constant for object
    categoricals, 0 constant for numeric categoricals."""
    transformers = []
    if continuous_vars:
        transformers.append(
            ('continuous',
             SkSimpleImputer(missing_values=np.nan, strategy='mean'),
             continuous_vars))
    if obj_cats:
        transformers.append(
            ('categorical_obj',
             SkSimpleImputer(missing_values=np.nan, strategy='constant',
                             fill_value=''),
             obj_cats))
    if num_cats:
        transformers.append(
            ('categorical_num',
             SkSimpleImputer(missing_values=np.nan, strategy='constant',
                             fill_value=0),
             num_cats))
    return ColumnTransformer(transformers)


class FixedImputer:
    """Imputation step fitted from streaming statistics.

    Produces the same output frame as ``DataFrameWrapper(ColumnTransformer)``
    built by :func:`build_imputation_transformer` — a DataFrame containing
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
        out = {}
        for c, m in self.means.items():
            out[c] = pd.to_numeric(X[c], errors='coerce').fillna(m)
        for c in self.obj_cats:
            out[c] = X[c].astype(object).where(X[c].notna(), '')
        for c in self.num_cats:
            out[c] = X[c].fillna(0)
        return pd.DataFrame(out, index=X.index)[self.columns]

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
            col = pd.to_numeric(X[c], errors='coerce')
            mn, mx = float(col.min()), float(col.max())
            self.min_[c] = mn
            rng = mx - mn
            self.scale_[c] = 1.0 / rng if rng > 0 else 0.0
        return self

    def transform(self, X):
        for c in self.columns:
            col = pd.to_numeric(X[c], errors='coerce')
            X[c] = (col - self.min_[c]) * self.scale_[c]
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

    def fit_transform(self, X, y=None):
        self.new_columns = []
        for c in self.columns:
            new_name = f'{c}_discrete'
            values = pd.to_numeric(X[c], errors='coerce') \
                .fillna(0).values.astype(np.float64)
            uq, counts = np.unique(values, return_counts=True)
            n_bins = min(self.bins, max(len(uq), 2))
            kbd = FixedBinsDiscretizer(quantile_bin_edges(uq, counts, n_bins))
            X[new_name] = kbd.transform(values).astype(np.int32).reshape(-1)
            self.discretizers[c] = kbd
            self.new_columns.append((c, new_name, int(kbd.n_bins_[0])))
        return X

    def transform(self, X):
        for c, new_name, _bins in self.new_columns:
            values = pd.to_numeric(X[c], errors='coerce') \
                .fillna(0).values.reshape(-1, 1)
            X[new_name] = self.discretizers[c].transform(values) \
                .astype(np.int32).reshape(-1)
        return X


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

    def fit(self, series: pd.Series):
        tokens = set()
        max_len = 0
        for v in series.fillna(''):
            parts = [p for p in str(v).split(self.sep) if p != '']
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

    def transform(self, series: pd.Series):
        unseen = len(self._mapping) + 1
        out = np.zeros((len(series), self.max_element_length), dtype=np.int32)
        for i, v in enumerate(series.fillna('')):
            parts = [p for p in str(v).split(self.sep) if p != '']
            for j, p in enumerate(parts[:self.max_element_length]):
                out[i, j] = self._mapping.get(p, unseen)
        return list(out)


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
    pattern as utils/dart_early_stopping.py), else sklearn's
    GradientBoosting models.  Either way the per-sample leaf index of every
    tree becomes a new ``gbm_leaf_<i>`` column, label-encoded via a
    vectorized ``np.searchsorted`` over the sorted unique leaf values
    (unseen leaves map to the out-of-vocabulary code ``len(classes)``).
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
        cols = [c for c in (self.cat_vars + self.cont_vars) if c in X.columns]
        return X[cols].apply(pd.to_numeric, errors='coerce').fillna(0)

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
            from sklearn.ensemble import (GradientBoostingClassifier,
                                          GradientBoostingRegressor)
            cls = GradientBoostingRegressor if regression \
                else GradientBoostingClassifier
            self.model = cls(**self.gbm_params)
        self.model.fit(feats.values, np.asarray(y).reshape(-1))

    def _apply_model(self, feats):
        if self.backend == 'lightgbm':
            leaves = self.model.predict(feats.values, pred_leaf=True)
        else:
            leaves = self.model.apply(feats.values)
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
