# -*- coding:utf-8 -*-
"""Automatic tabular preprocessing: the port's copy of
``deeptables_tpu/models/preprocessor.py`` (the same pipeline, column
metadata, fit cache and outputs), importing the port's own transformers,
config, column records, logging and constants.

Capability parity with the upstream deeptables ``DefaultPreprocessor``
(``deeptables/models/preprocessor.py:100-515``): task inference + y label
encoding, feature triage (object/bool/category → categorical, optional
auto-categorize of low-cardinality numerics via ``nunique < n**cat_exponent``),
imputation, categorical label encoding, min-max scaling, KBins
discretization, GBM leaf features, var-len multi-hot encoding — all recorded
as an ordered transformer pipeline replayed at inference by ``transform_X``.
Fit results are memoized by a (data, config) signature like the upstream
``@cache`` decorator (preprocessor.py:157-161).

numpy alone: the data is taken as ``data.columns.Columns`` (named numpy
columns, each with the dtype pandas would give it), converted once at the
entry from a DataFrame, a dict of 1-D arrays or a 2-D array. Given a
DataFrame, ``fit_transform``, ``transform`` and ``transform_X`` return a
DataFrame (the same one the JAX package returns), else ``Columns``.
"""

import collections
import copy
import hashlib
import time

import numpy as np

from . import transformers as tx
from ..data import columns as cl
from .config import ModelConfig
from .metainfo import CategoricalColumn, ContinuousColumn, \
    VarLenCategoricalColumn
from ..utils import consts, dt_logging

logger = dt_logging.get_logger(__name__)


def _is_categorical_dtype(dtype: str) -> bool:
    """object/str/category/bool → categorical.  pandas 3 reports string
    columns as ``str`` (StringDtype), pandas<3 as ``object``; both match."""
    d = str(dtype).lower()
    return d.startswith(('object', 'str', 'category', 'bool'))


def _imputer_wants_string_fill(dtype) -> bool:
    """Whether the constant imputer fills with ``''`` (string-like values)
    or ``0`` (everything else).  The reference splits on the obj/str dtype
    prefix only (reference preprocessor.py:350-356), so bool and
    numeric-coded ``category`` columns take the numeric fill — a ``''``
    fill on int-coded categories crashes sklearn.  Categorical columns
    (``category[<dtype>]``, ``data.columns``) are resolved by their
    categories' dtype."""
    d = str(dtype).lower()
    if d.startswith('category['):
        return _imputer_wants_string_fill(d[len('category['):-1])
    return d.startswith(('object', 'str'))


def infer_task_type(y):
    """Infer (task, labels) from y (parity: hypernets infer_task_type used
    at reference preprocessor.py:204). The distinct values are counted as
    ``pd.unique`` finds them, missing ones dropped; text is of kind 'O'."""
    if np.ndim(y) > 1:
        return consts.TASK_MULTILABEL, list(range(np.shape(y)[-1]))
    y = np.asarray(y).reshape(-1)
    uniques = cl.unique(y)
    n_unique = len(uniques)
    kind = 'O' if y.dtype.kind in 'US' else y.dtype.kind
    if n_unique <= 1:
        raise ValueError('y must contain at least 2 distinct values.')
    if n_unique == 2:
        return consts.TASK_BINARY, sorted(uniques)
    if kind in 'fc':
        return consts.TASK_REGRESSION, []
    if kind in 'iu' and n_unique > max(50, len(y) * 0.5):
        return consts.TASK_REGRESSION, []
    return consts.TASK_MULTICLASS, sorted(uniques)


class AbstractPreprocessor:
    """Interface (parity: reference preprocessor.py:26-97)."""

    def __init__(self, config: ModelConfig):
        self.config = config
        self.labels_ = None
        self.task_ = None

    @property
    def pos_label(self):
        if self.labels_ is not None and len(self.labels_) == 2:
            return self.labels_[1]
        return None

    @property
    def labels(self):
        return self.labels_

    @property
    def task(self):
        return self.task_

    @property
    def signature(self):
        sign = hashlib.md5(
            repr(self.config.signature_fields()).encode('utf-8')).hexdigest()
        return sign

    def get_X_y_signature(self, X, y):
        """A digest of the columns (``Columns.signature``) and of y."""
        h = hashlib.md5(cl.as_columns(X).signature().encode())
        y = np.asarray(y)
        h.update(repr((y.dtype.str, y.shape)).encode())
        h.update(repr(y.tolist()).encode() if y.dtype.kind == 'O'
                 else np.ascontiguousarray(y).tobytes())
        return h.hexdigest()

    def fit_transform(self, X, y, copy_data=True):
        raise NotImplementedError

    def transform_X(self, X, copy_data=True):
        raise NotImplementedError

    def transform_y(self, y, copy_data=True):
        raise NotImplementedError

    def transform(self, X, y, copy_data=True):
        raise NotImplementedError

    def inverse_transform_y(self, y_indicator):
        raise NotImplementedError

    def get_categorical_columns(self):
        raise NotImplementedError

    def get_continuous_columns(self):
        raise NotImplementedError


# simple process-level fit cache (parity: hypernets @cache at reference
# preprocessor.py:157)
_FIT_CACHE = collections.OrderedDict()
_FIT_CACHE_SIZE = 4


class DefaultPreprocessor(AbstractPreprocessor):
    def __init__(self, config: ModelConfig, use_cache: bool = True):
        super().__init__(config)
        self.use_cache = use_cache
        self.reset()

    def reset(self):
        self.metainfo = None
        self.categorical_columns = None
        self.var_len_categorical_columns = None
        self.continuous_columns = None
        self.y_label_encoder = None
        self.X_transformers = collections.OrderedDict()

    # -- validation helpers ------------------------------------------------
    def _validate_fit_transform(self, X, y):
        if X is None:
            raise ValueError('X cannot be none.')
        if y is None:
            raise ValueError('y cannot be none.')
        X_shape = np.shape(X)
        y_shape = np.shape(y)
        if len(X_shape) != 2:
            raise ValueError('X must be a 2D dataset.')
        if X_shape[0] != y_shape[0]:
            raise ValueError(
                f'The number of samples of X and y must be the same. '
                f'X.shape:{X_shape}, y.shape:{y_shape}')
        if cl.isna(np.asarray(y)).any():
            raise ValueError('Missing values in y.')

    def _prepare_X(self, X):
        """``Columns`` of X (a new mapping): non-string names renamed
        ``x_<name>``, duplicate names refused."""
        return cl.as_columns(X).copy()

    # -- main API ----------------------------------------------------------
    def fit_transform(self, X, y, copy_data=True):
        """(X, y) transformed; X a DataFrame if one was given, else
        ``Columns``. The columns are never written in place, so
        ``copy_data`` copies nothing."""
        frame = cl.is_frame(X)
        X = self._prepare_X(X)
        X, y = self._fit_transform(X, y)
        return (cl.to_frame(X) if frame else X), y

    def _fit_transform(self, X, y):
        start = time.time()
        cache_key = None
        if self.use_cache:
            try:
                cache_key = (self.signature, self.get_X_y_signature(X, y))
                hit = _FIT_CACHE.get(cache_key)
                if hit is not None:
                    logger.info('fit_transform cache hit')
                    state, X_t, y_t = hit
                    self.__dict__.update(copy.deepcopy(state))
                    return X_t.copy(), np.copy(y_t)
            except Exception as e:
                logger.debug(f'fit cache skipped: {e}')
                cache_key = None

        self.reset()
        self._validate_fit_transform(X, y)
        y = self.fit_transform_y(np.copy(y))
        X = self._prepare_features(X)

        if self.config.auto_imputation:
            X = self._imputation(X)
        if self.config.auto_scale:
            X = self._standard_scale(X)
        if self.config.auto_encode_label:
            X = self._categorical_encoding(X)
        if self.config.auto_discrete:
            X = self._discretization(X)
        if self.config.apply_gbm_features and y is not None:
            X = self._apply_gbm_features(X, y)
        var_len_cols = self.config.var_len_categorical_columns
        if var_len_cols is not None and len(var_len_cols) > 0:
            X = self._var_len_encoder(X, var_len_cols)

        self.X_transformers['last'] = tx.PassThroughEstimator()

        self._cast(X)
        logger.info(f'fit_transform taken {time.time() - start}s')

        if cache_key is not None:
            state = {k: copy.deepcopy(v) for k, v in self.__dict__.items()
                     if k not in ('config',)}
            state['config'] = self.config
            _FIT_CACHE[cache_key] = (state, X.copy(), np.copy(y))
            while len(_FIT_CACHE) > _FIT_CACHE_SIZE:
                _FIT_CACHE.popitem(last=False)
        return X, y

    # -- streaming (out-of-core) fit ---------------------------------------
    def fit_from_stats(self, col_stats, y_stats, n_rows):
        """Fit the full transformer pipeline from one-pass streaming
        statistics (``data.streaming.collect_streaming_stats``) without
        materializing the dataset — the exact analog of the reference Dask
        preprocessor's full-data fit statistics
        (upstream ``deeptables/models/preprocessor.py:518-598``).

        Produces the same ``X_transformers`` pipeline (same keys, same
        order) and the same column metainfo as an in-memory
        ``fit_transform`` over the concatenated stream: vocabularies,
        imputation means, min/max scaling and quantile bin edges are exact
        (bins degrade to a bounded sketch only beyond the collector's
        ``vc_cap`` distinct values).  ``apply_gbm_features`` and multilabel
        tasks are not supported here (they need a trained sub-model /
        2-D y) — use the sample-based streaming fit instead.
        """
        if self.config.apply_gbm_features:
            raise ValueError('apply_gbm_features requires fitting a GBM on '
                             'data; use the sample-based streaming fit.')
        self.reset()

        # --- y: task inference + label encoding (mirror fit_transform_y) --
        y_uniques = sorted(y_stats.uniques)
        if self.config.task == consts.TASK_AUTO:
            n_unique = len(y_uniques)
            if n_unique <= 1:
                raise ValueError('y must contain at least 2 distinct values.')
            if n_unique == 2:
                self.task_, self.labels_ = consts.TASK_BINARY, y_uniques
            elif 'f' in y_stats.dtypes or 'c' in y_stats.dtypes:
                self.task_, self.labels_ = consts.TASK_REGRESSION, []
            elif ('i' in y_stats.dtypes or 'u' in y_stats.dtypes) \
                    and n_unique > max(50, y_stats.n_rows * 0.5):
                self.task_, self.labels_ = consts.TASK_REGRESSION, []
            else:
                self.task_, self.labels_ = consts.TASK_MULTICLASS, y_uniques
        else:
            self.task_ = self.config.task
            self.labels_ = None
        if self.task_ in (consts.TASK_BINARY, consts.TASK_MULTICLASS):
            self.y_label_encoder = tx.LabelEncoder.from_classes(y_uniques)
            self.labels_ = self.y_label_encoder.classes_
        elif self.task_ == consts.TASK_MULTILABEL:
            raise ValueError('multilabel y is 2-D; the streaming stats fit '
                             'supports single-column targets only.')
        else:
            self.labels_ = []

        # --- feature triage (mirror _prepare_features) ---------------------
        if self.config.cat_exponent >= 1:
            raise ValueError(f'"cat_exponent" must be less than 1, '
                             f'not {self.config.cat_exponent} .')
        var_len_cols = self.config.var_len_categorical_columns
        var_len_spec = {v[0]: (v[1], v[2]) for v in (var_len_cols or ())}
        unique_upper_limit = round(n_rows ** self.config.cat_exponent)
        num_vars, convert2cat_vars, cat_vars = [], [], []
        for c, st in col_stats.items():
            nunique = st.nunique
            dtype = st.resolved_dtype
            if nunique <= 1 and self.config.auto_discard_unique:
                continue
            if c in (self.config.exclude_columns or ()):
                continue
            if c in var_len_spec:
                sep, pooling = var_len_spec[c]
                self._append_var_len_categorical_col(c, nunique, sep, pooling)
                continue
            if isinstance(self.config.categorical_columns, list):
                if c in self.config.categorical_columns:
                    cat_vars.append((c, dtype, nunique))
                elif not _is_categorical_dtype(dtype):
                    num_vars.append((c, dtype, nunique))
                else:
                    logger.info(
                        f'Column [{c}] has been discarded. It is not '
                        f'numeric and not in [config.categorical_columns].')
            else:
                if _is_categorical_dtype(dtype):
                    cat_vars.append((c, dtype, nunique))
                elif self.config.auto_categorize \
                        and nunique < unique_upper_limit:
                    convert2cat_vars.append((c, dtype, nunique))
                else:
                    num_vars.append((c, dtype, nunique))

        def _str_classes(st, extra=()):
            vals = {str(v) for v in st.uniques}
            vals.update(extra)
            return sorted(vals)

        if convert2cat_vars:
            ce = tx.CategorizeEncoder([c for c, d, n in convert2cat_vars],
                                      self.config.cat_remain_numeric)
            for c, d, n in convert2cat_vars:
                st = col_stats[c]
                # SafeLabelEncoder.fit sees the raw column pre-imputation:
                # NaNs become the string 'nan'
                classes = _str_classes(st, ('nan',) if st.has_nan else ())
                le = tx.SafeLabelEncoder.from_classes(classes)
                ce.encoders[c] = le
                if self.config.cat_remain_numeric:
                    ce.new_columns.append(
                        (f'{c}_cat', 'int32', len(classes)))
            self.X_transformers['categorize'] = ce
            if self.config.cat_remain_numeric:
                cat_vars = cat_vars + ce.new_columns
                num_vars = num_vars + convert2cat_vars
            else:
                cat_vars = cat_vars + convert2cat_vars

        self._append_categorical_cols(
            [(c[0], c[2] + 2) for c in cat_vars])
        self._append_continuous_cols(
            [c[0] for c in num_vars], consts.INPUT_PREFIX_NUM + 'all')

        continuous_vars = self.get_continuous_columns()
        categorical_vars = self.get_categorical_columns()
        var_len_vars = self.get_var_len_categorical_columns()
        twin_names = {name for name, _d, _n in
                      (ce.new_columns if convert2cat_vars
                       and self.config.cat_remain_numeric else [])}

        def _wants_string_fill(c):
            if c in twin_names:
                return False  # label codes from CategorizeEncoder
            # per-chunk actual-dtype bit recorded by ColumnStats.update —
            # resolved_dtype collapses bool/int-category to 'object', which
            # would give those columns the '' fill here while the in-memory
            # path (_imputation) gives them the numeric fill
            return col_stats[c].wants_string_fill

        # --- imputation (mirror _imputation; exact means) -----------------
        if self.config.auto_imputation:
            obj_cats, num_cats = [], []
            for c in categorical_vars + var_len_vars:
                (obj_cats if _wants_string_fill(c)
                 else num_cats).append(c)
            means = {c: col_stats[c].mean for c in continuous_vars}
            self.X_transformers['imputation'] = tx.FixedImputer(
                means, obj_cats, num_cats)

        # --- min-max scale (mirror _standard_scale) -----------------------
        if self.config.auto_scale:
            ss = tx.MinMaxScalerTransformer(continuous_vars)
            for c in continuous_vars:
                st = col_stats[c]
                mn, mx = st.min_, st.max_
                ss.min_[c] = mn
                rng = mx - mn
                ss.scale_[c] = 1.0 / rng if rng > 0 else 0.0
            self.X_transformers['standard_scale'] = ss

        # --- categorical label encoding (mirror _categorical_encoding) ----
        if self.config.auto_encode_label:
            mle = tx.MultiLabelEncoder(categorical_vars)
            for c in categorical_vars:
                if c in twin_names:
                    # twin holds codes 0..K-1 (all observed)
                    k = next(n for name, _d, n in ce.new_columns
                             if name == c)
                    classes = sorted(str(i) for i in range(k))
                else:
                    st = col_stats[c]
                    if _is_categorical_dtype(st.resolved_dtype):
                        extra = ('',) if (st.has_nan and
                                          self.config.auto_imputation) \
                            else ('nan',) if st.has_nan else ()
                    else:
                        fill = 0.0 if st.resolved_dtype == 'float64' else 0
                        extra = (str(fill),) if (st.has_nan and
                                                 self.config.auto_imputation) \
                            else ('nan',) if st.has_nan else ()
                    classes = _str_classes(st, extra)
                mle.encoders[c] = tx.SafeLabelEncoder.from_classes(classes)
            self.X_transformers['label_encoder'] = mle

        # --- quantile discretization (mirror _discretization) -------------
        if self.config.auto_discrete:
            mkbd = tx.MultiKBinsDiscretizer(continuous_vars)
            for c in continuous_vars:
                st = col_stats[c]
                if st.vc_overflow:
                    logger.warning(f'column [{c}]: > vc_cap distinct values;'
                                   f' quantile bins are sketch-based.')
                impute_value = st.mean if self.config.auto_imputation else 0.0
                scale = None
                if self.config.auto_scale:
                    rng = st.max_ - st.min_
                    # quantile_distribution applies the scale to the whole
                    # distribution including the imputed mass — pass raw mean
                    scale = (st.min_, 1.0 / rng if rng > 0 else 0.0)
                values, counts = st.quantile_distribution(
                    impute_value=impute_value if st.has_nan else None,
                    scale=scale)
                n_bins = min(mkbd.bins, max(len(values), 2))
                edges = tx.quantile_bin_edges(values, counts, n_bins)
                kbd = tx.FixedBinsDiscretizer(edges)
                new_name = f'{c}_discrete'
                mkbd.discretizers[c] = kbd
                mkbd.new_columns.append((c, new_name, int(kbd.n_bins_[0])))
            self._append_categorical_cols(
                [(new_name, bins + 1) for _n, new_name, bins in
                 mkbd.new_columns])
            self.X_transformers['discreter'] = mkbd

        # --- var-len encoding (mirror _var_len_encoder) -------------------
        if var_len_cols:
            transformer = tx.MultiVarLenFeatureEncoder(var_len_cols)
            for name, sep in transformer.specs:
                st = col_stats[name]
                enc = tx.VarLenFeatureEncoder.from_vocab(
                    st.tokens or (), st.max_token_len, sep)
                transformer.encoders[name] = enc
                transformer.max_length_[name] = enc.max_element_length
            for col in self.var_len_categorical_columns:
                col.max_elements_length = transformer.max_length_[col.name]
            self.X_transformers['var_len_encoder'] = transformer

        self.X_transformers['last'] = tx.PassThroughEstimator()
        logger.info(f'fit_from_stats: {len(categorical_vars)} categorical, '
                    f'{len(continuous_vars)} continuous, '
                    f'{len(var_len_vars)} var-len columns over {n_rows} rows')
        return self

    def fit_transform_y(self, y):
        if self.config.task == consts.TASK_AUTO:
            self.task_, self.labels_ = infer_task_type(y)
        else:
            self.task_ = self.config.task
            self.labels_ = None

        if self.task_ in (consts.TASK_BINARY, consts.TASK_MULTICLASS):
            self.y_label_encoder = tx.LabelEncoder()
            y = self.y_label_encoder.fit_transform(y)
            self.labels_ = self.y_label_encoder.classes_
        elif self.task_ == consts.TASK_MULTILABEL:
            self.labels_ = list(range(np.shape(y)[-1]))
        else:
            self.labels_ = []
        return np.asarray(y)

    def _cast(self, X):
        """Categorical columns to int32, continuous ones to float64."""
        for c in self.get_categorical_columns():
            X[c] = np.asarray(X[c]).astype(np.int32)
        for c in self.get_continuous_columns():
            X[c] = np.asarray(X[c]).astype(np.float64)

    def transform(self, X, y, copy_data=True):
        frame = cl.is_frame(X)
        X_t = self._transform_X(X)
        y_t = self.transform_y(y, copy_data)
        self._cast(X_t)
        return (cl.to_frame(X_t) if frame else X_t), y_t

    def transform_y(self, y, copy_data=True):
        logger.info('Transform [y]...')
        start = time.time()
        if copy_data:
            y = copy.deepcopy(y)
        if self.y_label_encoder is not None:
            y = self.y_label_encoder.transform(y)
        logger.info(f'transform_y taken {time.time() - start}s')
        return np.asarray(y)

    def transform_X(self, X, copy_data=True):
        frame = cl.is_frame(X)
        X = self._transform_X(X)
        return cl.to_frame(X) if frame else X

    def _transform_X(self, X):
        start = time.time()
        logger.info('Transform [X]...')
        X = self._prepare_X(X)
        for step in self.X_transformers.values():
            X = step.transform(X)
        logger.info(f'transform_X taken {time.time() - start}s')
        return X

    def inverse_transform_y(self, y_indicator):
        if self.y_label_encoder is not None:
            return self.y_label_encoder.inverse_transform(y_indicator)
        return y_indicator

    # -- stages ------------------------------------------------------------
    def _prepare_features(self, X):
        start = time.time()
        logger.info('Preparing features...')
        num_vars = []
        convert2cat_vars = []
        cat_vars = []
        excluded_vars = []

        if self.config.cat_exponent >= 1:
            raise ValueError(
                f'"cat_exponent" must be less than 1, '
                f'not {self.config.cat_exponent} .')

        var_len_cols = self.config.var_len_categorical_columns
        var_len_column_names = []
        if var_len_cols is not None and len(var_len_cols) > 0:
            for v in var_len_cols:
                if not isinstance(v, (tuple, list)) or len(v) != 3:
                    raise ValueError(
                        'Var len column config should be a tuple 3.')
                var_len_column_names.append(v[0])
            var_len_spec = {v[0]: (v[1], v[2]) for v in var_len_cols}
        else:
            var_len_spec = {}

        X_shape = np.shape(X)
        unique_upper_limit = round(X_shape[0] ** self.config.cat_exponent)
        for c in X.columns:
            nunique = cl.nunique(X[c])
            dtype = X.kinds[c]

            if nunique <= 1 and self.config.auto_discard_unique:
                continue
            if c in (self.config.exclude_columns or ()):
                excluded_vars.append((c, dtype, nunique))
                continue
            if c in var_len_column_names:
                sep, pooling = var_len_spec[c]
                self._append_var_len_categorical_col(c, nunique, sep, pooling)
                continue

            if isinstance(self.config.categorical_columns, list):
                if c in self.config.categorical_columns:
                    cat_vars.append((c, dtype, nunique))
                else:
                    if not _is_categorical_dtype(dtype):
                        num_vars.append((c, dtype, nunique))
                    else:
                        logger.info(
                            f'Column [{c}] has been discarded. It is not '
                            f'numeric and not in [config.categorical_columns].')
            else:
                if _is_categorical_dtype(dtype):
                    cat_vars.append((c, dtype, nunique))
                elif self.config.auto_categorize \
                        and nunique < unique_upper_limit:
                    convert2cat_vars.append((c, dtype, nunique))
                else:
                    num_vars.append((c, dtype, nunique))

        if len(convert2cat_vars) > 0:
            cat_columns = [c for c, d, n in convert2cat_vars]
            ce = tx.CategorizeEncoder(cat_columns,
                                      self.config.cat_remain_numeric)
            X = ce.fit_transform(X)
            self.X_transformers['categorize'] = ce
            if self.config.cat_remain_numeric:
                cat_vars = cat_vars + ce.new_columns
                num_vars = num_vars + convert2cat_vars
            else:
                cat_vars = cat_vars + convert2cat_vars

        logger.debug(
            f'{len(cat_vars)} categorical variables and {len(num_vars)} '
            f'continuous variables found. {len(convert2cat_vars)} of them '
            f'are from continuous to categorical.')
        self._append_categorical_cols([(c[0], c[2] + 2) for c in cat_vars])
        self._append_continuous_cols([c[0] for c in num_vars],
                                      consts.INPUT_PREFIX_NUM + 'all')
        logger.info(f'Preparing features taken {time.time() - start}s')
        return X

    def _imputation(self, X):
        start = time.time()
        logger.info('Data imputation...')
        continuous_vars = self.get_continuous_columns()
        categorical_vars = self.get_categorical_columns()
        var_len_vars = self.get_var_len_categorical_columns()

        obj_cats, num_cats = [], []
        for c in categorical_vars + var_len_vars:
            if _imputer_wants_string_fill(X.kinds[c]):
                obj_cats.append(c)
            else:
                num_cats.append(c)

        ct = tx.build_imputation_transformer(continuous_vars, obj_cats,
                                             num_cats)
        columns = continuous_vars + obj_cats + num_cats
        dfwrapper = tx.DataFrameWrapper(ct, columns=columns)
        X = dfwrapper.fit_transform(X)
        self.X_transformers['imputation'] = dfwrapper
        logger.info(f'Imputation taken {time.time() - start}s')
        return X

    def _categorical_encoding(self, X):
        start = time.time()
        logger.info('Categorical encoding...')
        mle = tx.MultiLabelEncoder(self.get_categorical_columns())
        X = mle.fit_transform(X)
        self.X_transformers['label_encoder'] = mle
        logger.info(f'Categorical encoding taken {time.time() - start}s')
        return X

    def _standard_scale(self, X):
        start = time.time()
        logger.info('Standard scale...')
        ss = tx.MinMaxScalerTransformer(self.get_continuous_columns())
        X = ss.fit_transform(X)
        self.X_transformers['standard_scale'] = ss
        logger.info(f'Standard scale taken {time.time() - start}s')
        return X

    def _discretization(self, X):
        start = time.time()
        logger.info('Data discretization...')
        mkbd = tx.MultiKBinsDiscretizer(self.get_continuous_columns())
        X = mkbd.fit_transform(X)
        self._append_categorical_cols(
            [(new_name, bins + 1) for name, new_name, bins in
             mkbd.new_columns])
        self.X_transformers['discreter'] = mkbd
        logger.info(f'Discretization taken {time.time() - start}s')
        return X

    def _var_len_encoder(self, X, var_len_categorical_columns):
        start = time.time()
        logger.info('Encoding var-len features...')
        transformer = tx.MultiVarLenFeatureEncoder(var_len_categorical_columns)
        X = transformer.fit_transform(X)
        for c in self.var_len_categorical_columns:
            c.max_elements_length = transformer.max_length_[c.name]
        self.X_transformers['var_len_encoder'] = transformer
        logger.info(f'Encoder taken {time.time() - start}s')
        return X

    def _apply_gbm_features(self, X, y):
        start = time.time()
        logger.info('Extracting GBM features...')
        gbmencoder = tx.GbmLeavesEncoder(self.get_categorical_columns(),
                                         self.get_continuous_columns(),
                                         self.task_,
                                         **self.config.gbm_params)
        X = gbmencoder.fit_transform(X, y)
        self.X_transformers['gbm_features'] = gbmencoder
        if self.config.gbm_feature_type == consts.GBM_FEATURE_TYPE_EMB:
            self._append_categorical_cols(
                [(name, int(X[name].max()) + 2)
                 for name in gbmencoder.new_columns])
        else:
            self._append_continuous_cols(
                gbmencoder.new_columns,
                consts.INPUT_PREFIX_NUM + 'gbm_leaves')
        logger.info(f'Extracting gbm features taken {time.time() - start}s')
        return X

    # -- column bookkeeping ------------------------------------------------
    def _embedding_output_dim(self, voc_size):
        if self.config.fixed_embedding_dim:
            dim = self.config.embeddings_output_dim
            return dim if dim > 0 else consts.EMBEDDING_OUT_DIM_DEFAULT
        return min(4 * int(pow(voc_size, 0.25)), 20)

    def _append_var_len_categorical_col(self, name, voc_size, sep, pooling):
        logger.debug(f'Var len categorical variable {name} appended.')
        if self.var_len_categorical_columns is None:
            self.var_len_categorical_columns = []
        vc = VarLenCategoricalColumn(
            name, voc_size + 2, self._embedding_output_dim(voc_size),
            sep=sep, pooling_strategy=pooling or 'max')
        self.var_len_categorical_columns.append(vc)

    def _append_categorical_cols(self, cols):
        logger.debug(f'{len(cols)} categorical variables appended.')
        if self.categorical_columns is None:
            self.categorical_columns = []
        if cols:
            self.categorical_columns = self.categorical_columns + [
                CategoricalColumn(name, voc_size,
                                  self._embedding_output_dim(voc_size))
                for name, voc_size in cols]

    def _append_continuous_cols(self, cols, input_name):
        if self.continuous_columns is None:
            self.continuous_columns = []
        if cols:
            self.continuous_columns = self.continuous_columns + [
                ContinuousColumn(name=input_name,
                                 column_names=[c for c in cols])]

    def get_categorical_columns(self):
        return [c.name for c in (self.categorical_columns or [])]

    def get_var_len_categorical_columns(self):
        return [c.name for c in (self.var_len_categorical_columns or [])]

    def get_continuous_columns(self):
        cont_vars = []
        for c in (self.continuous_columns or []):
            cont_vars = cont_vars + c.column_names
        return cont_vars
