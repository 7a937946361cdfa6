# -*- coding:utf-8 -*-
"""Gradient boosting with scikit-learn 1.9.0's exact trees, without
scikit-learn: ``GradientBoostingClassifier`` and
``GradientBoostingRegressor`` with every option of their constructors,
``fit`` and ``apply`` (the two calls that ``transformers.GbmLeavesEncoder``
makes).

This is a copy of ``sklearn/ensemble/_gb.py`` at 1.9.0 over
``csrc/gbm_tree.cpp``, which grows each stage's
``DecisionTreeRegressor(criterion="squared_error", splitter="best")`` line
for line as scikit-learn's Cython does: the same sort, the same order of
sums, the same random feature draws, and prunes it as ``_prune_tree`` does
(``ccp_alpha``). Given the same inputs and ``random_state``, the trees
(children, features, thresholds) are the same bit for bit and ``apply``
gives the same leaves.

The losses: ``log_loss`` and ``exponential`` (binary) for the classifier;
``squared_error``, ``absolute_error``, ``huber`` and ``quantile`` (with
``alpha``) for the regressor. The numpy steps are the ones scikit-learn
takes (the prior through the loss's link, ``np.average`` and
``_weighted_percentile`` in the leaves' line search, the Huber delta of
each stage); the per-sample loops that scikit-learn runs in C (the
losses and their gradients with the C library's ``exp`` and ``log``,
``scipy.special.logit``, the subsample mask) run in the native library too.
``init`` ('zero', or an estimator with ``fit`` and ``predict_proba`` or
``predict``), ``min_weight_fraction_leaf``, early stopping
(``n_iter_no_change``, ``validation_fraction``, ``tol``: the split of
``train_test_split``, ``data/split.py``), ``warm_start``, ``verbose`` (the
lines of ``VerboseReporter``) and ``criterion`` (its ``FutureWarning``)
follow ``_gb.py``.

The native library is built with the host compiler at first use
(``ops/kernels/_build.py``); a failed build raises with the compiler's
message.
"""

import ctypes
import math
import numbers
import subprocess
import threading
import warnings
from time import time

import numpy as np

from ..data import split as split_lib
from ..ops.kernels import _build

SOURCE = _build.CSRC_DIR / 'gbm_tree.cpp'
# no fused multiply-add: each product and sum rounds as in scikit-learn's C
CXX_FLAGS = _build.HOST_CXX_FLAGS + ('-ffp-contract=off',)
RAND_R_MAX = 2147483647
TREE_LEAF = -1
LOSS_BINOMIAL, LOSS_MULTINOMIAL, LOSS_EXPONENTIAL = 0, 1, 2

_lib = None
_lib_lock = threading.Lock()

_i64 = ctypes.POINTER(ctypes.c_int64)
_f64 = ctypes.POINTER(ctypes.c_double)
_f32 = ctypes.POINTER(ctypes.c_float)
_u8 = ctypes.POINTER(ctypes.c_uint8)
_TREE_ARRAYS = (_i64, _i64, _i64, _f64, _u8, _f64, _f64, _f64)


def get_library():
    """The loaded native library, built at first use."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            path = _build.build_host_library(SOURCE, CXX_FLAGS)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f'building {SOURCE.name} failed:\n'
                               f'{e.stderr}') from e
        lib = ctypes.CDLL(str(path))
        lib.gbm_tree_fit.restype = ctypes.c_int64
        lib.gbm_tree_fit.argtypes = [
            _f32, ctypes.c_int64, ctypes.c_int64, _f64, _f64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_uint32,
            ctypes.c_int64, *_TREE_ARRAYS]
        lib.gbm_tree_prune.restype = ctypes.c_int64
        lib.gbm_tree_prune.argtypes = [ctypes.c_int64, *_TREE_ARRAYS,
                                       ctypes.c_double, *_TREE_ARRAYS]
        lib.gbm_tree_apply.restype = None
        lib.gbm_tree_apply.argtypes = [
            _f32, ctypes.c_int64, ctypes.c_int64, _i64, _i64, _i64, _f64,
            _u8, _i64]
        for name in ('gbm_neg_gradient_binomial',
                     'gbm_neg_gradient_exponential'):
            getattr(lib, name).restype = None
            getattr(lib, name).argtypes = [_f64, _f64, ctypes.c_int64, _f64]
        lib.gbm_neg_gradient_multinomial.restype = None
        lib.gbm_neg_gradient_multinomial.argtypes = [
            _f64, _f64, ctypes.c_int64, ctypes.c_int64, _f64]
        lib.gbm_loss.restype = None
        lib.gbm_loss.argtypes = [ctypes.c_int64, _f64, _f64, ctypes.c_int64,
                                 ctypes.c_int64, _f64]
        lib.gbm_logit.restype = None
        lib.gbm_logit.argtypes = [_f64, ctypes.c_int64, _f64]
        lib.gbm_sample_mask.restype = None
        lib.gbm_sample_mask.argtypes = [_f64, ctypes.c_int64, ctypes.c_int64,
                                        _u8]
        _lib = lib
        return _lib


def _ptr(a, kind):
    return a.ctypes.data_as(kind)


def _float32_rows(X):
    """``X`` as scikit-learn's ``validate_data(dtype=np.float32)`` makes it:
    a 2-D float32 array of finite values (C order here)."""
    X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
    if X.ndim != 2:
        raise ValueError(f'Expected a 2D array, got shape {X.shape}.')
    if not np.isfinite(X).all():
        raise ValueError('Input X contains NaN or infinity; gradient '
                         'boosting does not take missing values.')
    return X


class Tree:
    """One fitted regression tree: scikit-learn's ``Tree`` arrays (node
    ids in the order scikit-learn adds the nodes; leaves have children -1,
    feature -2 and threshold -2.0), ``value`` of shape (node_count,), and
    each node's ``impurity`` and ``weighted_n_node_samples``."""

    FIELDS = ('children_left', 'children_right', 'feature', 'threshold',
              'missing_go_to_left', 'value', 'impurity',
              'weighted_n_node_samples')
    DTYPES = (np.int64, np.int64, np.int64, np.float64, np.uint8,
              np.float64, np.float64, np.float64)

    def __init__(self, children_left, children_right, feature, threshold,
                 missing_go_to_left, value, impurity,
                 weighted_n_node_samples):
        self.children_left = children_left
        self.children_right = children_right
        self.feature = feature
        self.threshold = threshold
        self.missing_go_to_left = missing_go_to_left
        self.value = value
        self.impurity = impurity
        self.weighted_n_node_samples = weighted_n_node_samples

    @property
    def node_count(self):
        return len(self.children_left)

    @classmethod
    def _empty(cls, capacity):
        return {name: np.empty(capacity, dtype)
                for name, dtype in zip(cls.FIELDS, cls.DTYPES)}

    @classmethod
    def _pointers(cls, arrays):
        return [_ptr(arrays[name], kind)
                for name, kind in zip(cls.FIELDS, _TREE_ARRAYS)]

    @classmethod
    def fit(cls, X, y, sample_weight, *, max_features, min_samples_split,
            min_samples_leaf, min_weight_leaf, max_depth, max_leaf_nodes,
            min_impurity_decrease, ccp_alpha, seed):
        """Grow a tree on float32 ``X`` (C order) against float64 ``y``
        (``DepthFirstTreeBuilder``, or ``BestFirstTreeBuilder`` when
        ``max_leaf_nodes`` >= 0), then prune it at ``ccp_alpha`` > 0."""
        lib = get_library()
        n, d = X.shape
        y = np.ascontiguousarray(y, dtype=np.float64)
        sample_weight = np.ascontiguousarray(sample_weight, dtype=np.float64)
        capacity = max(2 * n - 1, 1)
        if max_depth < 62:
            capacity = min(capacity, 2 ** (max_depth + 1) - 1)
        if max_leaf_nodes >= 0:
            capacity = min(capacity, max(2 * max_leaf_nodes - 1, 1))
        arrays = cls._empty(capacity)
        count = lib.gbm_tree_fit(
            _ptr(X, _f32), n, d, _ptr(y, _f64), _ptr(sample_weight, _f64),
            max_features, min_samples_split, min_samples_leaf,
            min_weight_leaf, max_depth, max_leaf_nodes,
            min_impurity_decrease, seed, capacity, *cls._pointers(arrays))
        if count < 0:
            raise RuntimeError(f'the tree outgrew its {capacity} nodes')
        tree = cls(**{k: v[:count].copy() for k, v in arrays.items()})
        return tree._prune(ccp_alpha) if ccp_alpha != 0.0 else tree

    def _prune(self, ccp_alpha):
        """``DecisionTreeRegressor._prune_tree``: minimal cost-complexity
        pruning, the pruned tree's nodes renumbered depth first."""
        arrays = {name: np.ascontiguousarray(getattr(self, name))
                  for name in self.FIELDS}
        out = self._empty(self.node_count)
        count = get_library().gbm_tree_prune(
            self.node_count, *self._pointers(arrays), float(ccp_alpha),
            *self._pointers(out))
        if count < 0:
            raise RuntimeError('pruning the tree failed')
        return type(self)(**{k: v[:count].copy() for k, v in out.items()})

    def apply(self, X):
        """The leaf (node id) each row of float32 ``X`` (C order) reaches."""
        lib = get_library()
        out = np.empty(X.shape[0], np.int64)
        lib.gbm_tree_apply(
            _ptr(X, _f32), X.shape[0], X.shape[1],
            _ptr(self.children_left, _i64), _ptr(self.children_right, _i64),
            _ptr(self.feature, _i64), _ptr(self.threshold, _f64),
            _ptr(self.missing_go_to_left, _u8), _ptr(out, _i64))
        return out


def _safe_divide(numerator, denominator):
    if abs(denominator) < 1e-150:
        return 0.0
    result = float(numerator) / float(denominator)
    if math.isinf(result):
        warnings.warn('overflow encountered in _safe_divide', RuntimeWarning)
    return result


def _logit(p):
    """``scipy.special.logit`` of an array (the native library's copy of
    xsf's: the C library's ``log`` away from 1/2, ``log1p`` near it)."""
    p = np.ascontiguousarray(p, dtype=np.float64)
    out = np.empty_like(p)
    get_library().gbm_logit(_ptr(p, _f64), p.size, _ptr(out, _f64))
    return out


def _native_loss(kind, y, raw):
    y = np.ascontiguousarray(y, dtype=np.float64)
    raw = np.ascontiguousarray(raw, dtype=np.float64)
    out = np.empty(len(y))
    n_classes = raw.shape[1] if raw.ndim == 2 else 1
    get_library().gbm_loss(kind, _ptr(y, _f64), _ptr(raw, _f64), len(y),
                           n_classes, _ptr(out, _f64))
    return out


def _weighted_percentile(array, sample_weight, percentile_rank=50):
    """``sklearn.utils.stats._weighted_percentile`` of a 1-D array at one
    rank (``average=False``: numpy's ``inverted_cdf``)."""
    array = np.asarray(array, dtype=np.float64)
    sample_weight = np.asarray(sample_weight, dtype=np.float64)
    percentile_rank = np.asarray(percentile_rank, dtype=np.float64)
    if np.all(sample_weight == 0):
        return np.nan
    array = array.reshape(-1, 1)
    sample_weight = sample_weight.reshape(-1, 1)
    sorted_idx = np.argsort(array, axis=0)
    sorted_weights = np.take_along_axis(sample_weight, sorted_idx, axis=0)
    if np.isnan(array[sorted_idx[-1, 0], 0]):
        sorted_nan_mask = np.take_along_axis(np.isnan(array), sorted_idx,
                                             axis=0)
        sorted_weights[sorted_nan_mask] = 0
    weight_cdf = np.cumsum(sorted_weights.T, axis=1)
    adjusted = percentile_rank / 100 * weight_cdf[..., -1]
    mask = adjusted == 0
    adjusted[mask] = np.nextafter(adjusted[mask], adjusted[mask] + 1)
    index = np.searchsorted(weight_cdf[0], adjusted[0])
    index = np.clip(index, 0, sorted_idx.shape[0] - 1)
    return array[sorted_idx[index, 0], 0]


def _random_state(seed):
    """``sklearn.utils.check_random_state``."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f'{seed!r} cannot be used to seed a '
                     f'numpy.random.RandomState instance')


# -- the init estimators of _init_state (DummyClassifier, DummyRegressor) --

class _PriorClassifier:
    """``DummyClassifier(strategy='prior')``."""

    def fit(self, X, y):
        _, y_k = np.unique(np.reshape(y, (-1, 1))[:, 0], return_inverse=True)
        counts = np.bincount(y_k, weights=None)
        self.class_prior_ = counts / counts.sum()
        return self

    def predict_proba(self, X):
        return np.ones((len(X), 1)) * self.class_prior_


class _ConstantRegressor:
    """``DummyRegressor`` with ``strategy='mean'``, or ``'quantile'`` at
    ``quantile``."""

    def __init__(self, quantile=None):
        self.quantile = quantile

    def fit(self, X, y):
        y = np.reshape(y, (-1, 1))
        if self.quantile is None:
            self.constant_ = np.average(y, axis=0)
        else:
            self.constant_ = np.percentile(y, axis=0,
                                           q=self.quantile * 100.0)
        return self

    def predict(self, X):
        y = np.full((len(X), 1), self.constant_,
                    dtype=np.array(self.constant_).dtype)
        return np.ravel(y)


class VerboseReporter:
    """``sklearn/ensemble/_gb.py``'s ``VerboseReporter``: a line for every
    stage (``verbose`` > 1), or for stages 1-10, 20, 30, ..., 100, 200, ...
    (``verbose`` 1)."""

    def __init__(self, verbose):
        self.verbose = verbose

    def init(self, est, begin_at_stage=0):
        header_fields = ['Iter', 'Train Loss']
        verbose_fmt = ['{iter:>10d}', '{train_score:>16.4f}']
        if est.subsample < 1:
            header_fields.append('OOB Improve')
            verbose_fmt.append('{oob_impr:>16.4f}')
        header_fields.append('Remaining Time')
        verbose_fmt.append('{remaining_time:>16s}')
        print(('%10s ' + '%16s ' * (len(header_fields) - 1))
              % tuple(header_fields))
        self.verbose_fmt = ' '.join(verbose_fmt)
        self.verbose_mod = 1
        self.start_time = time()
        self.begin_at_stage = begin_at_stage

    def update(self, j, est):
        do_oob = est.subsample < 1
        i = j - self.begin_at_stage
        if (i + 1) % self.verbose_mod == 0:
            oob_impr = est.oob_improvement_[j] if do_oob else 0
            remaining_time = ((est.n_estimators - (j + 1))
                              * (time() - self.start_time) / float(i + 1))
            if remaining_time > 60:
                remaining_time = '{0:.2f}m'.format(remaining_time / 60.0)
            else:
                remaining_time = '{0:.2f}s'.format(remaining_time)
            print(self.verbose_fmt.format(
                iter=j + 1, train_score=est.train_score_[j],
                oob_impr=oob_impr, remaining_time=remaining_time))
            if self.verbose == 1 and ((i + 1) // (self.verbose_mod * 10) > 0):
                self.verbose_mod *= 10


_CRITERIA = ('deprecated', 'friedman_mse', 'squared_error')


class _GradientBoosting:
    _LOSSES = ()
    _REGRESSION = False
    _PARAMS = {'loss': None, 'learning_rate': 0.1, 'n_estimators': 100,
               'subsample': 1.0, 'criterion': 'deprecated',
               'min_samples_split': 2, 'min_samples_leaf': 1,
               'min_weight_fraction_leaf': 0.0, 'max_depth': 3,
               'min_impurity_decrease': 0.0, 'init': None,
               'random_state': None, 'max_features': None, 'verbose': 0,
               'max_leaf_nodes': None, 'warm_start': False,
               'validation_fraction': 0.1, 'n_iter_no_change': None,
               'tol': 1e-4, 'ccp_alpha': 0.0}

    def __init__(self, **params):
        for name in params:
            if name not in self._PARAMS:
                raise TypeError(f'{type(self).__name__}.__init__() got an '
                                f'unexpected keyword argument {name!r}')
        for name, default in self._PARAMS.items():
            setattr(self, name, params.get(name, default))
        if self.loss is None:
            self.loss = self._LOSSES[0]
        if self.loss not in self._LOSSES:
            raise ValueError(f'The loss parameter of {type(self).__name__} '
                             f'must be one of {list(self._LOSSES)}; got '
                             f'{self.loss!r}.')
        if self.criterion not in _CRITERIA:
            raise ValueError(f"The 'criterion' parameter must be "
                             f"'squared_error'; got {self.criterion!r}.")
        if not 0.0 < self.validation_fraction < 1.0:
            raise ValueError('validation_fraction must be in (0, 1); got '
                             f'{self.validation_fraction!r}.')

    # -- the tree's parameters, as DecisionTreeRegressor._fit derives them
    def _tree_params(self, n_samples, n_features):
        if isinstance(self.min_samples_leaf, numbers.Integral):
            min_samples_leaf = self.min_samples_leaf
        else:
            min_samples_leaf = math.ceil(self.min_samples_leaf * n_samples)
        if isinstance(self.min_samples_split, numbers.Integral):
            min_samples_split = self.min_samples_split
        else:
            min_samples_split = max(
                2, math.ceil(self.min_samples_split * n_samples))
        min_samples_split = max(min_samples_split, 2 * min_samples_leaf)
        mf = self.max_features
        if isinstance(mf, str):
            if mf == 'sqrt':
                max_features = max(1, int(np.sqrt(n_features)))
            elif mf == 'log2':
                max_features = max(1, int(np.log2(n_features)))
            else:
                raise ValueError(f'max_features={mf!r}')
        elif mf is None:
            max_features = n_features
        elif isinstance(mf, numbers.Integral):
            max_features = mf
        else:
            max_features = max(1, int(mf * n_features)) if mf > 0.0 else 0
        return dict(
            max_features=max_features, min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            max_depth=(np.iinfo(np.int32).max if self.max_depth is None
                       else self.max_depth),
            max_leaf_nodes=(-1 if self.max_leaf_nodes is None
                            else self.max_leaf_nodes),
            min_impurity_decrease=self.min_impurity_decrease,
            ccp_alpha=self.ccp_alpha)

    # -- state: _init_state, _clear_state, _resize_state, _is_fitted
    def _init_state(self):
        self.init_ = self.init
        if self.init_ is None:
            self.init_ = self._default_init()
        self.estimators_ = np.empty(
            (self.n_estimators, self.n_trees_per_iteration_), dtype=object)
        self.train_score_ = np.zeros((self.n_estimators,), dtype=np.float64)
        if self.subsample < 1.0:
            self.oob_improvement_ = np.zeros((self.n_estimators),
                                             dtype=np.float64)
            self.oob_scores_ = np.zeros((self.n_estimators), dtype=np.float64)
            self.oob_score_ = np.nan

    def _clear_state(self):
        if hasattr(self, 'estimators_'):
            self.estimators_ = np.empty((0, 0), dtype=object)
        for name in ('train_score_', 'oob_improvement_', 'oob_scores_',
                     'oob_score_', 'init_', '_rng'):
            if hasattr(self, name):
                delattr(self, name)

    def _resize_state(self):
        total_n_estimators = self.n_estimators
        self.estimators_ = np.resize(
            self.estimators_, (total_n_estimators,
                               self.n_trees_per_iteration_))
        self.train_score_ = np.resize(self.train_score_, total_n_estimators)
        if self.subsample < 1 or hasattr(self, 'oob_improvement_'):
            if hasattr(self, 'oob_improvement_'):
                self.oob_improvement_ = np.resize(self.oob_improvement_,
                                                  total_n_estimators)
                self.oob_scores_ = np.resize(self.oob_scores_,
                                             total_n_estimators)
                self.oob_score_ = np.nan
            else:
                self.oob_improvement_ = np.zeros((total_n_estimators,),
                                                 dtype=np.float64)
                self.oob_scores_ = np.zeros((total_n_estimators,),
                                            dtype=np.float64)
                self.oob_score_ = np.nan

    def _is_fitted(self):
        return len(getattr(self, 'estimators_', [])) > 0

    # -- fit
    def fit(self, X, y):
        if not self.warm_start:
            self._clear_state()
        if self.criterion != 'deprecated':
            warnings.warn(
                'The parameter `criterion` is deprecated and will be '
                'removed in 1.11. It has no effect. Leave it to its default '
                'value to avoid this warning.', FutureWarning)
        X = _float32_rows(X)
        n_samples, self.n_features_in_ = X.shape
        y = self._encode_y(np.asarray(y).reshape(-1))
        if len(y) != n_samples:
            raise ValueError(f'{len(y)} labels for {n_samples} samples')
        sample_weight = np.ones(n_samples, dtype=np.float64)
        self._check_loss()
        self._huber_delta = 0.5  # HuberLoss's delta until the first stage
        if self.n_iter_no_change is not None:
            stratify = None if self._REGRESSION else y
            train, val = split_lib.split_indices(
                n_samples, self.validation_fraction,
                _random_state(self.random_state), stratify)
            X_train, X_val = X[train], X[val]
            y_train, y_val = y[train], y[val]
            sample_weight_train = sample_weight[train]
            sample_weight_val = sample_weight[val]
            if not self._REGRESSION and \
                    self.n_classes_ != np.unique(y_train).shape[0]:
                raise ValueError('The training data after the early stopping '
                                 'split is missing some classes. Try using '
                                 'another random seed.')
        else:
            X_train, y_train, sample_weight_train = X, y, sample_weight
            X_val = y_val = sample_weight_val = None

        if not self._is_fitted():
            self._init_state()
            if isinstance(self.init_, str) and self.init_ == 'zero':
                raw_predictions = np.zeros(
                    shape=(X_train.shape[0], self.n_trees_per_iteration_),
                    dtype=np.float64)
            else:
                self.init_.fit(X_train, y_train)
                raw_predictions = self._init_raw_predictions(X_train,
                                                             self.init_)
            begin_at_stage = 0
            self._rng = _random_state(self.random_state)
        else:
            if self.n_estimators < self.estimators_.shape[0]:
                raise ValueError(
                    'n_estimators=%d must be larger or equal to '
                    'estimators_.shape[0]=%d when warm_start==True'
                    % (self.n_estimators, self.estimators_.shape[0]))
            begin_at_stage = self.estimators_.shape[0]
            raw_predictions = self._raw_predict(X_train)
            self._resize_state()

        n_stages = self._fit_stages(
            X_train, y_train, raw_predictions, sample_weight_train,
            self._rng, X_val, y_val, sample_weight_val, begin_at_stage)
        if n_stages != self.estimators_.shape[0]:
            self.estimators_ = self.estimators_[:n_stages]
            self.train_score_ = self.train_score_[:n_stages]
            if hasattr(self, 'oob_improvement_'):
                self.oob_improvement_ = self.oob_improvement_[:n_stages]
                self.oob_scores_ = self.oob_scores_[:n_stages]
                self.oob_score_ = self.oob_scores_[-1]
        self.n_estimators_ = n_stages
        return self

    def _fit_stages(self, X, y, raw_predictions, sample_weight, random_state,
                    X_val, y_val, sample_weight_val, begin_at_stage=0):
        n_samples = X.shape[0]
        do_oob = self.subsample < 1.0
        sample_mask = np.ones((n_samples,), dtype=bool)
        n_inbag = max(1, int(self.subsample * n_samples))
        lib = get_library()
        if self.verbose:
            verbose_reporter = VerboseReporter(verbose=self.verbose)
            verbose_reporter.init(self, begin_at_stage)
        if self.n_iter_no_change is not None:
            loss_history = np.full(self.n_iter_no_change, np.inf)
            y_val_pred_iter = self._staged_raw_predict(X_val)
        # as scikit-learn keeps them: twice the half losses of squared
        # error and log loss
        factor = 2 if self.loss in ('squared_error', 'log_loss') \
            and (self._REGRESSION or self.n_classes_ == 2) else 1
        i = begin_at_stage
        for i in range(begin_at_stage, self.n_estimators):
            if do_oob:
                draws = np.ascontiguousarray(
                    random_state.uniform(size=n_samples))
                mask = np.empty(n_samples, np.uint8)
                lib.gbm_sample_mask(_ptr(draws, _f64), n_samples, n_inbag,
                                    _ptr(mask, _u8))
                sample_mask = mask.view(bool)
                y_oob_masked = y[~sample_mask]
                sample_weight_oob_masked = sample_weight[~sample_mask]
                if i == 0:
                    initial_loss = factor * self._mean_loss(
                        y_oob_masked, raw_predictions[~sample_mask],
                        sample_weight_oob_masked)
            raw_predictions = self._fit_stage(i, X, y, raw_predictions,
                                              sample_weight, sample_mask,
                                              random_state)
            if do_oob:
                self.train_score_[i] = factor * self._mean_loss(
                    y[sample_mask], raw_predictions[sample_mask],
                    sample_weight[sample_mask])
                self.oob_scores_[i] = factor * self._mean_loss(
                    y_oob_masked, raw_predictions[~sample_mask],
                    sample_weight_oob_masked)
                previous_loss = initial_loss if i == 0 \
                    else self.oob_scores_[i - 1]
                self.oob_improvement_[i] = previous_loss - self.oob_scores_[i]
                self.oob_score_ = self.oob_scores_[-1]
            else:
                self.train_score_[i] = factor * self._mean_loss(
                    y, raw_predictions, sample_weight)
            if self.verbose > 0:
                verbose_reporter.update(i, self)
            if self.n_iter_no_change is not None:
                validation_loss = factor * self._mean_loss(
                    y_val, next(y_val_pred_iter), sample_weight_val)
                if np.any(validation_loss + self.tol < loss_history):
                    loss_history[i % len(loss_history)] = validation_loss
                else:
                    break
        return i + 1

    def _fit_stage(self, i, X, y, raw_predictions, sample_weight, sample_mask,
                   random_state):
        original_y = y
        if self.loss == 'huber':
            # set_huber_delta: the alpha-quantile of the absolute residuals
            abserr = np.abs(y - raw_predictions.squeeze())
            self._huber_delta = float(_weighted_percentile(
                abserr, sample_weight, 100 * self.alpha))
        neg_gradient = self._neg_gradient(get_library(), y, raw_predictions)
        K = self.n_trees_per_iteration_
        params = self._tree_params(X.shape[0], X.shape[1])
        for k in range(K):
            if K > 1:
                y = np.array(original_y == k, dtype=np.float64)
            if self.subsample < 1.0:
                sample_weight = sample_weight * sample_mask.astype(np.float64)
            min_weight_leaf = self.min_weight_fraction_leaf * \
                np.sum(sample_weight)
            tree = Tree.fit(X, neg_gradient[:, k], sample_weight,
                            min_weight_leaf=min_weight_leaf,
                            seed=random_state.randint(0, RAND_R_MAX),
                            **params)
            self._update_terminal_regions(
                tree, X, y, neg_gradient[:, k], raw_predictions,
                sample_weight, sample_mask, k)
            self.estimators_[i, k] = tree
        return raw_predictions

    def _update_terminal_regions(self, tree, X, y, neg_gradient,
                                 raw_prediction, sample_weight, sample_mask,
                                 k):
        """``sklearn/ensemble/_gb.py`` ``_update_terminal_regions``: the
        leaves' line search, then ``raw_prediction[:, k]``."""
        terminal_regions = tree.apply(X)
        if self.loss != 'squared_error':
            masked = terminal_regions.copy()
            masked[~sample_mask] = -1
            for leaf in np.nonzero(tree.children_left == TREE_LEAF)[0]:
                indices = np.nonzero(masked == leaf)[0]
                y_ = y.take(indices, axis=0)
                sw = sample_weight[indices]
                tree.value[leaf] = self._leaf_update(
                    y_, indices, neg_gradient, raw_prediction, k, sw)
        raw_prediction[:, k] += self.learning_rate * tree.value.take(
            terminal_regions, axis=0)

    # -- prediction: _raw_predict_init, _raw_predict, _staged_raw_predict
    def _init_raw_predictions(self, X, estimator):
        """``_init_raw_predictions``: the init estimator's predictions
        through the loss's link."""
        if not self._REGRESSION:
            predictions = estimator.predict_proba(X)
            if not self._multiclass():
                predictions = predictions[:, 1]
            eps = np.finfo(np.float64).eps
            predictions = np.clip(predictions, eps, 1 - eps,
                                  dtype=np.float64)
        else:
            predictions = estimator.predict(X).astype(np.float64)
        if predictions.ndim == 1:
            return self._link(predictions).reshape(-1, 1)
        return self._link(predictions)

    def _raw_predict_init(self, X):
        if isinstance(self.init_, str) and self.init_ == 'zero':
            return np.zeros(shape=(X.shape[0], self.n_trees_per_iteration_),
                            dtype=np.float64)
        return self._init_raw_predictions(X, self.init_)

    def _predict_stage(self, i, X, raw_predictions):
        for k in range(self.estimators_.shape[1]):
            tree = self.estimators_[i, k]
            raw_predictions[:, k] += self.learning_rate * tree.value.take(
                tree.apply(X), axis=0)

    def _raw_predict(self, X):
        raw_predictions = self._raw_predict_init(X)
        for i in range(self.estimators_.shape[0]):
            self._predict_stage(i, X, raw_predictions)
        return raw_predictions

    def _staged_raw_predict(self, X):
        raw_predictions = self._raw_predict_init(X)
        for i in range(self.estimators_.shape[0]):
            self._predict_stage(i, X, raw_predictions)
            yield raw_predictions.copy()

    def apply(self, X):
        """The leaf of every tree each sample reaches, float64, shaped
        (n_samples, n_estimators, K) (K = 1 for binary and regression)."""
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float32))
        n_estimators, K = self.estimators_.shape
        leaves = np.zeros((X.shape[0], n_estimators, K))
        for i in range(n_estimators):
            for j in range(K):
                leaves[:, i, j] = self.estimators_[i, j].apply(X)
        return leaves


class GradientBoostingClassifier(_GradientBoosting):
    """``sklearn.ensemble.GradientBoostingClassifier``: ``log_loss``, or
    ``exponential`` for two classes."""

    _LOSSES = ('log_loss', 'exponential')

    def _encode_y(self, y):
        self.classes_, encoded = np.unique(y, return_inverse=True)
        n_classes = self.classes_.shape[0]
        self.n_trees_per_iteration_ = 1 if n_classes <= 2 else n_classes
        self.n_classes_ = n_classes
        if n_classes < 2:
            raise ValueError(f'y contains {n_classes} class after '
                             f'sample_weight trimmed classes with zero '
                             f'weights, while a minimum of 2 classes are '
                             f'required.')
        return encoded.reshape(-1).astype(float, copy=False)

    def _check_loss(self):
        if self.loss == 'exponential' and self.n_classes_ > 2:
            raise ValueError(
                f"loss='{self.loss}' is only suitable for a binary "
                f"classification problem, you have n_classes="
                f"{self.n_classes_}. Please use loss='log_loss' instead.")

    def _multiclass(self):
        return self.loss == 'log_loss' and self.n_classes_ > 2

    def _default_init(self):
        return _PriorClassifier()

    def _link(self, predictions):
        """The binomial loss's logit, the exponential loss's half logit, or
        the multinomial's log over the geometric mean (``scipy.stats.gmean``
        at 1.17.0: the exp of the mean of the logs)."""
        if self._multiclass():
            gm = np.exp(np.mean(np.log(predictions), axis=1))
            return np.log(predictions / gm[:, np.newaxis])
        logit = _logit(predictions)
        return 0.5 * logit if self.loss == 'exponential' else logit

    def _neg_gradient(self, lib, y, raw):
        n = len(y)
        out = np.empty_like(raw)
        if self._multiclass():
            raw = np.ascontiguousarray(raw)
            lib.gbm_neg_gradient_multinomial(_ptr(y, _f64), _ptr(raw, _f64),
                                             n, raw.shape[1], _ptr(out, _f64))
            return out
        raw1 = np.ascontiguousarray(raw[:, 0])
        fn = lib.gbm_neg_gradient_exponential if self.loss == 'exponential' \
            else lib.gbm_neg_gradient_binomial
        fn(_ptr(y, _f64), _ptr(raw1, _f64), n, _ptr(out, _f64))
        return out

    def _mean_loss(self, y, raw, sample_weight):
        """``self._loss(y, raw, sample_weight)``: the weighted mean of the
        pointwise loss."""
        if self._multiclass():
            losses = _native_loss(LOSS_MULTINOMIAL, y, raw)
        else:
            kind = LOSS_EXPONENTIAL if self.loss == 'exponential' \
                else LOSS_BINOMIAL
            losses = _native_loss(kind, y, raw.reshape(len(y), -1)[:, 0])
        return np.average(losses, weights=sample_weight)

    def _leaf_update(self, y_, indices, neg_gradient, raw_prediction, k, sw):
        neg_g = neg_gradient.take(indices, axis=0)
        if self.loss == 'exponential':
            numerator = np.average(neg_g, weights=sw)
            hessian = neg_g.copy()
            hessian[y_ == 0] *= -1
            denominator = np.average(hessian, weights=sw)
            return _safe_divide(numerator, denominator)
        prob = y_ - neg_g
        numerator = np.average(neg_g, weights=sw)
        if self._multiclass():
            K = self.n_classes_
            numerator *= (K - 1) / K
        denominator = np.average(prob * (1 - prob), weights=sw)
        return _safe_divide(numerator, denominator)


class GradientBoostingRegressor(_GradientBoosting):
    """``sklearn.ensemble.GradientBoostingRegressor``: ``squared_error``,
    ``absolute_error``, ``huber`` or ``quantile`` (``alpha``)."""

    _LOSSES = ('squared_error', 'absolute_error', 'huber', 'quantile')
    _REGRESSION = True
    _PARAMS = dict(_GradientBoosting._PARAMS, alpha=0.9)

    def __init__(self, **params):
        super().__init__(**params)
        if not 0.0 < self.alpha < 1.0:
            raise ValueError(f'alpha must be in (0, 1); got {self.alpha!r}.')

    def _encode_y(self, y):
        self.n_trees_per_iteration_ = 1
        return y.astype(np.float64, copy=False)

    def _check_loss(self):
        pass

    def _multiclass(self):
        return False

    def _default_init(self):
        if self.loss in ('absolute_error', 'huber'):
            return _ConstantRegressor(quantile=0.5)
        if self.loss == 'quantile':
            return _ConstantRegressor(quantile=self.alpha)
        return _ConstantRegressor()

    def _link(self, predictions):
        return predictions

    def _neg_gradient(self, lib, y, raw):
        raw = raw[:, 0]
        if self.loss == 'squared_error':
            gradient = raw - y
        elif self.loss == 'absolute_error':
            gradient = np.where(raw > y, 1., -1.)
        elif self.loss == 'quantile':
            gradient = np.where(y >= raw, -self.alpha, 1. - self.alpha)
        else:
            res = raw - y
            delta = self._huber_delta
            gradient = np.where(np.abs(res) <= delta, res,
                                np.where(res >= 0, delta, -delta))
        return -gradient.reshape(-1, 1)

    def _mean_loss(self, y, raw, sample_weight):
        raw = raw.reshape(len(y), -1)[:, 0]
        if self.loss == 'squared_error':
            losses = 0.5 * (raw - y) * (raw - y)
        elif self.loss == 'absolute_error':
            losses = np.abs(raw - y)
        elif self.loss == 'quantile':
            q = self.alpha
            losses = np.where(y >= raw, q * (y - raw), (1. - q) * (raw - y))
        else:
            delta = self._huber_delta
            abserr = np.abs(y - raw)
            losses = np.where(abserr <= delta, 0.5 * abserr ** 2,
                              delta * (abserr - 0.5 * delta))
        return np.average(losses, weights=sample_weight)

    def _leaf_update(self, y_, indices, neg_gradient, raw_prediction, k, sw):
        """The loss's ``fit_intercept_only`` on the leaf's residuals."""
        y_true = y_ - raw_prediction[indices, k]
        if self.loss == 'absolute_error':
            return _weighted_percentile(y_true, sw, 50)
        if self.loss == 'quantile':
            return _weighted_percentile(y_true, sw, 100 * self.alpha)
        median = _weighted_percentile(y_true, sw, 50)
        diff = y_true - median
        term = np.sign(diff) * np.minimum(self._huber_delta, np.abs(diff))
        return median + np.average(term, weights=sw)

    def apply(self, X):
        leaves = super().apply(X)
        return leaves.reshape(leaves.shape[0], self.estimators_.shape[0])
