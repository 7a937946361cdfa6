# -*- coding:utf-8 -*-
"""Gradient boosting with scikit-learn 1.9.0's exact trees, without
scikit-learn: ``GradientBoostingClassifier`` and
``GradientBoostingRegressor`` with ``fit`` and ``apply``, the two calls
that ``transformers.GbmLeavesEncoder`` makes.

This is a copy of ``sklearn/ensemble/_gb.py`` at 1.9.0 over
``csrc/gbm_tree.cpp``, which grows each stage's
``DecisionTreeRegressor(criterion="squared_error", splitter="best")`` line
for line as scikit-learn's Cython does: the same sort, the same order of
sums, the same random feature draws. Given the same inputs and
``random_state``, the trees (children, features, thresholds) are the same
bit for bit and ``apply`` gives the same leaves.

The numpy steps are the ones scikit-learn takes (the prior through the
loss's link, ``np.average`` in the leaves' line search); the per-sample
loops that scikit-learn runs in C (the losses' gradients with the C
library's ``exp``, the subsample mask) run in the native library too.

The native library is built with the host compiler at first use
(``ops/kernels/_build.py``); a failed build raises with the compiler's
message. Parameters that the port does not take raise
``NotImplementedError`` (ROADMAP item 16b).
"""

import ctypes
import math
import numbers
import subprocess
import threading

import numpy as np

from ..ops.kernels import _build

SOURCE = _build.CSRC_DIR / 'gbm_tree.cpp'
# no fused multiply-add: each product and sum rounds as in scikit-learn's C
CXX_FLAGS = _build.HOST_CXX_FLAGS + ('-ffp-contract=off',)
RAND_R_MAX = 2147483647
TREE_LEAF = -1

_lib = None
_lib_lock = threading.Lock()

_i64 = ctypes.POINTER(ctypes.c_int64)
_f64 = ctypes.POINTER(ctypes.c_double)
_f32 = ctypes.POINTER(ctypes.c_float)
_u8 = ctypes.POINTER(ctypes.c_uint8)


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
            ctypes.c_int64, _i64, _i64, _i64, _f64, _u8, _f64]
        lib.gbm_tree_apply.restype = None
        lib.gbm_tree_apply.argtypes = [
            _f32, ctypes.c_int64, ctypes.c_int64, _i64, _i64, _i64, _f64,
            _u8, _i64]
        lib.gbm_neg_gradient_binomial.restype = None
        lib.gbm_neg_gradient_binomial.argtypes = [_f64, _f64, ctypes.c_int64,
                                                  _f64]
        lib.gbm_neg_gradient_multinomial.restype = None
        lib.gbm_neg_gradient_multinomial.argtypes = [
            _f64, _f64, ctypes.c_int64, ctypes.c_int64, _f64]
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
    feature -2 and threshold -2.0) and ``value`` of shape (node_count,)."""

    def __init__(self, children_left, children_right, feature, threshold,
                 missing_go_to_left, value):
        self.children_left = children_left
        self.children_right = children_right
        self.feature = feature
        self.threshold = threshold
        self.missing_go_to_left = missing_go_to_left
        self.value = value

    @property
    def node_count(self):
        return len(self.children_left)

    @classmethod
    def fit(cls, X, y, sample_weight, *, max_features, min_samples_split,
            min_samples_leaf, min_weight_leaf, max_depth, max_leaf_nodes,
            min_impurity_decrease, seed):
        """Grow a tree on float32 ``X`` (C order) against float64 ``y``
        (``DepthFirstTreeBuilder``, or ``BestFirstTreeBuilder`` when
        ``max_leaf_nodes`` >= 0)."""
        lib = get_library()
        n, d = X.shape
        y = np.ascontiguousarray(y, dtype=np.float64)
        sample_weight = np.ascontiguousarray(sample_weight, dtype=np.float64)
        capacity = max(2 * n - 1, 1)
        if max_depth < 62:
            capacity = min(capacity, 2 ** (max_depth + 1) - 1)
        if max_leaf_nodes >= 0:
            capacity = min(capacity, max(2 * max_leaf_nodes - 1, 1))
        arrays = dict(
            children_left=np.empty(capacity, np.int64),
            children_right=np.empty(capacity, np.int64),
            feature=np.empty(capacity, np.int64),
            threshold=np.empty(capacity, np.float64),
            missing_go_to_left=np.empty(capacity, np.uint8),
            value=np.empty(capacity, np.float64))
        a = arrays
        count = lib.gbm_tree_fit(
            _ptr(X, _f32), n, d, _ptr(y, _f64), _ptr(sample_weight, _f64),
            max_features, min_samples_split, min_samples_leaf,
            min_weight_leaf, max_depth, max_leaf_nodes,
            min_impurity_decrease, seed, capacity,
            _ptr(a['children_left'], _i64), _ptr(a['children_right'], _i64),
            _ptr(a['feature'], _i64), _ptr(a['threshold'], _f64),
            _ptr(a['missing_go_to_left'], _u8), _ptr(a['value'], _f64))
        if count < 0:
            raise RuntimeError(f'the tree outgrew its {capacity} nodes')
        return cls(**{k: v[:count].copy() for k, v in arrays.items()})

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
    return float(numerator) / float(denominator)


def _logit(p):
    """``scipy.special.logit`` of a float (xsf's ``logit``: the C library's
    ``log`` away from 1/2, ``log1p`` near it)."""
    if p < 0.3 or p > 0.65:
        return math.log(p / (1 - p))
    s = 2 * (p - 0.5)
    return math.log1p(s) - math.log1p(-s)


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


# scikit-learn's other parameters, at the defaults the port follows; any
# other value raises NotImplementedError
_FIXED = {'min_weight_fraction_leaf': 0.0, 'init': None, 'ccp_alpha': 0.0,
          'verbose': 0, 'warm_start': False, 'validation_fraction': 0.1,
          'n_iter_no_change': None, 'tol': 1e-4, 'criterion': 'deprecated'}


class _GradientBoosting:
    _LOSSES = ()
    _REGRESSION = False
    _FIXED = _FIXED

    def __init__(self, *, loss=None, learning_rate=0.1, n_estimators=100,
                 subsample=1.0, min_samples_split=2, min_samples_leaf=1,
                 max_depth=3, min_impurity_decrease=0.0, random_state=None,
                 max_features=None, max_leaf_nodes=None, **others):
        loss = self._LOSSES[0] if loss is None else loss
        if loss != self._LOSSES[0]:
            raise NotImplementedError(
                f'{type(self).__name__}: loss={loss!r} is not ported; the '
                f'port has loss={self._LOSSES[0]!r} (ROADMAP item 16b)')
        for name, value in others.items():
            if name not in self._FIXED:
                raise TypeError(f'{type(self).__name__}.__init__() got an '
                                f'unexpected keyword argument {name!r}')
            if value is not self._FIXED[name] and \
                    value != self._FIXED[name]:
                raise NotImplementedError(
                    f'{type(self).__name__}: {name}={value!r} is not ported '
                    f'(ROADMAP item 16b)')
        self.loss = loss
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample = subsample
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_depth = max_depth
        self.min_impurity_decrease = min_impurity_decrease
        self.random_state = random_state
        self.max_features = max_features
        self.max_leaf_nodes = max_leaf_nodes

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
            min_samples_leaf=min_samples_leaf, min_weight_leaf=0.0,
            max_depth=(np.iinfo(np.int32).max if self.max_depth is None
                       else self.max_depth),
            max_leaf_nodes=(-1 if self.max_leaf_nodes is None
                            else self.max_leaf_nodes),
            min_impurity_decrease=self.min_impurity_decrease)

    def fit(self, X, y):
        X = _float32_rows(X)
        n_samples, self.n_features_in_ = X.shape
        y = self._encode_y(np.asarray(y).reshape(-1))
        if len(y) != n_samples:
            raise ValueError(f'{len(y)} labels for {n_samples} samples')
        sample_weight = np.ones(n_samples, dtype=np.float64)
        raw_predictions = self._init_raw_predictions(y, n_samples)
        rng = _random_state(self.random_state)
        lib = get_library()
        params = self._tree_params(n_samples, self.n_features_in_)
        K = self.n_trees_per_iteration_
        self.estimators_ = np.empty((self.n_estimators, K), dtype=object)
        do_oob = self.subsample < 1.0
        sample_mask = np.ones(n_samples, dtype=bool)
        n_inbag = max(1, int(self.subsample * n_samples))
        for i in range(self.n_estimators):
            if do_oob:
                draws = np.ascontiguousarray(rng.uniform(size=n_samples))
                mask = np.empty(n_samples, np.uint8)
                lib.gbm_sample_mask(_ptr(draws, _f64), n_samples, n_inbag,
                                    _ptr(mask, _u8))
                sample_mask = mask.view(bool)
            neg_gradient = self._neg_gradient(lib, y, raw_predictions)
            stage_weight = sample_weight
            for k in range(K):
                y_k = np.array(y == k, dtype=np.float64) if K > 1 else y
                if do_oob:
                    stage_weight = stage_weight * sample_mask.astype(
                        np.float64)
                tree = Tree.fit(X, neg_gradient[:, k], stage_weight,
                                seed=rng.randint(0, RAND_R_MAX), **params)
                self._update_terminal_regions(
                    tree, X, y_k, neg_gradient[:, k], raw_predictions,
                    stage_weight, sample_mask, k)
                self.estimators_[i, k] = tree
        return self

    def _update_terminal_regions(self, tree, X, y, neg_gradient,
                                 raw_prediction, sample_weight, sample_mask,
                                 k):
        """``sklearn/ensemble/_gb.py`` ``_update_terminal_regions``: the
        leaves' line search, then ``raw_prediction[:, k]``."""
        terminal_regions = tree.apply(X)
        if not self._REGRESSION:
            masked = terminal_regions.copy()
            masked[~sample_mask] = -1
            for leaf in np.nonzero(tree.children_left == TREE_LEAF)[0]:
                indices = np.nonzero(masked == leaf)[0]
                y_ = y.take(indices, axis=0)
                sw = sample_weight[indices]
                neg_g = neg_gradient.take(indices, axis=0)
                prob = y_ - neg_g
                numerator = np.average(neg_g, weights=sw)
                if self.n_trees_per_iteration_ > 1:
                    K = self.n_classes_
                    numerator *= (K - 1) / K
                denominator = np.average(prob * (1 - prob), weights=sw)
                tree.value[leaf] = _safe_divide(numerator, denominator)
        raw_prediction[:, k] += self.learning_rate * tree.value.take(
            terminal_regions, axis=0)

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
    """``sklearn.ensemble.GradientBoostingClassifier`` (``log_loss``)."""

    _LOSSES = ('log_loss',)

    def _encode_y(self, y):
        self.classes_, encoded = np.unique(y, return_inverse=True)
        self.n_classes_ = len(self.classes_)
        if self.n_classes_ < 2:
            raise ValueError(f'y contains {self.n_classes_} class, while a '
                             f'minimum of 2 classes are required.')
        self.n_trees_per_iteration_ = 1 if self.n_classes_ <= 2 \
            else self.n_classes_
        return encoded.reshape(-1).astype(float, copy=False)

    def _init_raw_predictions(self, y, n_samples):
        """``DummyClassifier(strategy='prior')`` through the loss's link:
        the logit for two classes, else the log over the geometric mean
        (``scipy.stats.gmean`` at 1.17.0: the exp of the mean of the
        logs)."""
        _, y_k = np.unique(y.reshape(-1, 1)[:, 0], return_inverse=True)
        counts = np.bincount(y_k, weights=None)
        class_prior = counts / counts.sum()
        predictions = np.ones((n_samples, 1)) * class_prior
        eps = np.finfo(np.float64).eps
        if self.n_classes_ == 2:
            predictions = np.clip(predictions[:, 1], eps, 1 - eps,
                                  dtype=np.float64)
            # every row holds the prior
            return np.full((n_samples, 1), _logit(float(predictions[0])))
        predictions = np.clip(predictions, eps, 1 - eps, dtype=np.float64)
        gm = np.exp(np.mean(np.log(predictions), axis=1))
        return np.log(predictions / gm[:, None])

    def _neg_gradient(self, lib, y, raw):
        n = len(y)
        out = np.empty_like(raw)
        if self.n_classes_ == 2:
            raw1 = np.ascontiguousarray(raw[:, 0])
            lib.gbm_neg_gradient_binomial(_ptr(y, _f64), _ptr(raw1, _f64), n,
                                          _ptr(out, _f64))
        else:
            raw = np.ascontiguousarray(raw)
            lib.gbm_neg_gradient_multinomial(_ptr(y, _f64), _ptr(raw, _f64),
                                             n, raw.shape[1], _ptr(out, _f64))
        return out


class GradientBoostingRegressor(_GradientBoosting):
    """``sklearn.ensemble.GradientBoostingRegressor`` (``squared_error``)."""

    _LOSSES = ('squared_error',)
    _REGRESSION = True
    _FIXED = dict(_FIXED, alpha=0.9)  # the huber and quantile losses' alpha

    def _encode_y(self, y):
        self.n_trees_per_iteration_ = 1
        return y.astype(np.float64, copy=False)

    def _init_raw_predictions(self, y, n_samples):
        """``DummyRegressor(strategy='mean')``."""
        constant = np.average(y.reshape(-1, 1), axis=0)
        predictions = np.full((n_samples, 1), constant,
                              dtype=np.array(constant).dtype)
        return np.ravel(predictions).astype(np.float64).reshape(-1, 1)

    def _neg_gradient(self, lib, y, raw):
        return -(raw[:, 0] - y).reshape(-1, 1)

    def apply(self, X):
        leaves = super().apply(X)
        return leaves.reshape(leaves.shape[0], self.estimators_.shape[0])
