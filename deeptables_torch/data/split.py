# -*- coding:utf-8 -*-
"""Train/validation split and cross-validation folds with numpy alone.

``DeepModel.fit`` of the JAX package splits off its validation set with
scikit-learn's ``train_test_split`` (``deeptables_tpu/models/deepmodel.py:
576-588``), and ``DeepTable.fit_cross_validation`` folds with its ``KFold``
and ``StratifiedKFold``; the machine with the card has no scikit-learn.
This module returns **the same rows** as scikit-learn for the same
arguments: the plain split follows ``ShuffleSplit`` and the stratified one
``StratifiedShuffleSplit`` with its ``_approximate_mode``; the folds follow
``KFold`` and ``StratifiedKFold`` (classes numbered by first appearance,
each class's fold labels dealt round robin over the sorted labels and then
shuffled). All draw from the same ``numpy.random.RandomState`` stream in
the same order.
"""

import math
import numbers
import warnings

import numpy as np

from .columns import Columns


def _split_sizes(n_samples: int, test_size) -> tuple:
    """(n_train, n_test) as scikit-learn's ``_validate_shuffle_split``."""
    if isinstance(test_size, (int, np.integer)) and \
            not isinstance(test_size, bool):
        if not 0 < test_size < n_samples:
            raise ValueError(f'test_size={test_size} should be in '
                             f'(0, {n_samples}).')
        n_test = int(test_size)
    else:
        test_size = float(test_size)
        if not 0. < test_size < 1.:
            raise ValueError(f'test_size={test_size} should be in (0, 1).')
        n_test = math.ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train <= 0:
        raise ValueError(f'With n_samples={n_samples} and test_size='
                         f'{test_size} the train set would be empty.')
    return n_train, n_test


def _approximate_mode(class_counts, n_draws, rng):
    """scikit-learn's ``_approximate_mode``: draws per class, ties broken
    with ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def split_indices(n_samples: int, test_size=0.25, random_state=None,
                  stratify=None):
    """(train, test) row indices as scikit-learn's ``train_test_split``
    draws them (``random_state`` a seed, or a ``RandomState`` to draw
    from)."""
    n_train, n_test = _split_sizes(n_samples, test_size)
    rng = random_state if isinstance(random_state, np.random.RandomState) \
        else np.random.RandomState(random_state)
    if stratify is None:
        permutation = rng.permutation(n_samples)
        return permutation[n_test:n_test + n_train], permutation[:n_test]

    y = np.asarray(stratify)
    if y.ndim == 2:
        y = np.array([' '.join(row.astype('str')) for row in y])
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError('The least populated class in y has only 1 member, '
                         'which is too few to stratify.')
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f'train ({n_train}) and test ({n_test}) sizes must '
                         f'be at least the number of classes ({len(classes)}).')
    class_indices = np.split(np.argsort(y_indices, kind='stable'),
                             np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        permutation = rng.permutation(class_counts[i])
        rows = class_indices[i].take(permutation, mode='clip')
        train.extend(rows[:n_i[i]])
        test.extend(rows[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def take_rows(X, rows):
    """Rows of a DataFrame (``.iloc``, no pandas import), of ``Columns``, of
    each array of a dict of arrays, or of an array."""
    if hasattr(X, 'iloc'):
        return X.iloc[rows]
    if isinstance(X, Columns):
        return X.take(rows)
    if isinstance(X, dict):
        return {k: np.asarray(v)[rows] for k, v in X.items()}
    return np.asarray(X)[rows]


def num_rows(X) -> int:
    if isinstance(X, dict):
        return len(next(iter(X.values())))
    return len(X)


def train_test_split(X, y, test_size=0.25, random_state=None, stratify=None):
    """``X_train, X_test, y_train, y_test`` with the rows scikit-learn's
    ``train_test_split(X, y, test_size=..., random_state=...,
    stratify=...)`` returns. ``X`` is a DataFrame, a dict of arrays or an
    array; ``y`` an array or a Series."""
    train, test = split_indices(num_rows(X), test_size, random_state,
                                stratify)
    return (take_rows(X, train), take_rows(X, test),
            take_rows(y, train), take_rows(y, test))


def _random_state(random_state):
    """scikit-learn's ``check_random_state``."""
    if random_state is None:
        return np.random.mtrand._rand
    if isinstance(random_state, np.random.RandomState):
        return random_state
    return np.random.RandomState(random_state)


def _target_type(y) -> str:
    """'binary', 'multiclass' or another of scikit-learn's
    ``type_of_target`` names, for the labels the stratified folds take."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] > 1:
        return 'multilabel-indicator'
    y = y.reshape(-1)
    if y.dtype.kind == 'f' and np.any(y != y.astype(np.int64)):
        return 'continuous'
    return 'binary' if len(np.unique(y)) <= 2 else 'multiclass'


class _KFoldBase:
    def __init__(self, n_splits=5, *, shuffle=False, random_state=None):
        if not isinstance(n_splits, numbers.Integral):
            raise ValueError(f'The number of folds must be of Integral type. '
                             f'{n_splits} of type {type(n_splits)} was passed.')
        n_splits = int(n_splits)
        if n_splits <= 1:
            raise ValueError(f'k-fold cross-validation requires at least one '
                             f'train/test split by setting n_splits=2 or '
                             f'more, got n_splits={n_splits}.')
        if not isinstance(shuffle, bool):
            raise TypeError(f'shuffle must be True or False; got {shuffle}')
        if not shuffle and random_state is not None:
            raise ValueError('Setting a random_state has no effect since '
                             'shuffle is False.')
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits

    def __repr__(self):
        return (f'{type(self).__name__}(n_splits={self.n_splits}, '
                f'random_state={self.random_state}, shuffle={self.shuffle})')

    def split(self, X, y=None, groups=None):
        """(train, test) row positions of each fold, as scikit-learn's
        ``split``; ``X`` is anything with a length (a DataFrame,
        ``Columns``, an array)."""
        n_samples = num_rows(X)
        if self.n_splits > n_samples:
            raise ValueError(f'Cannot have number of splits n_splits='
                             f'{self.n_splits} greater than the number of '
                             f'samples: n_samples={n_samples}.')
        indices = np.arange(n_samples)
        for test_mask in self._test_masks(n_samples, y):
            yield indices[~test_mask], indices[test_mask]


class KFold(_KFoldBase):
    """scikit-learn's ``KFold``: consecutive folds of the (shuffled) rows,
    the first ``n % n_splits`` one row longer."""

    def _test_masks(self, n_samples, y):
        indices = np.arange(n_samples)
        if self.shuffle:
            _random_state(self.random_state).shuffle(indices)
        fold_sizes = np.full(self.n_splits, n_samples // self.n_splits,
                             dtype=int)
        fold_sizes[:n_samples % self.n_splits] += 1
        current = 0
        for fold_size in fold_sizes:
            mask = np.zeros(n_samples, dtype=bool)
            mask[indices[current:current + fold_size]] = True
            current += fold_size
            yield mask


class StratifiedKFold(_KFoldBase):
    """scikit-learn's ``StratifiedKFold``: each class's rows spread over the
    folds in the proportions of a round robin over the sorted labels."""

    def _test_folds(self, y):
        rng = _random_state(self.random_state)
        y = np.asarray(y)
        target = _target_type(y)
        if target not in ('binary', 'multiclass'):
            raise ValueError(f"Supported target types are: ('binary', "
                             f"'multiclass'). Got {target!r} instead.")
        y = y.reshape(-1)
        _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
        # classes numbered by order of first appearance
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv.reshape(-1)]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(f'n_splits={self.n_splits} cannot be greater '
                             f'than the number of members in each class.')
        if self.n_splits > y_counts.min():
            warnings.warn(f'The least populated class in y has only '
                          f'{y_counts.min()} members, which is less than '
                          f'n_splits={self.n_splits}.', UserWarning)
        y_order = np.sort(y_encoded)
        allocation = np.asarray([
            np.bincount(y_order[i::self.n_splits], minlength=n_classes)
            for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype='i')
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(
                allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def _test_masks(self, n_samples, y):
        if y is None:
            raise ValueError('StratifiedKFold needs y.')
        test_folds = self._test_folds(y)
        for i in range(self.n_splits):
            yield test_folds == i
