# -*- coding:utf-8 -*-
"""Train/validation split with numpy alone.

``DeepModel.fit`` of the JAX package splits off its validation set with
scikit-learn's ``train_test_split`` (``deeptables_tpu/models/deepmodel.py:
576-588``), which the machine with the card does not have. This module
returns **the same rows** as scikit-learn for the same arguments: the plain
case follows ``ShuffleSplit`` and the stratified case
``StratifiedShuffleSplit`` with its ``_approximate_mode``, drawing from the
same ``numpy.random.RandomState`` stream in the same order.
"""

import math

import numpy as np


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
    draws them."""
    n_train, n_test = _split_sizes(n_samples, test_size)
    rng = np.random.RandomState(random_state)
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
    """Rows of a DataFrame (``.iloc``, no pandas import), of each array of a
    dict of arrays, or of an array."""
    if hasattr(X, 'iloc'):
        return X.iloc[rows]
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
