# -*- coding:utf-8 -*-
"""Permutation feature importance over the port's ``DeepTable`` (the port's
copy of ``deeptables_tpu/utils/feature_importance.py``).

Capability parity with upstream's ``utils/feature_importance.py``, which
wraps eli5's ``get_score_importances`` (feature_importance.py:14-46). eli5
is an optional package upstream; the permutation loop is written out here
instead: for each column, shuffle its values ``n_iter`` times and measure
the mean score decrease relative to the base score. ``X`` is what
``data.columns.as_columns`` takes (a DataFrame, a dict of 1-D arrays,
``Columns``); a column is permuted on a copy of its named numpy columns,
so the permutations, and the importances, are those of the DataFrame.
"""

import numpy as np

from ..data import columns as cl
from ..ops import metrics as metrics_lib
from . import dt_logging

logger = dt_logging.get_logger(__name__)


def _score_fn(dt_model, columns, metric, mode):
    metric = metric.lower()

    def score(df, y_s) -> float:
        if metric in ('auc', 'log_loss', 'logloss'):
            y_proba = dt_model.predict_proba(df)
            y_pred = y_proba
        else:
            y_pred = dt_model.predict(df)
            y_proba = y_pred
        result = metrics_lib.calc_score(
            y_s, y_pred, y_proba, [metric], dt_model.task,
            pos_label=getattr(dt_model, 'pos_label', None))
        value = result[metric]
        if mode == 'min':
            return -value
        elif mode == 'max':
            return value
        raise ValueError(f'Unsupported mode:{mode}')

    return score


def get_score_importances(dt_model, X, y, metric, n_iter=5, mode='min',
                          random_state=9527):
    """Permutation importances sorted descending.

    Returns an array of (column, mean_score_decrease) rows like upstream
    (feature_importance.py:38-40).
    """
    X = cl.as_columns(X, rename=False)
    columns = X.columns
    score = _score_fn(dt_model, columns, metric, mode)
    y = np.asarray(y)
    rng = np.random.default_rng(random_state)

    base_score = score(X, y)
    decreases = np.zeros((n_iter, len(columns)))
    for it in range(n_iter):
        for j, col in enumerate(columns):
            # permute one column on a copy so every column keeps its kind
            X_perm = X.copy()
            X_perm.set(col, rng.permutation(X[col]), X.kinds[col],
                       X.categories.get(col))
            decreases[it, j] = base_score - score(X_perm, y)
    feature_importances = np.stack(
        [columns, decreases.mean(axis=0)], axis=1)
    feature_importances = np.array(
        sorted(feature_importances, key=lambda fi: float(fi[1]),
               reverse=True))
    return feature_importances


def select_features(feature_importances, threshold=0.):
    """Split columns by importance threshold (parity:
    feature_importance.py:44-46)."""
    selected_columns = [fi[0] for fi in feature_importances
                        if float(fi[1]) > threshold]
    discard_columns = [fi[0] for fi in feature_importances
                       if float(fi[1]) <= threshold]
    return selected_columns, discard_columns
