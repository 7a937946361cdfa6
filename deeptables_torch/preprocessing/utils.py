# -*- coding:utf-8 -*-
"""Target encoding utilities (the port's copy of
``deeptables_tpu/preprocessing/utils.py``).

Capability parity with upstream's ``preprocessing/utils.py``: k-fold
out-of-fold target encoding (upstream :12-31, which uses
category_encoders.TargetEncoder — re-implemented here with the same
smoothing semantics) and target-rate/order encoding (:33-54).
``TargetEncoder`` and ``target_encoding`` work on numpy columns
(``data.columns``, the folds of ``data.split.StratifiedKFold``) and take a
DataFrame, a dict of 1-D arrays or ``Columns``; given a DataFrame they
return DataFrames (and the target as a Series), the values the JAX
package's pandas code gives. ``target_rate_encodeing`` works on the same
columns.
"""

import numpy as np

from ..data import columns as cl
from ..data.split import StratifiedKFold
from ..utils import dt_logging

logger = dt_logging.get_logger(__name__)


def _group_stats(keys, y):
    """Each distinct non-missing key's (count, mean of y), the mean summed
    with Kahan's compensation in row order, as pandas' groupby mean sums."""
    keys = np.asarray(keys)
    missing = cl.isna(keys)
    sums, comps, counts = {}, {}, {}
    for k, v in zip(keys[~missing].tolist(), y[~missing].tolist()):
        if k not in counts:
            sums[k], comps[k], counts[k] = 0.0, 0.0, 0
        counts[k] += 1
        t_y = v - comps[k]
        t = sums[k] + t_y
        comps[k] = t - sums[k] - t_y
        sums[k] = t
    return {k: (counts[k], sums[k] / counts[k]) for k in counts}


class TargetEncoder:
    """Mean target encoding with smoothing toward the global prior
    (same formulation as category_encoders' TargetEncoder: a sigmoid blend
    controlled by ``smoothing``)."""

    def __init__(self, cols=None, smoothing=1.0, min_samples_leaf=1):
        self.cols = cols
        self.smoothing = smoothing
        self.min_samples_leaf = min_samples_leaf
        self.mappings_ = {}
        self.prior_ = None

    def fit(self, X, y):
        X = cl.as_columns(X, rename=False)
        y = np.asarray(y, dtype=float)
        self.prior_ = float(y.mean())
        cols = self.cols or list(X.columns)
        self.cols = cols
        for c in cols:
            stats = _group_stats(X[c], y)
            mapping = {}
            for key in sorted(stats):
                count, mean = stats[key]
                smoove = 1.0 / (1.0 + np.exp(
                    -(count - self.min_samples_leaf) / self.smoothing))
                mapping[key] = float(self.prior_ * (1 - smoove)
                                     + mean * smoove)
            self.mappings_[c] = mapping
        return self

    def _encode(self, values, c):
        mapping = self.mappings_[c]
        return np.array([mapping.get(v, self.prior_)
                         for v in np.asarray(values).tolist()],
                        dtype=np.float64)

    def transform(self, X):
        frame = cl.is_frame(X)
        X = cl.as_columns(X, rename=False).copy()
        for c in self.cols:
            X[c] = self._encode(X[c], c)
        return cl.to_frame(X) if frame else X

    def fit_transform(self, X, y):
        return self.fit(X, y).transform(X)


def target_encoding(train, target, test=None, feat_to_encode=None,
                    smooth=0.2, random_state=9527):
    """K-fold OOF target encoding (parity: upstream
    preprocessing/utils.py:12-31): each row encoded by the encoder fitted
    on the other folds, rows in the order of the table's index."""
    logger.info('Target encoding...')
    frame = cl.is_frame(train)
    train = cl.as_columns(train, rename=False)
    if train.index is not None:
        train = train.take(np.argsort(np.asarray(train.index),
                                      kind='stable'))
    else:
        train = train.copy()
    target_y = train.pop(target)
    if feat_to_encode is None:
        feat_to_encode = train.columns
    encoded = train.copy()
    parts = {c: np.empty(train.n_rows, dtype=np.float64)
             for c in feat_to_encode}
    skf = StratifiedKFold(n_splits=5, random_state=random_state, shuffle=True)
    for tr_idx, oof_idx in skf.split(train, target_y):
        enc = TargetEncoder(cols=feat_to_encode, smoothing=smooth)
        enc.fit(train.take(tr_idx), target_y[tr_idx])
        for c in feat_to_encode:
            parts[c][oof_idx] = enc._encode(train[c][oof_idx], c)
    for c in feat_to_encode:
        encoded[c] = parts[c]
    full_encoder = TargetEncoder(cols=feat_to_encode, smoothing=smooth)
    full_encoder.fit(train, target_y)
    if test is not None:
        test = full_encoder.transform(test)
    features = list(encoded.columns)
    logger.info('Target encoding done!')
    if frame:
        import pandas as pd
        return (cl.to_frame(encoded), test, features,
                pd.Series(target_y, index=encoded.index, name=target))
    return encoded, test, features, target_y


def _nargsort(values):
    """``sort_values``' order of a float column: numpy's quicksort of the
    values that are not NaN, then the NaN rows in their order."""
    missing = np.isnan(values)
    idx = np.arange(len(values))
    return np.concatenate([idx[~missing][np.argsort(values[~missing],
                                                    kind='quicksort')],
                           idx[missing]])


def target_rate_encodeing(feat_to_encode, target, df, mode='order'):
    """Per-category target-rate (or rate-order) encoding (parity: upstream
    preprocessing/utils.py:33-54).  mode: 'order' | 'rate'.

    Each column becomes its text (``columns.as_str``, a missing value
    ``'-1'``); each category's rate is its rows' count of target 1 over
    those of 0 and 1, and ``<col>_tre`` is the rate, or the category's
    1-based position in the categories sorted by rate (as ``sort_values``
    sorts). ``df`` is what ``columns.as_columns`` takes; a DataFrame comes
    back as a DataFrame."""
    frame = cl.is_frame(df)
    df = cl.as_columns(df, rename=False).copy()
    y = df[target]
    counted = ~cl.isna(y)
    for col in feat_to_encode:
        text = cl.as_str(df[col]).astype(object)
        text[cl.isna(df[col])] = '-1'
        df.set(col, text, 'str')
        # groupby(col)[target].value_counts().unstack(): the categories of
        # rows with a target, sorted, and their counts of 1 and 0
        keys, inverse = np.unique(text[counted].astype(str),
                                  return_inverse=True)
        y_counted = y[counted]
        pos = np.bincount(inverse[y_counted == 1], minlength=len(keys))
        neg = np.bincount(inverse[y_counted == 0], minlength=len(keys))
        total = (pos + neg).astype(np.float64)
        total[total == 0] = np.nan
        rate = pos / total
        order = _nargsort(rate)
        nn = f'{col}_tre'
        codes = np.searchsorted(keys, text.astype(str))
        found = (codes < len(keys)) & (keys[np.minimum(codes, len(keys) - 1)]
                                       == text.astype(str)) if len(keys) \
            else np.zeros(len(text), bool)
        if mode == 'order':
            if not found.all():
                raise ValueError('Cannot convert non-finite values (NA or '
                                 'inf) to integer')
            position = np.empty(len(keys), np.int32)
            position[order] = np.arange(1, len(keys) + 1)
            df.set(nn, position[codes])
        else:
            values = np.full(len(text), np.nan)
            values[found] = rate[codes[found]]
            df.set(nn, values)
    return cl.to_frame(df) if frame else df
