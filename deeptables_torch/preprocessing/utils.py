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
package's pandas code gives. ``target_rate_encodeing`` takes a DataFrame
and uses its methods.
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


def target_rate_encodeing(feat_to_encode, target, df, mode='order'):
    """Per-category target-rate (or rate-order) encoding (parity: upstream
    preprocessing/utils.py:33-54).  mode: 'order' | 'rate'."""
    df = df.copy()
    for col in feat_to_encode:
        df[col] = df[col].astype('str').fillna('-1')
        data = df[[col, target]].groupby(col)[target] \
            .value_counts().unstack().fillna(0)
        pos = data[1] if 1 in data.columns else 0
        neg = data[0] if 0 in data.columns else 0
        data['rate'] = pos / (pos + neg).replace(0, np.nan)
        data = data.sort_values(by=['rate']).reset_index()
        nn = f'{col}_tre'
        if mode == 'order':
            dict_ord = {k: i + 1 for i, k in enumerate(data[col].values)}
            df[nn] = df[col].map(dict_ord).astype('int32')
        else:
            dict_ord = dict(zip(data[col].values, data['rate'].values))
            df[nn] = df[col].map(dict_ord)
    return df
