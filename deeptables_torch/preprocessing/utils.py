# -*- coding:utf-8 -*-
"""Target encoding utilities (the port's copy of
``deeptables_tpu/preprocessing/utils.py``).

Capability parity with upstream's ``preprocessing/utils.py``: k-fold
out-of-fold target encoding (upstream :12-31, which uses
category_encoders.TargetEncoder — re-implemented here with the same
smoothing semantics) and target-rate/order encoding (:33-54). They take
pandas DataFrames and run on the host; pandas and scikit-learn are imported
by the functions that use them.
"""

import numpy as np

from ..utils import dt_logging

logger = dt_logging.get_logger(__name__)


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
        import pandas as pd
        y = pd.Series(np.asarray(y, dtype=float), index=X.index)
        self.prior_ = float(y.mean())
        cols = self.cols or list(X.columns)
        self.cols = cols
        for c in cols:
            stats = y.groupby(X[c]).agg(['count', 'mean'])
            smoove = 1.0 / (1.0 + np.exp(
                -(stats['count'] - self.min_samples_leaf) / self.smoothing))
            smoothed = self.prior_ * (1 - smoove) + stats['mean'] * smoove
            self.mappings_[c] = smoothed.to_dict()
        return self

    def transform(self, X):
        X = X.copy()
        for c in self.cols:
            X[c] = X[c].map(self.mappings_[c]).fillna(self.prior_)
        return X

    def fit_transform(self, X, y):
        return self.fit(X, y).transform(X)


def target_encoding(train, target, test=None, feat_to_encode=None,
                    smooth=0.2, random_state=9527):
    """K-fold OOF target encoding (parity: upstream
    preprocessing/utils.py:12-31)."""
    import pandas as pd
    from sklearn.model_selection import StratifiedKFold
    logger.info('Target encoding...')
    train = train.sort_index()
    target_s = train.pop(target)
    if feat_to_encode is None:
        feat_to_encode = train.columns.tolist()
    oof_parts = []
    skf = StratifiedKFold(n_splits=5, random_state=random_state, shuffle=True)
    for tr_idx, oof_idx in skf.split(train, target_s):
        enc = TargetEncoder(cols=feat_to_encode, smoothing=smooth)
        enc.fit(train.iloc[tr_idx, :], target_s.iloc[tr_idx])
        oof_parts.append(enc.transform(train.iloc[oof_idx, :]))
    full_encoder = TargetEncoder(cols=feat_to_encode, smoothing=smooth)
    full_encoder.fit(train, target_s)
    train_encoded = pd.concat(oof_parts).sort_index()
    if test is not None:
        test = full_encoder.transform(test)
    features = list(train_encoded)
    logger.info('Target encoding done!')
    return train_encoded, test, features, target_s


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
