# -*- coding:utf-8 -*-
"""Evaluation metrics: the port's copy of ``deeptables_tpu/ops/metrics.py``
(numpy only, computed on the host from whole prediction arrays).

Every metric takes ``(y_true, proba)``, where ``proba`` is the model's
probability output (the raw prediction for regression), and returns a
Python float. AUC is the exact rank statistic. Names resolve
case-insensitively; a user callable ``f(y_true, y_pred)`` is honoured.
``accuracy`` thresholds a single column and argmaxes several, as the
original does, except for multilabel data (a 2-D ``y_true`` of the
probabilities' shape): there it thresholds each label at 0.5 and averages
over the labels. The original argmaxes such probabilities too and then
fails on the shapes; the port does not copy that (ROADMAP Queue 3).
"""

import numpy as np

from ..utils import consts


def _to_numpy(a):
    return np.asarray(a)


def _is_multilabel(y_true, proba):
    """Several probability columns and labels of the same 2-D shape."""
    proba = _to_numpy(proba)
    return proba.ndim == 2 and proba.shape[1] > 1 \
        and _to_numpy(y_true).shape == proba.shape


def _binarize(y_true, proba, threshold=0.5):
    proba = _to_numpy(proba)
    if _is_multilabel(y_true, proba):
        return (proba > threshold).astype(np.int32)
    if proba.ndim == 2 and proba.shape[1] > 1:
        return proba.argmax(axis=1)
    return (proba.reshape(-1) > threshold).astype(np.int32)


def _positive_proba(proba):
    proba = _to_numpy(proba)
    if proba.ndim == 2 and proba.shape[1] == 2:
        return proba[:, 1]
    return proba.reshape(-1)


def auc(y_true, proba):
    """Exact ROC AUC via the rank statistic (binary)."""
    y = _to_numpy(y_true).reshape(-1)
    p = _positive_proba(proba)
    pos = y == 1
    n_pos = int(pos.sum())
    n_neg = int(len(y) - n_pos)
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(p, kind='mergesort')
    sorted_p = p[order]
    # vectorized average ranks for ties: each tie group [start, stop) gets
    # the mean of its 1-based rank range
    boundaries = np.flatnonzero(np.diff(sorted_p)) + 1
    starts = np.concatenate([[0], boundaries])
    stops = np.concatenate([boundaries, [len(p)]])
    group_rank = (starts + 1 + stops) / 2.0  # mean of ranks start+1..stop
    group_ids = np.cumsum(np.concatenate(
        [[0], (np.diff(sorted_p) != 0).astype(np.int64)]))
    ranks = np.empty(len(p), dtype=np.float64)
    ranks[order] = group_rank[group_ids]
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def pr_auc(y_true, proba):
    """Area under the precision-recall curve (average precision)."""
    y = _to_numpy(y_true).reshape(-1)
    p = _positive_proba(proba)
    order = np.argsort(-p, kind='mergesort')
    y_sorted = y[order]
    tp_cum = np.cumsum(y_sorted)
    n_pos = tp_cum[-1] if len(tp_cum) else 0
    if n_pos == 0:
        return 0.0
    precision = tp_cum / np.arange(1, len(y_sorted) + 1)
    recall = tp_cum / n_pos
    # step-wise integration (average precision)
    dr = np.diff(np.concatenate([[0.0], recall]))
    return float(np.sum(precision * dr))


def accuracy(y_true, proba):
    if _is_multilabel(y_true, proba):
        return float((_binarize(y_true, proba) == _to_numpy(y_true)).mean())
    y = _to_numpy(y_true).reshape(-1)
    pred = _binarize(y, proba)
    return float((pred == y).mean())


def logloss(y_true, proba, eps=1e-7):
    y = _to_numpy(y_true)
    p = np.clip(_to_numpy(proba).astype(np.float64), eps, 1 - eps)
    if p.ndim == 2 and p.shape[1] > 1:
        if y.ndim == 1 or (y.ndim == 2 and y.shape[1] == 1):
            y_idx = y.reshape(-1).astype(int)
            return float(-np.mean(np.log(p[np.arange(len(y_idx)), y_idx])))
        return float(-np.mean(np.sum(y * np.log(p), axis=1)))
    y = y.reshape(-1)
    p = p.reshape(-1)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def mse(y_true, pred):
    y = _to_numpy(y_true).reshape(-1).astype(np.float64)
    p = _to_numpy(pred).reshape(-1).astype(np.float64)
    return float(np.mean((y - p) ** 2))


def rmse(y_true, pred):
    return float(np.sqrt(mse(y_true, pred)))


def mae(y_true, pred):
    y = _to_numpy(y_true).reshape(-1).astype(np.float64)
    p = _to_numpy(pred).reshape(-1).astype(np.float64)
    return float(np.mean(np.abs(y - p)))


def msle(y_true, pred):
    y = _to_numpy(y_true).reshape(-1).astype(np.float64)
    p = _to_numpy(pred).reshape(-1).astype(np.float64)
    return float(np.mean((np.log1p(np.maximum(y, 0)) -
                          np.log1p(np.maximum(p, 0))) ** 2))


def r2(y_true, pred):
    y = _to_numpy(y_true).reshape(-1).astype(np.float64)
    p = _to_numpy(pred).reshape(-1).astype(np.float64)
    ss_res = np.sum((y - p) ** 2)
    ss_tot = np.sum((y - y.mean()) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0


def _prf(y_true, proba):
    # multilabel: over every (example, label) element
    y = _to_numpy(y_true).reshape(-1)
    pred = _binarize(y_true, proba).reshape(-1)
    tp = float(((pred == 1) & (y == 1)).sum())
    fp = float(((pred == 1) & (y != 1)).sum())
    fn = float(((pred != 1) & (y == 1)).sum())
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) \
        if (precision + recall) > 0 else 0.0
    return precision, recall, f1


def precision(y_true, proba):
    return _prf(y_true, proba)[0]


def recall(y_true, proba):
    return _prf(y_true, proba)[1]


def f1(y_true, proba):
    return _prf(y_true, proba)[2]


_METRICS = {
    'auc': auc,
    'roc_auc': auc,
    'pr_auc': pr_auc,
    'accuracy': accuracy,
    'acc': accuracy,
    'logloss': logloss,
    'log_loss': logloss,
    'crossentropy': logloss,
    'binary_crossentropy': logloss,
    'categorical_crossentropy': logloss,
    'mse': mse,
    'mean_squared_error': mse,
    'rmse': rmse,
    'root_mean_squared_error': rmse,
    'rootmeansquarederror': rmse,  # Keras metric class name
    'mae': mae,
    'mean_absolute_error': mae,
    'msle': msle,
    'r2': r2,
    'precision': precision,
    'recall': recall,
    'f1': f1,
}


def get_metric(identifier):
    """Resolve a metric name/callable/metric-like object to (name, fn)."""
    if callable(identifier) and not isinstance(identifier, str):
        name = getattr(identifier, '__name__', None) or \
            getattr(identifier, 'name', 'metric')
        return name, identifier
    if hasattr(identifier, 'name'):
        identifier = identifier.name
    key = str(identifier).lower()
    if key not in _METRICS:
        raise ValueError(f'Unknown metric: {identifier!r}')
    return str(identifier), _METRICS[key]


def compute_metrics(metric_list, y_true, proba, task):
    """Compute every metric in ``metric_list`` → {name: value}.

    For regression tasks, ``proba`` is the raw prediction.
    """
    result = {}
    for m in metric_list:
        name, fn = get_metric(m)
        try:
            result[name] = float(fn(y_true, proba))
        except TypeError:
            # custom callables with (y_true, y_pred) expecting label preds
            pred = _binarize(y_true, proba) \
                if task != consts.TASK_REGRESSION else proba
            result[name] = float(fn(y_true, pred))
    return result


def calc_score(y_true, y_pred, y_proba, metrics, task, pos_label=None,
               classes=None):
    """Score a prediction set: the probability metrics on ``y_proba`` (the
    prediction for regression), the label metrics on ``y_pred``; used for
    the out-of-fold scores of cross-validation."""
    # probability metrics assume integer-encoded labels; raw (string, bool,
    # object) labels are encoded as LabelEncoder would (sorted uniques),
    # with pos_label the positive class of a binary task
    y_true_enc = y_true
    if task != consts.TASK_REGRESSION:
        yt_arr = _to_numpy(y_true).reshape(-1)
        if yt_arr.dtype.kind in ('U', 'S', 'O', 'b'):
            uniq = np.unique(yt_arr)
            if pos_label is not None and len(uniq) == 2:
                y_true_enc = (yt_arr == pos_label).astype(np.int64)
            else:
                y_true_enc = np.searchsorted(uniq, yt_arr)

    result = {}
    for m in metrics:
        name, fn = get_metric(m)
        lname = str(name).lower()
        if task == consts.TASK_REGRESSION or lname in (
                'auc', 'roc_auc', 'pr_auc', 'logloss', 'log_loss', 'mse',
                'rmse', 'mae', 'msle', 'r2'):
            y_in = y_proba if task != consts.TASK_REGRESSION else y_pred
            result[name] = float(fn(y_true_enc, y_in))
            continue
        # label metrics compare the decoded labels
        yt = _to_numpy(y_true).reshape(-1)
        yp = _to_numpy(y_pred).reshape(-1)
        if lname in ('accuracy', 'acc'):
            result[name] = float((yt == yp).mean())
        elif lname in ('precision', 'recall', 'f1'):
            pos = pos_label if pos_label is not None else 1
            tp = float(((yp == pos) & (yt == pos)).sum())
            fp = float(((yp == pos) & (yt != pos)).sum())
            fn_ = float(((yp != pos) & (yt == pos)).sum())
            prec = tp / (tp + fp) if (tp + fp) > 0 else 0.0
            rec = tp / (tp + fn_) if (tp + fn_) > 0 else 0.0
            result[name] = {'precision': prec, 'recall': rec,
                            'f1': 2 * prec * rec / (prec + rec)
                            if (prec + rec) > 0 else 0.0}[lname]
        else:
            result[name] = float(fn(yt, yp))
    return result
