# -*- coding:utf-8 -*-
"""Named model registry with a per-metric leaderboard (the port's copy of
``deeptables_tpu/models/modelset.py``).

Scores fall back to the last epoch of a fit history, min/max ordering is
inferred from the metric name in ``auto`` mode, and ``leaderboard`` returns
a table with the sort metric starred: a DataFrame where pandas imports,
else ``data.columns.Columns`` with the same columns. The registry keeps an
insertion-ordered ``{name: ModelInfo}`` mapping; ranking is a ``sorted``
view.
"""

from ..data import columns
from ..utils import consts


def _normalize_scores(score, history):
    """Lower-case score keys; if empty, take each metric's last epoch value."""
    out = {str(k).lower(): v for k, v in (score or {}).items()}
    if not out and history:
        out = {str(k).lower(): v[-1] for k, v in history.items()}
    return out


class ModelInfo:
    """A registered model plus its evaluation scores and free-form metadata."""

    def __init__(self, type, name, model, score, **meta):
        self.type = type
        self.name = name
        self.model = model
        self.meta = meta
        self.score = _normalize_scores(score, meta.get('history'))

    def get_score(self, metric_name):
        return self.score.get(str(metric_name).lower(), 0)


class ModelSet:
    """Insertion-ordered registry of ModelInfo entries ranked by one metric."""

    def __init__(self, metric=consts.METRIC_NAME_AUC,
                 best_mode=consts.MODEL_SELECT_MODE_MAX):
        self.metric = str(metric).lower()
        self.best_mode = best_mode
        self._by_name = {}

    # -- registry -----------------------------------------------------------
    def clear(self):
        self._by_name = {}

    def push(self, modelinfo):
        if modelinfo.name in self._by_name:
            raise ValueError(
                f'Duplicate model name is not allowed, model named '
                f'"{modelinfo.name}" already exists.')
        self._by_name[modelinfo.name] = modelinfo

    def get_modelinfo(self, name):
        return self._by_name.get(name)

    def get_modelinfos(self, type=None):
        infos = self._by_name.values()
        if type is not None:
            infos = (m for m in infos if m.type == type)
        return list(infos)

    def get_models(self, type=None):
        return [m.model for m in self.get_modelinfos(type)]

    # -- ranking ------------------------------------------------------------
    def _bigger_is_better(self):
        mode = self.best_mode
        if mode == consts.MODEL_SELECT_MODE_AUTO:
            return self.metric in consts.METRICS_BIGGER_IS_BETTER
        return mode == consts.MODEL_SELECT_MODE_MAX

    def _ranked(self, type=None):
        return sorted(self.get_modelinfos(type),
                      key=lambda m: m.get_score(self.metric),
                      reverse=self._bigger_is_better())

    def best_model(self):
        ranked = self._ranked()
        if not ranked:
            raise ValueError('Model set is empty.')
        return ranked[0]

    def top_n(self, top=0, type=None):
        ranked = self._ranked(type)
        return ranked[:top] if top > 0 else ranked

    def leaderboard(self, top=0, type=None):
        rows = []
        for m in self.top_n(top, type=type):
            row = {'model': m.name, 'type': m.type}
            for key, value in m.score.items():
                row['*' + key if key == self.metric else key] = value
            if self.metric not in m.score:
                print(f'Not found sort-metric:{self.metric} '
                      f'in metrics:{list(m.score)}.')
            rows.append(row)
        if not rows:
            return None
        return columns.records_table(rows)
