# -*- coding:utf-8 -*-
"""SHAP explainer wrapper over the port's ``DeepTable`` (the port's copy of
``deeptables_tpu/utils/shap.py``; parity: upstream ``utils/shap.py:12-30``).

Requires the optional ``shap`` package (guarded, like upstream's tests'
``have_shap`` flag).
"""

import numpy as np

from . import dt_logging

logger = dt_logging.get_logger(__name__)

try:
    import shap as _shap
    have_shap = True
except ImportError:
    _shap = None
    have_shap = False


class DeepTablesExplainer:
    """KernelSHAP over ``dt.predict(..., encode_to_label=False)`` with a
    sampled background set."""

    def __init__(self, dt_model, data, num_samples=100):
        if not have_shap:
            raise ImportError(
                'shap is required for DeepTablesExplainer; install `shap`.')
        self.dt_model = dt_model
        if num_samples is not None and len(data) > num_samples:
            data = data.sample(num_samples, random_state=9527)
        self.data = data

        def predict_fn(X_values):
            import pandas as pd
            df = pd.DataFrame(X_values, columns=data.columns)
            return np.asarray(
                self.dt_model.predict(df, encode_to_label=False)).reshape(-1)

        self.explainer = _shap.KernelExplainer(predict_fn, self.data)

    def get_shap_values(self, X, nsamples='auto', **kwargs):
        return self.explainer.shap_values(X, nsamples=nsamples, **kwargs)
