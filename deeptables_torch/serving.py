# -*- coding:utf-8 -*-
"""Low-latency inference serving (counterpart of ``deeptables_tpu/serving.py``).

A :class:`Predictor` pads each request up to the smallest batch bucket that
holds it (larger requests go in chunks of the next multiple of the largest
bucket), runs the model's inference forward on its device, and returns
numpy probabilities; binary tasks get the estimator's ``(n, 2)`` layout.

``Predictor.load``, ``Predictor.predict`` and ``export_predictor`` go
through ``DeepTable`` and its preprocessor (numpy alone), which this module
imports inside them only: the packed-array path (``predict_proba_arrays``)
needs neither.

A request runs in the span ``serve.request`` (its id, distinct in the
process, its ``rows`` and ``padded_rows``), its parts in ``serve.pad``,
``serve.forward`` and ``serve.copy_back`` (``utils.profiling.annotate``).
"""

import itertools
import math
from typing import Dict, Optional, Sequence

import numpy as np

from .data import pipeline
from .models.deepmodel import DeepModel, probas_from_logits
from .utils import consts, dt_logging
from .utils.profiling import annotate

logger = dt_logging.get_logger(__name__)

DEFAULT_BUCKETS = (1, 8, 64, 512, 4096)
# the ids of the requests' spans
_REQUEST_IDS = itertools.count(1)


def fix_binary_predict_proba_result(proba):
    """(n,) or (n,1) positive-class proba → (n,2) [neg, pos] matrix."""
    proba = np.asarray(proba)
    if proba.ndim == 1:
        proba = proba.reshape(-1, 1)
    if proba.shape[-1] == 1:
        proba = np.concatenate([1 - proba, proba], axis=1)
    return proba


def _rows(arrays: Dict[str, np.ndarray], start: int, count: int,
          size: int) -> Dict[str, np.ndarray]:
    """Rows ``[start, start + count)`` of each array, padded with zero rows
    to ``size``."""
    chunk = {}
    for k, v in arrays.items():
        part = v[start:start + count]
        if count < size:
            pad = np.zeros((size - count,) + part.shape[1:], part.dtype)
            part = np.concatenate([part, pad])
        chunk[k] = part
    return chunk


class Predictor:
    """Bucketed predictor over a fitted estimator.

    The first argument needs only ``.task``, ``.preprocessor`` and
    ``.get_model(selector)`` returning a port ``DeepModel``."""

    def __init__(self, deeptable, model_selector=consts.MODEL_SELECTOR_CURRENT,
                 batch_buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.dt = deeptable
        self.preprocessor = deeptable.preprocessor
        self.model: DeepModel = deeptable.get_model(model_selector)
        self.model.build()
        self.task = deeptable.task
        self.buckets = sorted(set(int(b) for b in batch_buckets))

    @classmethod
    def load(cls, filepath, device=None, **kwargs):
        """A predictor over a ``DeepTable`` saved in ``filepath``, its
        model on ``device`` (default: the current CUDA device)."""
        from .models.deeptable import DeepTable
        return cls(DeepTable.load(filepath, device=device), **kwargs)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return int(math.ceil(n / self.buckets[-1]) * self.buckets[-1])

    def _forward(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        with annotate('deeptables.serve.forward'):
            logits, _ = self.model.forward_batch(batch)
        with annotate('deeptables.serve.copy_back'):
            return probas_from_logits(logits, self.task).cpu().numpy()

    def warmup(self):
        """Run every batch bucket once (loads the kernels, sizes the
        allocator's pools)."""
        cats = self.model.categorical_columns
        conts = self.model.continuous_columns
        for b in self.buckets:
            batch = {}
            if cats:
                batch[pipeline.CAT_KEY] = np.zeros((b, len(cats)), np.int32)
            for g in conts:
                batch[g.name] = np.zeros((b, g.input_dim), np.float32)
            for c in self.model.var_len_categorical_columns:
                batch[c.name] = np.zeros((b, c.max_elements_length or 1),
                                         np.int32)
            self._forward(batch)
        logger.info(f'warmed up buckets {self.buckets}')
        return self

    def predict_proba(self, X) -> np.ndarray:
        """Raw features (a DataFrame, a dict of 1-D arrays, ``Columns``) →
        probability matrix."""
        X_t = self.preprocessor.transform_X(X)
        arrays = pipeline.extract_arrays(
            X_t, self.model.categorical_columns,
            self.model.continuous_columns,
            self.model.var_len_categorical_columns)
        return self.predict_proba_arrays(arrays, len(X_t))

    def predict_proba_arrays(self, arrays: Dict[str, np.ndarray],
                             n: Optional[int] = None) -> np.ndarray:
        """Pre-packed arrays → probability matrix (hot serving path)."""
        if n is None:
            n = len(next(iter(arrays.values())))
        bucket = self._bucket_for(n)
        with annotate('deeptables.serve.request', request=next(_REQUEST_IDS),
                      rows=n, padded_rows=-n % bucket):
            outs = []
            for start in range(0, n, bucket):
                count = min(bucket, n - start)
                with annotate('deeptables.serve.pad'):
                    chunk = _rows(arrays, start, count, bucket)
                outs.append(self._forward(chunk)[:count])
            with annotate('deeptables.serve.copy_back'):
                proba = np.concatenate(outs)
                if self.task == consts.TASK_BINARY:
                    proba = fix_binary_predict_proba_result(proba)
        return proba

    def predict(self, X, encode_to_label=True):
        """Raw features → predicted labels (values for regression), decoded
        by the estimator's preprocessor."""
        proba = self.predict_proba(X)
        return self.dt.proba2predict(proba, encode_to_label=encode_to_label)


def export_predictor(deeptable, filepath: str):
    """Persist an estimator for serving (``DeepTable.save``'s layout, which
    :meth:`Predictor.load` reads)."""
    deeptable.save(filepath)
    return filepath
