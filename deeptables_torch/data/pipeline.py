# -*- coding:utf-8 -*-
"""Host-side input pipeline: columns → dict of dense numpy arrays → batches.

The port's copy of ``deeptables_tpu/data/pipeline.py``. The packing
convention is the same: all categorical columns in one int32 array under
``CAT_KEY``, one float32 array per continuous group, one int32 array per
var-len column. Batches stay numpy here; the model moves them to its device.
"""

import math
from typing import Dict, List, Optional

import numpy as np

from .columns import isna
from ..models.metainfo import CategoricalColumn, ContinuousColumn, \
    VarLenCategoricalColumn
from ..utils import consts

CAT_KEY = 'cat'


def extract_arrays(X,
                   categorical_columns: Optional[List[CategoricalColumn]],
                   continuous_columns: Optional[List[ContinuousColumn]],
                   var_len_columns: Optional[List[VarLenCategoricalColumn]] = None
                   ) -> Dict[str, np.ndarray]:
    """Pack preprocessed columns (``data.columns.Columns`` or a DataFrame;
    a column is read as ``np.asarray(X[name])``, so pandas is not
    imported) into the model's input dict; missing values become 0."""
    def stacked(names, dtype):
        values = np.empty((len(X), len(names)), dtype=dtype)
        for j, name in enumerate(names):
            col = np.asarray(X[name])
            if col.dtype.kind in 'fO':
                col = np.where(isna(col), 0, col)
            values[:, j] = col
        return values

    arrays = {}
    if categorical_columns:
        arrays[CAT_KEY] = stacked([c.name for c in categorical_columns],
                                  np.int32)
    if continuous_columns:
        for group in continuous_columns:
            arrays[group.name] = stacked(group.column_names, np.float32)
    if var_len_columns:
        for col in var_len_columns:
            seqs = np.asarray(X[col.name])
            max_len = col.max_elements_length
            if seqs.ndim == 2:
                out = np.zeros((len(seqs), max_len), dtype=np.int32)
                width = min(max_len, seqs.shape[1])
                out[:, :width] = seqs[:, :width]
            else:
                out = np.zeros((len(seqs), max_len), dtype=np.int32)
                for i, s in enumerate(seqs):
                    s = np.asarray(s, dtype=np.int32).reshape(-1)[:max_len]
                    out[i, :len(s)] = s
            arrays[col.name] = out
    if not arrays:
        raise ValueError('No input columns; X produced an empty feature set.')
    return arrays


def check_categorical_ids(cat: np.ndarray,
                          categorical_columns: List[CategoricalColumn]):
    """Raise unless every id of column j lies in [0, vocabulary_size_j).

    An out-of-range row index aborts a CUDA gather with a device-side
    assertion that poisons the whole CUDA context, so ids are checked on the
    host before they reach the device."""
    cat = np.asarray(cat)
    if cat.ndim != 2 or cat.shape[1] != len(categorical_columns):
        raise ValueError(
            f'categorical input has shape {cat.shape}, expected '
            f'(n, {len(categorical_columns)}).')
    if cat.size == 0:
        return
    vocab = np.asarray([c.vocabulary_size for c in categorical_columns])
    bad = (cat < 0) | (cat >= vocab)
    if bad.any():
        row, col = np.argwhere(bad)[0]
        raise ValueError(
            f'categorical id {cat[row, col]} at row {row} is out of range for '
            f'column {categorical_columns[col].name!r} '
            f'(vocabulary_size={vocab[col]}).')


def check_var_len_ids(ids: np.ndarray, column: VarLenCategoricalColumn):
    """Raise unless every token id of a var-len column lies in
    [0, vocabulary_size) (0 pads), for the reason ``check_categorical_ids``
    gives."""
    ids = np.asarray(ids)
    bad = (ids < 0) | (ids >= column.vocabulary_size)
    if bad.any():
        row, pos = np.argwhere(bad)[0]
        raise ValueError(
            f'token id {ids[row, pos]} at row {row} is out of range for '
            f'var-len column {column.name!r} '
            f'(vocabulary_size={column.vocabulary_size}).')


def prepare_labels(y, task: str, num_classes: int) -> np.ndarray:
    """Encode labels into the dense array the loss expects."""
    y = np.asarray(y)
    if task == consts.TASK_MULTICLASS:
        return y.reshape(-1).astype(np.int32)
    if task == consts.TASK_MULTILABEL:
        return y.reshape(len(y), -1).astype(np.float32)
    if task == consts.TASK_REGRESSION:
        return y.reshape(-1).astype(np.float32)
    return y.reshape(-1).astype(np.float32)  # binary


def num_batches(n: int, batch_size: int, drop_remainder: bool) -> int:
    if drop_remainder:
        return max(n // batch_size, 1)
    return math.ceil(n / batch_size)


class BatchIterator:
    """Mini-batch iterator over packed arrays.

    - training: shuffled epochs, remainder dropped, every batch the same
      shape.
    - inference: in-order, last batch zero-padded to the full batch size with
      ``valid`` counting real rows.
    """

    def __init__(self, arrays: Dict[str, np.ndarray],
                 y: Optional[np.ndarray] = None,
                 sample_weight: Optional[np.ndarray] = None,
                 batch_size: int = 128, shuffle: bool = True,
                 drop_remainder: bool = True, seed: int = 0,
                 pad_multiple: int = 1):
        self.arrays = arrays
        self.y = y
        self.sample_weight = sample_weight
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        # every batch length must divide pad_multiple; padded rows carry
        # weight 0 and are sliced off after inference
        self.pad_multiple = max(int(pad_multiple), 1)
        self.n = len(next(iter(arrays.values())))
        if self.n < self.batch_size:
            # small datasets: a single batch of n rows
            self.drop_remainder = False
        self._rng = np.random.default_rng(seed)

    @property
    def steps(self) -> int:
        return num_batches(self.n, self.batch_size, self.drop_remainder)

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        pm = self.pad_multiple
        for step in range(self.steps):
            sel = idx[step * bs:(step + 1) * bs]
            valid = len(sel)
            pad = 0
            if not self.drop_remainder and valid < bs and self.n >= bs:
                pad = bs - valid
            elif valid % pm != 0:
                pad = pm - valid % pm
            if pad > 0:
                sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
            batch = {k: v[sel] for k, v in self.arrays.items()}
            yb = self.y[sel] if self.y is not None else None
            wb = None
            if self.sample_weight is not None:
                wb = self.sample_weight[sel].astype(np.float32)
            if pad > 0:
                wb = np.ones(len(sel), dtype=np.float32) if wb is None \
                    else wb.copy()
                wb[valid:] = 0.0
            yield batch, yb, wb, valid


def class_weight_to_sample_weight(y: np.ndarray, class_weight: dict
                                  ) -> np.ndarray:
    """Per-example weights from a ``{class: weight}`` map (others weigh 1)."""
    w = np.ones(len(y), dtype=np.float32)
    yy = np.asarray(y).reshape(-1)
    for cls, cw in class_weight.items():
        w[yy == int(cls)] = float(cw)
    return w
