# -*- coding:utf-8 -*-
"""Loss functions (counterpart of ``deeptables_tpu/ops/losses.py``).

Losses take **logits**, the labels and an optional per-example weight, and
return the scalar (weighted) mean. Ported so far: the binary cross-entropy
of the DeepFM main path, with the JAX package's stable formula. The other
losses and the stateful GHMC loss come with the heads-and-losses slice
(ROADMAP Queue 1 item 11) and raise ``NotImplementedError`` until then.
"""

from typing import Optional

import torch

from ..utils import consts

_EPS = 1e-7


def _weighted_mean(values: torch.Tensor,
                   sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    if sample_weight is None:
        return values.mean()
    sample_weight = sample_weight.reshape(values.shape)
    return (values * sample_weight).sum() / torch.clamp_min(
        sample_weight.sum(), _EPS)


def binary_crossentropy(logits, y_true, sample_weight=None):
    """Sigmoid BCE on logits; y_true (B,) or (B, 1) in {0, 1}."""
    logits = logits.reshape(-1)
    y = y_true.reshape(-1).to(logits.dtype)
    per = torch.clamp_min(logits, 0) - logits * y \
        + torch.log1p(torch.exp(-logits.abs()))
    return _weighted_mean(per, sample_weight)


_LOSSES = {'binary_crossentropy': binary_crossentropy,
           'bce': binary_crossentropy}
# names the JAX package accepts and the port does not yet
_NOT_PORTED = frozenset({
    'categorical_crossentropy', 'sparse_categorical_crossentropy', 'cce',
    'mse', 'mean_squared_error', 'mae', 'mean_absolute_error', 'huber',
    'multilabel_binary_crossentropy', 'binary_focal_loss',
    'categorical_focal_loss', 'ghmc', 'ghmc_loss'})
_LATER = 'the heads-and-losses slice (ROADMAP Queue 1 item 11)'


def get_loss(identifier):
    """Resolve a loss name or callable to ``fn(logits, y_true,
    sample_weight)``; a loss that is not ported yet raises
    ``NotImplementedError``."""
    if callable(identifier):
        if getattr(identifier, 'stateful', False):
            raise NotImplementedError(
                f'stateful losses (GHMC) come with {_LATER}.')
        return identifier
    key = str(identifier).lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f'loss {identifier!r} is not ported to deeptables_torch yet: it '
            f'comes with {_LATER}.')
    if key not in _LOSSES:
        raise ValueError(f'Unknown loss: {identifier!r}')
    return _LOSSES[key]


def auto_loss_name(task, num_classes):
    """The loss ``loss='auto'`` selects for a task, as the JAX package does."""
    if task == consts.TASK_BINARY:
        return 'binary_crossentropy'
    if task == consts.TASK_MULTILABEL:
        return 'multilabel_binary_crossentropy'
    if task == consts.TASK_REGRESSION:
        return 'mse'
    if task == consts.TASK_MULTICLASS:
        return 'categorical_crossentropy'
    raise RuntimeError(f'unseen task "{task}"')
