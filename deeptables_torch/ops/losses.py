# -*- coding:utf-8 -*-
"""Loss functions (counterpart of ``deeptables_tpu/ops/losses.py``).

Losses take **logits**, the labels and an optional per-example weight, and
return the scalar (weighted) mean, with the JAX package's formulas: sigmoid
and softmax cross-entropies on logits, the regression losses, the focal
losses in probability space (clipped) and the gradient-harmonizing GHMC
loss, whose momentum histogram is explicit state (:class:`GHMCLoss`).
"""

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.mesh import active_shard
from ..utils import consts

_EPS = 1e-7


def _weighted_mean(values: torch.Tensor,
                   sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    if sample_weight is None:
        return values.mean()
    sample_weight = sample_weight.reshape(values.shape)
    return (values * sample_weight).sum() / torch.clamp_min(
        sample_weight.sum(), _EPS)


def _sigmoid_bce(logits, y):
    """Per-element sigmoid cross-entropy on logits, the stable form."""
    return torch.clamp_min(logits, 0) - logits * y \
        + torch.log1p(torch.exp(-logits.abs()))


def _is_index_labels(y_true):
    return y_true.dim() == 1 or (y_true.dim() == 2 and y_true.shape[-1] == 1)


def binary_crossentropy(logits, y_true, sample_weight=None):
    """Sigmoid BCE on logits; y_true (B,) or (B, 1) in {0, 1}."""
    logits = logits.reshape(-1)
    y = y_true.reshape(-1).to(logits.dtype)
    return _weighted_mean(_sigmoid_bce(logits, y), sample_weight)


def categorical_crossentropy(logits, y_true, sample_weight=None):
    """Softmax CE on logits; y_true int labels (B,) or one-hot (B, C)."""
    logp = torch.log_softmax(logits, dim=-1)
    if _is_index_labels(y_true):
        idx = y_true.reshape(-1).to(torch.int64)
        per = -logp.gather(-1, idx[:, None]).reshape(-1)
    else:
        per = -(y_true.to(logp.dtype) * logp).sum(dim=-1)
    return _weighted_mean(per, sample_weight)


def multilabel_binary_crossentropy(logits, y_true, sample_weight=None):
    """Per-class sigmoid BCE averaged over classes; y_true (B, C)."""
    per = _sigmoid_bce(logits, y_true.to(logits.dtype)).mean(dim=-1)
    return _weighted_mean(per, sample_weight)


def _regression_error(logits, y_true):
    return logits.reshape(-1) - y_true.reshape(-1).to(logits.dtype)


def mse(logits, y_true, sample_weight=None):
    return _weighted_mean(torch.square(_regression_error(logits, y_true)),
                          sample_weight)


def mae(logits, y_true, sample_weight=None):
    return _weighted_mean(_regression_error(logits, y_true).abs(),
                          sample_weight)


def huber(logits, y_true, sample_weight=None, delta=1.0):
    err = _regression_error(logits, y_true)
    abs_err = err.abs()
    per = torch.where(abs_err <= delta, 0.5 * err * err,
                      delta * (abs_err - 0.5 * delta))
    return _weighted_mean(per, sample_weight)


def binary_focal_loss(gamma: float = 2., alpha: float = .25):
    """Binary focal loss: the mean of the positive- and negative-masked
    terms, in probability space (clipped)."""
    def loss(logits, y_true, sample_weight=None):
        p = torch.sigmoid(logits.reshape(-1))
        y = y_true.reshape(-1).to(p.dtype)
        pt_1 = torch.clamp(torch.where(y == 1, p, torch.ones_like(p)),
                           _EPS, 1. - _EPS)
        pt_0 = torch.clamp(torch.where(y == 0, p, torch.zeros_like(p)),
                           _EPS, 1. - _EPS)
        term1 = alpha * torch.pow(1. - pt_1, gamma) * torch.log(pt_1)
        term0 = (1 - alpha) * torch.pow(pt_0, gamma) * torch.log(1. - pt_0)
        if sample_weight is not None:
            w = sample_weight.reshape(-1)
            return -((term1 * w).sum() + (term0 * w).sum()) / torch.clamp_min(
                w.sum(), _EPS)
        return -term1.mean() - term0.mean()
    loss.__name__ = 'binary_focal_loss'
    return loss


def categorical_focal_loss(gamma: float = 2., alpha: float = .25):
    """Softmax focal loss."""
    def loss(logits, y_true, sample_weight=None):
        p = torch.clamp(torch.softmax(logits, dim=-1), _EPS, 1. - _EPS)
        if _is_index_labels(y_true):
            y = torch.nn.functional.one_hot(
                y_true.reshape(-1).to(torch.int64),
                logits.shape[-1]).to(p.dtype)
        else:
            y = y_true.to(p.dtype)
        ce = -y * torch.log(p)
        per = (alpha * torch.pow(1. - p, gamma) * ce).sum(dim=1)
        return _weighted_mean(per, sample_weight)
    loss.__name__ = 'categorical_focal_loss'
    return loss


class GHMCLoss:
    """Gradient-Harmonizing-Mechanism classification loss.

    Each element is weighted by the inverse density of its gradient-norm
    bin, ``|sigmoid(logit) - y|``. With ``momentum > 0`` the bin counts are
    an EMA carried across steps as explicit state:

    - ``init_state()`` → the initial ``(bins,)`` float32 counts;
    - ``loss(logits, y, w, state=s)`` → ``(loss, new_state)``;
    - ``loss(logits, y, w)`` (no state, as in validation) weighs by the
      batch's own counts and updates nothing.

    The bins, the weights and the new state are indicator functions of the
    logits: they are computed without gradient, as the JAX package's
    ``stop_gradient`` does. ``sample_weight`` is not used.

    The loss is ``Σ_i bce_i / (count(bin_i) · valid bins)``, a sum over the
    batch's elements: in a data-parallel step (``parallel.mesh.
    active_shard``) the bin counts are summed over the ranks, and each rank
    returns its elements' share of the global loss (the shares add up to
    it), so ``rank_share`` is True.
    """

    rank_share = True

    def __init__(self, bins: int = 10, momentum: float = 0.75):
        self.bins = bins
        self.momentum = momentum
        self.stateful = momentum > 0
        self.__name__ = 'ghmc_loss'
        self._edges_left = torch.tensor([i / bins for i in range(bins)],
                                        dtype=torch.float32)
        edges_right = torch.tensor([(i + 1) / bins for i in range(bins)],
                                   dtype=torch.float32)
        edges_right[-1] += 1e-6
        self._edges_right = edges_right

    def init_state(self) -> torch.Tensor:
        return torch.zeros((self.bins,), dtype=torch.float32)

    def __call__(self, logits, y_true, sample_weight=None, state=None):
        logits2 = logits.reshape(logits.shape[0], -1)
        target = y_true.reshape(logits2.shape).to(logits2.dtype)
        tot = max(float(logits2.shape[0] * logits2.shape[1]), 1.0)
        new_state = None
        with torch.no_grad():
            g = (torch.sigmoid(logits2) - target).abs()  # (B, C)
            left = self._edges_left.to(g.device)[:, None, None]
            right = self._edges_right.to(g.device)[:, None, None]
            inds = ((g[None] >= left) & (g[None] < right)).to(logits2.dtype)
            num_in_bin = inds.sum(dim=(1, 2))  # (bins,)
            shard = active_shard()
            if shard is not None:  # the global batch's histogram
                dist.all_reduce(num_in_bin, group=shard.group)
            num_valid_bin = (num_in_bin > 0).to(logits2.dtype).sum()
            if state is not None and self.momentum > 0:
                mmt = self.momentum
                new_state = torch.where(num_in_bin > 0,
                                        mmt * state + (1 - mmt) * num_in_bin,
                                        state)
                denom = new_state.to(logits2.dtype)
            else:
                denom = num_in_bin
            weights = torch.where(
                inds == 1, tot / torch.clamp_min(denom, _EPS)[:, None, None],
                torch.zeros((), dtype=logits2.dtype, device=g.device))
            weights = weights.sum(dim=0) / torch.clamp_min(num_valid_bin, 1.0)
        loss = (_sigmoid_bce(logits2, target) * weights).sum() / tot
        if state is not None:
            return loss, (new_state if new_state is not None else state)
        return loss


def ghmc_loss(bins: int = 10, momentum: float = 0.0):
    """Factory form of :class:`GHMCLoss` (stateless by default)."""
    return GHMCLoss(bins=bins, momentum=momentum)


# keras-style names accepted in ModelConfig.loss, as the JAX package's
_LOSSES = {
    'binary_crossentropy': binary_crossentropy,
    'bce': binary_crossentropy,
    'categorical_crossentropy': categorical_crossentropy,
    'sparse_categorical_crossentropy': categorical_crossentropy,
    'cce': categorical_crossentropy,
    'mse': mse,
    'mean_squared_error': mse,
    'mae': mae,
    'mean_absolute_error': mae,
    'huber': huber,
    'multilabel_binary_crossentropy': multilabel_binary_crossentropy,
    'binary_focal_loss': binary_focal_loss(),
    'categorical_focal_loss': categorical_focal_loss(),
    'ghmc': GHMCLoss(momentum=0.75),
}
_LOSSES['ghmc_loss'] = _LOSSES['ghmc']


def get_loss(identifier):
    """Resolve a loss name or callable to ``fn(logits, y_true,
    sample_weight)`` (a stateful loss also takes ``state=``)."""
    if callable(identifier):
        return identifier
    key = str(identifier).lower()
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
