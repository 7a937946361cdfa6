# -*- coding:utf-8 -*-
"""flax ``nn.Dense`` and ``nn.BatchNorm`` as the JAX package uses them.

The JAX package calls flax's layers directly; the port needs their
semantics in torch:

- parameters are float32 and an input of another type is promoted to
  float32 first (flax's dtype promotion: a bfloat16 activation entering a
  Dense or BatchNorm leaves it as float32), unless a Dense is called with a
  compute ``dtype`` (flax's ``nn.Dense(dtype=...)``, as AutoInt's
  projections take ``dtype=x.dtype``): then the input, the kernel and the
  bias are cast to it, the product and the bias add each round to it, and
  the output has it;
- a Dense kernel is drawn in flax's ``(in, out)`` layout with flax's default
  ``lecun_normal`` and stored transposed as ``weight (out, in)``; the bias
  starts at zero;
- BatchNorm normalizes the last axis, its statistics over every other
  axis (a ``(B, F, U)`` input as ``B·F`` rows), with ``epsilon=1e-3``, and
  keeps ``weight``/``bias`` (flax ``scale``/``bias``) and
  ``running_mean``/``running_var`` (flax ``batch_stats`` ``mean``/``var``);
- a convolution (flax ``nn.Conv`` with ``padding='SAME'``) takes flax's
  NHWC input, keeps its kernel drawn in flax's ``(kh, kw, in, out)`` layout
  and stored as ``weight (out, in, kh, kw)``, pads as XLA's ``SAME`` does
  (the odd pad at the end) and runs as an im2col matrix product;
- dropout (flax ``nn.Dropout``) keeps an element with probability ``1 − rate``
  and scales it by ``1 / (1 − rate)``; its mask comes from an explicit
  ``torch.Generator``, as flax's comes from an explicit key.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.nn.functional import all_reduce

from ..parallel.mesh import active_shard
from .initializers import get_initializer


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            broadcast_dims: Sequence[int] = ()) -> torch.Tensor:
    """Training-mode dropout of ``x`` with a mask drawn from ``generator``
    (on x's device); the mask is shared along ``broadcast_dims``. In a
    data-parallel step (``parallel.mesh.active_shard``) the mask is drawn
    for the global batch, as one process would draw it, and this rank keeps
    its rows (axis 0)."""
    if rate <= 0:
        return x
    if generator is None:
        raise ValueError('dropout in training needs a torch.Generator '
                         '(DeepModel owns one; pass it through the trace '
                         'context).')
    if rate >= 1:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    shape = [1 if i in broadcast_dims else s for i, s in enumerate(x.shape)]
    shard = active_shard()
    if shard is not None and 0 not in broadcast_dims:
        # a data-parallel step: the global batch's mask, this rank's rows
        shape[0] *= shard.size
        mask = torch.rand(shape, generator=generator, device=x.device)[
            shard.rows(shape[0])] < keep
    else:
        mask = torch.rand(shape, generator=generator,
                          device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Dense(nn.Module):
    def __init__(self, in_features: int, features: int, use_bias=True,
                 kernel_init='lecun_normal', generator=None):
        super().__init__()
        kernel = get_initializer(kernel_init)(generator, (in_features, features))
        self.weight = nn.Parameter(kernel.t().contiguous())
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x, dtype: Optional[torch.dtype] = None):
        """``dtype`` None promotes x to the float32 parameters; a compute
        type casts x, the kernel and the bias to it."""
        if dtype is None:
            return F.linear(x.to(self.weight.dtype), self.weight, self.bias)
        y = torch.matmul(x.to(dtype), self.weight.to(dtype).t())
        return y if self.bias is None else y + self.bias.to(dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis of a ``(..., C)`` input, as flax 0.12's
    ``nn.BatchNorm(momentum=0.9, epsilon=1e-3)`` computes it: the leading
    axes are one axis of rows.

    Training: float32 batch statistics ``mean = E[x]`` and the biased "fast"
    variance ``var = max(E[x²] − E[x]², 0)``; the output is normalized with
    them, the gradient flows through them, and the running statistics move
    to ``0.9·running + 0.1·batch``. (``F.batch_norm(training=True)`` would
    update ``running_var`` with the unbiased variance.)

    In a data-parallel step (``parallel.mesh.active_shard``) the statistics
    are the global batch's, as the JAX package's ``jit`` over a
    data-sharded batch computes them: the ranks' sums and sums of squares
    are summed (``torch.distributed.nn.functional.all_reduce``, through
    which the gradient flows), so every rank normalises alike and keeps the
    same running statistics. (``nn.SyncBatchNorm`` refuses CPU tensors.)"""

    momentum = 0.9

    def __init__(self, num_features: int, epsilon=1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x, training=False):
        shape = x.shape
        x = x.to(self.weight.dtype).reshape(-1, shape[-1])
        if not training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.epsilon).reshape(shape)
        shard = active_shard()
        if shard is None:
            mean = x.mean(dim=0)
            var = torch.clamp_min((x * x).mean(dim=0) - mean * mean, 0.)
        else:
            # the global batch's statistics: the ranks' sums, summed by a
            # differentiable all_reduce (its backward sums the gradients)
            sums = all_reduce(torch.stack([x.sum(dim=0), (x * x).sum(dim=0)]),
                              group=shard.group)
            n = x.shape[0] * shard.size
            mean = sums[0] / n
            var = torch.clamp_min(sums[1] / n - mean * mean, 0.)
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_(
                mean.detach(), alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var.detach(), alpha=1 - self.momentum)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return ((x - mean) * mul + self.bias).reshape(shape)


def same_pads(size: int, window: int, stride: int = 1):
    """XLA's ``SAME`` padding of one axis: ``(low, high)``, the odd one at
    the end, so that the output has ``ceil(size / stride)`` entries."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """flax ``nn.Conv(features, kernel_size, padding='SAME')`` over an NHWC
    input (flax's layout), stride 1, with a bias. The kernel is drawn in
    flax's ``(kh, kw, in, out)`` layout, so its fans are flax's, and stored
    as ``weight (out, in, kh, kw)``.

    The convolution is an im2col product: the input's ``kh·kw`` shifted
    windows side by side, times the kernel as one matrix. Its backward is
    the matrix products' and the slices', with no atomic adds, so a CUDA
    step gives the same bits every run (cuDNN may take a weight-gradient
    algorithm that adds with atomics, unless the process sets
    ``torch.backends.cudnn.deterministic``, which is not a library's to
    set)."""

    def __init__(self, in_channels: int, features: int, kernel_size,
                 kernel_init='lecun_normal', generator=None):
        super().__init__()
        kh, kw = kernel_size
        kernel = get_initializer(kernel_init)(
            generator, (kh, kw, in_channels, features))
        self.weight = nn.Parameter(kernel.permute(3, 2, 0, 1).contiguous())
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        """``x`` (B, H, W, C), promoted to the float32 parameters → (B, H,
        W, features)."""
        features, channels, kh, kw = self.weight.shape
        B, H, W = x.shape[:3]
        top, bottom = same_pads(H, kh)
        left, right = same_pads(W, kw)
        x = F.pad(x.to(self.weight.dtype), (0, 0, left, right, top, bottom))
        cols = torch.stack([x[:, i:i + H, j:j + W] for i in range(kh)
                            for j in range(kw)], dim=3)  # (B, H, W, K, C)
        kernel = self.weight.permute(2, 3, 1, 0).reshape(-1, features)
        out = torch.matmul(cols.reshape(B * H * W, kh * kw * channels),
                           kernel) + self.bias
        return out.reshape(B, H, W, features)
