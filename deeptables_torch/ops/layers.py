# -*- coding:utf-8 -*-
"""flax ``nn.Dense`` and ``nn.BatchNorm`` as the JAX package uses them.

The JAX package calls flax's layers directly; the port needs their
semantics in torch:

- parameters are float32 and an input of another type is promoted to
  float32 first (flax's dtype promotion: a bfloat16 activation entering a
  Dense or BatchNorm leaves it as float32);
- a Dense kernel is drawn in flax's ``(in, out)`` layout with flax's default
  ``lecun_normal`` and stored transposed as ``weight (out, in)``; the bias
  starts at zero;
- BatchNorm normalizes the last axis with ``epsilon=1e-3`` and keeps
  ``weight``/``bias`` (flax ``scale``/``bias``) and
  ``running_mean``/``running_var`` (flax ``batch_stats`` ``mean``/``var``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import get_initializer


class Dense(nn.Module):
    def __init__(self, in_features: int, features: int, use_bias=True,
                 kernel_init='lecun_normal', generator=None):
        super().__init__()
        kernel = get_initializer(kernel_init)(generator, (in_features, features))
        self.weight = nn.Parameter(kernel.t().contiguous())
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm over the last axis of a ``(B, C)`` input.

    Training-mode statistics and the running-stat update (flax: biased
    batch variance, momentum 0.9) come with the training slice."""

    def __init__(self, num_features: int, epsilon=1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x, training=False):
        if training:
            raise NotImplementedError(
                'BatchNorm training statistics: training slice')
        return F.batch_norm(x.to(self.weight.dtype), self.running_mean,
                            self.running_var, self.weight, self.bias,
                            training=False, eps=self.epsilon)
