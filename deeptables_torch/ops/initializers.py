# -*- coding:utf-8 -*-
"""Keras-name initializers and activations (counterpart of
``deeptables_tpu/ops/initializers.py``).

An initializer is ``init(generator, shape, dtype=torch.float32)`` and returns
a new CPU tensor drawn from ``generator``; the caller moves it to its device,
so a model has the same weights on every device for the same seed. Shapes
follow flax's convention (a dense kernel is ``(in, out)``) and the
distributions are flax's: ``variance_scaling`` with fans taken from the last
two axes, truncated normals cut at ±2σ and rescaled by 0.8796… as
``jax.nn.initializers`` does. The numbers differ from JAX's for the same seed;
weights are carried across with ``deeptables_torch.bridge``.
"""

import math

import torch
import torch.nn.functional as F

# stddev of a unit normal truncated to [-2, 2]
_TRUNCATED_STDDEV = .87962566103423978


def _fans(shape):
    if len(shape) < 2:
        raise ValueError(f'variance scaling needs a shape of rank >= 2, '
                         f'got {tuple(shape)}')
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def variance_scaling(scale, mode, distribution):
    def init(generator, shape, dtype=torch.float32):
        fan_in, fan_out = _fans(shape)
        fan = {'fan_in': fan_in, 'fan_out': fan_out,
               'fan_avg': (fan_in + fan_out) / 2}[mode]
        variance = scale / fan
        out = torch.empty(shape, dtype=dtype)
        if distribution == 'truncated_normal':
            std = math.sqrt(variance) / _TRUNCATED_STDDEV
            return torch.nn.init.trunc_normal_(
                out, 0., std, -2 * std, 2 * std, generator=generator)
        if distribution == 'normal':
            return out.normal_(0., math.sqrt(variance), generator=generator)
        limit = math.sqrt(3 * variance)
        return out.uniform_(-limit, limit, generator=generator)
    return init


def _random_uniform(minval=-0.05, maxval=0.05):
    def init(generator, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype).uniform_(
            minval, maxval, generator=generator)
    return init


def _random_normal(stddev=0.05):
    def init(generator, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype).normal_(
            0., stddev, generator=generator)
    return init


def _constant(value):
    def init(generator, shape, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype)
    return init


_REGISTRY = {
    'uniform': _random_uniform(),
    'random_uniform': _random_uniform(),
    'normal': _random_normal(),
    'random_normal': _random_normal(),
    'glorot_uniform': variance_scaling(1.0, 'fan_avg', 'uniform'),
    'glorot_normal': variance_scaling(1.0, 'fan_avg', 'truncated_normal'),
    'he_uniform': variance_scaling(2.0, 'fan_in', 'uniform'),
    'he_normal': variance_scaling(2.0, 'fan_in', 'truncated_normal'),
    'lecun_uniform': variance_scaling(1.0, 'fan_in', 'uniform'),
    'lecun_normal': variance_scaling(1.0, 'fan_in', 'truncated_normal'),
    'zeros': _constant(0.),
    'ones': _constant(1.),
}


def get_initializer(identifier, default='glorot_uniform'):
    """Resolve a keras-style initializer name (or callable) to an init fn."""
    if identifier is None:
        identifier = default
    if callable(identifier):
        return identifier
    key = str(identifier).lower()
    if key not in _REGISTRY:
        raise ValueError(f'Unknown initializer: {identifier!r}')
    return _REGISTRY[key]


def _identity(x):
    return x


def get_activation(identifier):
    """Resolve a keras-style activation name (or callable) to a torch fn.

    'gelu' is the tanh approximation, as ``jax.nn.gelu`` computes it by
    default."""
    if identifier is None:
        return _identity
    if callable(identifier):
        return identifier
    key = str(identifier).lower()
    table = {
        'relu': F.relu,
        'tanh': torch.tanh,
        'sigmoid': torch.sigmoid,
        'gelu': lambda x: F.gelu(x, approximate='tanh'),
        'elu': F.elu,
        'selu': F.selu,
        'softmax': lambda x: torch.softmax(x, dim=-1),
        'swish': F.silu,
        'silu': F.silu,
        'linear': _identity,
        'none': _identity,
    }
    if key not in table:
        raise ValueError(f'Unknown activation: {identifier!r}')
    return table[key]
