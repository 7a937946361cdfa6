# -*- coding:utf-8 -*-
"""The port's initializers and activations against the JAX package's.

The two frameworks draw different numbers from one seed, so an initializer
is held to flax's distribution: the same bounds, and mean and standard
deviation within 3% of the expected standard deviation (4 standard errors of
the sample moments at 131,072 draws). Activations are compared on the same
inputs at float32 atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.ops import initializers as jax_init
from deeptables_torch.ops import initializers

torch.set_num_threads(1)  # the suite runs several xdist workers

SHAPE = (256, 512)
NAMES = sorted(jax_init._REGISTRY)


@pytest.mark.parametrize('name', NAMES)
def test_initializer_matches_flax_distribution(name):
    expected = np.asarray(jax_init.get_initializer(name)(
        jax.random.PRNGKey(0), SHAPE, jnp.float32))
    actual = initializers.get_initializer(name)(
        torch.Generator().manual_seed(0), SHAPE).numpy()
    assert actual.shape == SHAPE and actual.dtype == np.float32
    std = float(expected.std())
    if std == 0:
        np.testing.assert_array_equal(actual, expected)
        return
    tol = 0.03 * std
    assert abs(actual.mean() - expected.mean()) <= tol, name
    assert abs(actual.std() - std) <= tol, name
    # uniform and truncated draws share their bounds with flax's
    bound = float(np.abs(expected).max())
    assert float(np.abs(actual).max()) <= bound * 1.02 + 1e-7, name


def test_default_and_unknown_initializer():
    assert initializers.get_initializer(None) is \
        initializers.get_initializer('glorot_uniform')
    with pytest.raises(ValueError):
        initializers.get_initializer('no_such_init')


@pytest.mark.parametrize('name', ['relu', 'tanh', 'sigmoid', 'gelu', 'elu',
                                  'selu', 'softmax', 'swish', 'silu',
                                  'linear', 'none', None])
def test_activation_matches_jax(name):
    x = np.random.default_rng(0).normal(0, 2, (16, 8)).astype(np.float32)
    expected = np.asarray(jax_init.get_activation(name)(jnp.asarray(x)))
    actual = initializers.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(actual, expected, rtol=1e-5, atol=1e-6)
