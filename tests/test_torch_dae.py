# -*- coding:utf-8 -*-
"""The port's denoising auto-encoder (``deeptables_torch.fe.DAE``) against
the JAX package's (``deeptables_tpu.fe.DAE``), the twin of
``tests/test_aux.py::TestDAE``.

Tolerances: the forward and the mse gradient of one module with the JAX
module's parameters (``bridge.dae_params_from_flax``), float32: outputs
rtol 1e-5 with atol 1e-5, gradients within 1e-5 of each tensor's largest
(the same products, summed in another order). The swap-noise batches are
equal bit for bit: both packages draw them from one numpy generator in one
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_torch import bridge
from deeptables_torch.fe import DAE
from deeptables_torch.fe.dae import DAEModule
from deeptables_tpu.fe import DAE as JaxDAE
from deeptables_tpu.fe.dae import _DAEModule


def _x(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize('encoder_units,feature_units',
                         [((32, 32), 5), ((16, 24, 12), 3)])
def test_forward_and_gradient_match_flax(encoder_units, feature_units):
    X = _x(40, 7, 0)
    flax_module = _DAEModule(input_dim=7, encoder_units=encoder_units,
                             feature_units=feature_units)
    variables = jax.device_get(flax_module.init(jax.random.PRNGKey(3), X[:2]))
    module = DAEModule(7, encoder_units, feature_units)
    state = bridge.dae_params_from_flax(variables)
    assert set(state) == set(module.state_dict())
    module.load_state_dict(state)

    recon, feature = module(torch.from_numpy(X))
    j_recon, j_feature = flax_module.apply(variables, X)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(j_recon),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feature.detach().numpy(),
                               np.asarray(j_feature), rtol=1e-5, atol=1e-5)

    noisy = _x(40, 7, 1)

    def loss_fn(p):
        out, _ = flax_module.apply({'params': p}, noisy)
        return jnp.mean((out - X) ** 2)

    j_grads = bridge.dae_params_from_flax(
        {'params': jax.device_get(jax.grad(loss_fn)(variables['params']))})
    out, _ = module(torch.from_numpy(noisy))
    torch.mean((out - torch.from_numpy(X)) ** 2).backward()
    for name, p in module.named_parameters():
        want = j_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-12),
                                   err_msg=name)


def _record_noise(monkeypatch, cls):
    calls = []
    original = cls._swap_noise

    def recording(self, X, rng):
        out = original(self, X, rng)
        calls.append((X.copy(), out.copy()))
        return out
    monkeypatch.setattr(cls, '_swap_noise', recording)
    return calls


@pytest.mark.parametrize('min_delta', [0.001, 1e9])
def test_swap_noise_batches_equal_the_jax_package(monkeypatch, min_delta):
    """The same clean and noisy batches in the same order; with a
    ``min_delta`` no epoch can pass (1e9), both stop after the same epochs
    (``patience``)."""
    X = _x(96, 10, 2)
    kwargs = dict(encoder_units=(16, 16), feature_units=4, noise_rate=0.3,
                  seed=11)
    fit = dict(batch_size=32, epochs=8, patience=5, lr_patience=3,
               min_delta=min_delta, verbose=0)
    port_calls = _record_noise(monkeypatch, DAE)
    jax_calls = _record_noise(monkeypatch, JaxDAE)
    DAE(**kwargs).fit(X, device='cpu', **fit)
    JaxDAE(**kwargs).fit(X, **fit)
    steps = 96 // 32
    assert len(port_calls) == len(jax_calls) == steps * (
        8 if min_delta < 1 else 6)
    for (clean, noisy), (j_clean, j_noisy) in zip(port_calls, jax_calls):
        np.testing.assert_array_equal(clean, j_clean)
        np.testing.assert_array_equal(noisy, j_noisy)
        # a quarter of the row's 10 values (3) swapped at most
        assert ((noisy != clean).sum(axis=1) <= 3).all()


def test_fit_transform():
    X = _x(200, 10, 0)
    dae = DAE(encoder_units=(32, 32), feature_units=5, noise_rate=0.1)
    feats = dae.fit_transform(X, batch_size=64, epochs=10, verbose=0,
                              device='cpu')
    assert feats.shape == (200, 5)
    assert np.isfinite(feats).all()


def test_no_noise():
    X = _x(100, 6, 1)
    dae = DAE(encoder_units=(16, 16), feature_units=3, noise_rate=0)
    feats = dae.fit_transform(X, batch_size=32, epochs=5, verbose=0,
                              device='cpu')
    assert feats.shape == (100, 3)


def test_short_fit_lowers_the_reconstruction_error():
    X = np.abs(_x(256, 8, 4))
    dae = DAE(encoder_units=(32, 32), feature_units=4, noise_rate=0.1)

    def mse():
        recon, _ = dae.module(torch.from_numpy(X))
        return float(torch.mean((recon - torch.from_numpy(X)) ** 2))
    dae.build(8, 'cpu')
    with torch.no_grad():
        before = mse()
    dae.fit(X, batch_size=32, epochs=8, verbose=0, device='cpu')
    with torch.no_grad():
        after = mse()
    assert after < 0.8 * before


def test_transform_keeps_a_tensor_a_tensor():
    X = _x(50, 6, 5)
    dae = DAE(encoder_units=(8, 8), feature_units=2).fit(
        X, batch_size=16, epochs=2, verbose=0, device='cpu')
    out = dae.transform(torch.from_numpy(X), batch_size=16)
    assert isinstance(out, torch.Tensor) and out.shape == (50, 2)
    np.testing.assert_allclose(out.numpy(), dae.transform(X, batch_size=16,
                                                         device='cpu'),
                               rtol=0, atol=0)


def test_transform_before_fit_raises():
    with pytest.raises(ValueError, match='not fitted'):
        DAE().transform(_x(4, 3, 0), device='cpu')
