# -*- coding:utf-8 -*-
"""Denoising auto-encoder for feature extraction (counterpart of
``deeptables_tpu/fe/dae.py``).

A symmetric encoder stack, a ``feature_layer`` bottleneck and the decoder,
trained to rebuild clean rows from swap-noised ones with the mean squared
error and Adam; the learning rate halves on a plateau, training stops early,
and the best epoch's parameters are kept. ``fit_transform`` returns the
bottleneck features. The layers carry the flax names (``encoder_{i}``,
``feature_layer``, ``decoder_{i}``, ``output_layer``), so
``bridge.dae_params_from_flax`` maps a JAX DAE's parameters one to one.

The parameters are drawn on the CPU from ``seed`` and then moved, so a DAE
starts from the same weights on every device; the swap noise and the epoch
permutations come from ``np.random.default_rng(seed)`` in the JAX package's
order, so both packages train on the same noisy batches.
"""

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops.initializers import get_activation
from ..ops.layers import Dense
from ..utils import dt_logging
from ..utils.device import resolve_device

logger = dt_logging.get_logger(__name__)


class DAEModule(nn.Module):
    """input → ``encoder_{i}`` (``encoder_units[i + 1]`` units, the
    activation) → ``feature_layer`` (``feature_units``, linear) →
    ``decoder_{i}`` (``encoder_units[i]``, i from the last down to 1) →
    ``output_layer`` (the input's width, the activation). ``forward``
    returns (reconstruction, features), float32."""

    def __init__(self, input_dim: int, encoder_units: Tuple[int, ...],
                 feature_units: int, activation: str = 'relu',
                 kernel_initializer: str = 'glorot_uniform', generator=None):
        super().__init__()
        self.activation = get_activation(activation)
        self.n_stacks = len(encoder_units) - 1
        width = input_dim
        for i in range(self.n_stacks):
            self.add_module(f'encoder_{i}', Dense(
                width, encoder_units[i + 1], kernel_init=kernel_initializer,
                generator=generator))
            width = encoder_units[i + 1]
        self.feature_layer = Dense(width, feature_units,
                                   kernel_init=kernel_initializer,
                                   generator=generator)
        width = feature_units
        for i in range(self.n_stacks, 0, -1):
            self.add_module(f'decoder_{i}', Dense(
                width, encoder_units[i], kernel_init=kernel_initializer,
                generator=generator))
            width = encoder_units[i]
        self.output_layer = Dense(width, input_dim,
                                  kernel_init=kernel_initializer,
                                  generator=generator)

    def forward(self, x):
        act = self.activation
        for i in range(self.n_stacks):
            x = act(getattr(self, f'encoder_{i}')(x))
        feature = self.feature_layer(x)
        x = feature
        for i in range(self.n_stacks, 0, -1):
            x = act(getattr(self, f'decoder_{i}')(x))
        return act(self.output_layer(x)), feature


class DAE:
    """The JAX package's ``DAE`` with the same arguments. ``optimizer`` is
    accepted and not read, as there: training always runs Adam (optax's
    defaults: betas 0.9/0.999, eps 1e-8 outside the square root) at
    ``learning_rate``. ``fit`` and ``transform`` run on ``device`` (default:
    the current CUDA device; ``'cpu'`` runs the plain path)."""

    def __init__(self, encoder_units=(500, 500), feature_units=20,
                 activation='relu', kernel_initializer='glorot_uniform',
                 optimizer=None, noise_rate=0, learning_rate=0.001,
                 seed=9527):
        self.encoder_units = tuple(encoder_units)
        self.feature_units = feature_units
        self.activation = activation
        self.kernel_initializer = kernel_initializer
        self.learning_rate = learning_rate
        self.optimizer = optimizer
        self.noise_rate = noise_rate
        self.seed = seed
        self.module = None

    def build(self, input_dim: int, device=None) -> DAEModule:
        """A new module of ``input_dim`` inputs, drawn from ``seed`` on the
        CPU and moved to ``device``."""
        generator = torch.Generator().manual_seed(self.seed)
        self.module = DAEModule(
            input_dim, self.encoder_units, self.feature_units,
            self.activation, self.kernel_initializer,
            generator).to(resolve_device(device))
        return self.module

    def _swap_noise(self, X, rng):
        """Swap-noise: replace a fraction of each row's values with the same
        column's values from another random row (the JAX package's draws, in
        its order)."""
        n, d = X.shape
        num_swap = int(d * self.noise_rate)
        if num_swap <= 0:
            return X
        out = X.copy()
        donor = X[rng.integers(0, n, n)]
        for i in range(n):
            idx = rng.choice(d, num_swap, replace=False)
            out[i, idx] = donor[i, idx]
        return out

    def fit(self, X, batch_size=128, epochs=1000, patience=5,
            lr_patience=3, min_delta=0.001, verbose=1, device=None):
        """Train from the initial weights of ``seed``: shuffled batches of
        ``batch_size`` rows (the remainder dropped), the mse of the
        reconstruction of the clean rows; an epoch's mse is the mean of its
        steps'. An epoch ``min_delta`` under the best keeps its parameters;
        ``lr_patience`` epochs without halve the learning rate (not under
        1e-6), ``patience`` epochs without stop. The best parameters are
        kept."""
        X = np.asarray(X, dtype=np.float32)
        n, d = X.shape
        module = self.build(d, device)
        device = next(module.parameters()).device
        rng_np = np.random.default_rng(self.seed)
        lr = self.learning_rate
        opt = torch.optim.Adam(module.parameters(), lr=lr,
                               betas=(0.9, 0.999), eps=1e-8)
        best = np.inf
        best_state = {k: v.detach().clone()
                      for k, v in module.state_dict().items()}
        wait = 0
        lr_wait = 0
        steps = max(n // batch_size, 1)
        for epoch in range(epochs):
            perm = rng_np.permutation(n)
            losses = []
            for s in range(steps):
                sel = perm[s * batch_size:(s + 1) * batch_size]
                clean = X[sel]
                noisy = self._swap_noise(clean, rng_np) \
                    if self.noise_rate > 0 else clean
                clean_t = torch.from_numpy(clean).to(device)
                recon, _ = module(torch.from_numpy(noisy).to(device))
                loss = torch.mean((recon - clean_t) ** 2)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            mse = float(torch.stack(losses).mean())
            if verbose and (epoch % 10 == 0 or epoch == epochs - 1):
                logger.info(f'DAE epoch {epoch}: mse={mse:.5f}')
            if mse < best - min_delta:
                best = mse
                best_state = {k: v.detach().clone()
                              for k, v in module.state_dict().items()}
                wait = 0
                lr_wait = 0
            else:
                wait += 1
                lr_wait += 1
                if lr_wait >= lr_patience:
                    lr = max(lr * 0.5, 1e-6)
                    for group in opt.param_groups:
                        group['lr'] = lr
                    lr_wait = 0
                    if verbose:
                        logger.info(f'DAE: reduce lr to {lr}')
                if wait >= patience:
                    if verbose:
                        logger.info(f'DAE: early stop at epoch {epoch}')
                    break
        module.load_state_dict(best_state)
        return self

    def transform(self, X, batch_size=128, device=None):
        """The bottleneck features of X, ``batch_size`` rows at a time. A
        tensor gives a tensor on ``device`` (default: its own), with no copy
        to the host; anything else a numpy array, computed on ``device``
        (default: the current CUDA device)."""
        if self.module is None:
            raise ValueError('DAE is not fitted: call fit first.')
        as_tensor = isinstance(X, torch.Tensor)
        if device is None and as_tensor:
            device = X.device
        device = resolve_device(device)
        module = self.module.to(device)
        X = X.to(device, torch.float32) if as_tensor else \
            torch.from_numpy(np.asarray(X, dtype=np.float32)).to(device)
        with torch.inference_mode():
            out = torch.cat([module(X[s:s + batch_size])[1]
                             for s in range(0, len(X), batch_size)])
        return out if as_tensor else out.cpu().numpy()

    def fit_transform(self, X, batch_size=128, epochs=1000, device=None,
                      **kwargs):
        self.fit(X, batch_size=batch_size, epochs=epochs, device=device,
                 **kwargs)
        return self.transform(X, batch_size=batch_size, device=device)
