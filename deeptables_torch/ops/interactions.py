# -*- coding:utf-8 -*-
"""Feature-interaction blocks (counterpart of
``deeptables_tpu/ops/interactions.py``).

Ported: ``FM`` and ``CIN``; the other blocks come with the slices that
carry their nets (see ``models/deepnets.py``).
"""

from typing import Any, Dict

import torch
from torch import nn

from ..utils import dt_logging
from .cin_grad import cin_contract, cin_contract_bm
from .embedding import concat_embeddings
from .initializers import get_activation, get_initializer
from .kernels.fm import fm
from .layers import Dense


class FM(nn.Module):
    """Factorization Machine order-2 pooling, (B, F, D) → (B, 1):
    ``0.5 · Σ_d [(Σ_f x)² − Σ_f x²]``. No parameters.

    Runs the FM kernel (``ops/kernels/fm.py``) on a CUDA input; the output
    has the input's type. An input that needs a gradient (training) goes
    through ``FMFunction``, whose backward is the FM backward kernel."""

    def forward(self, x, training: bool = False) -> torch.Tensor:
        """``x``: a stacked (B, F, D) tensor or a list of (B, 1, D)."""
        x = concat_embeddings(x)
        if x is None or x.dim() != 3:
            raise ValueError('FM expects (B, F, D) embeddings, got '
                             f'{None if x is None else tuple(x.shape)}.')
        return fm(x.contiguous())


class CIN(nn.Module):
    """Compressed Interaction Network (xDeepFM), (B, F, D) → (B, 1): the
    port of ``deeptables_tpu/ops/interactions.py::CIN``.

    Each layer is the contraction ``z_bld = Σ_fg x0_bfd · h_bgd · W_lfg``
    (``ops/cin_grad.py``: the K4 kernel forward, K3 backward on a CUDA
    input), then bias and activation; z stays float32 between layers. The
    parameters carry the flax names and shapes: ``f_{i}`` (L, F0, Fk), or
    with ``reduce_D`` ``f0_{i}`` (L, F0, D) and ``f__{i}`` (L, D, Fk)
    combined by a float32 einsum; ``bias_{i}`` (L,); the Dense layers
    ``exFM_out0`` (with ``use_residual``) and ``exFM_out``.

    ``cin_params``: ``cross_layer_size``, ``activation``, ``use_residual``,
    ``use_bias``, ``direct`` (else every layer but the last splits in half,
    one half the next layer's input, the other its output), ``reduce_D``,
    ``layout`` (``'batch_minor'`` runs the tower on (F, D·B) operands
    through ``cin_contract_bm``; anything else the classic (B, F, D)
    tower), ``bwd`` (the backward formulation) and ``use_pallas`` (accepted
    with a warning; the JAX package removed that path)."""

    def __init__(self, n_fields: int, dim: int, params: Dict[str, Any],
                 use_pallas: bool = False, generator=None):
        super().__init__()
        cross_layer_size = tuple(params.get('cross_layer_size', (128, 128)))
        if len(cross_layer_size) == 0:
            raise ValueError('cross_layer_size must be a list(tuple) of '
                             'length greater than 1')
        self.params = dict(params)
        self.cross_layer_size = cross_layer_size
        self.activation = get_activation(params.get('activation', 'relu'))
        self.use_residual = bool(params.get('use_residual', False))
        self.use_bias = bool(params.get('use_bias', False))
        self.direct = bool(params.get('direct', False))
        self.reduce_d = bool(params.get('reduce_D', False))
        if use_pallas or bool(params.get('use_pallas', False)):
            dt_logging.get_logger(__name__).warning(
                "cin_params={'use_pallas': True}: the legacy per-layer "
                'Pallas CIN was removed from the JAX package; using the CIN '
                'contraction kernels.')

        he = get_initializer('he_uniform')
        hidden_fields = n_fields
        result_width = 0
        last = len(cross_layer_size) - 1
        for i, layer_size in enumerate(cross_layer_size):
            if self.reduce_d:
                self.register_parameter(f'f0_{i}', nn.Parameter(
                    he(generator, (layer_size, n_fields, dim))))
                self.register_parameter(f'f__{i}', nn.Parameter(
                    he(generator, (layer_size, dim, hidden_fields))))
            else:
                self.register_parameter(f'f_{i}', nn.Parameter(
                    he(generator, (layer_size, n_fields, hidden_fields))))
            if self.use_bias:
                self.register_parameter(f'bias_{i}',
                                        nn.Parameter(torch.zeros(layer_size)))
            if self.direct:
                hidden_fields = layer_size
                result_width += layer_size
            elif i != last:
                if layer_size % 2 > 0:
                    raise ValueError(
                        'cross_layer_size must be even number except for '
                        'the last layer when direct=True')
                hidden_fields = layer_size // 2
                result_width += layer_size - layer_size // 2
            else:
                result_width += layer_size
        if self.use_residual:
            self.exFM_out0 = Dense(result_width, cross_layer_size[-1],
                                   kernel_init='he_uniform',
                                   generator=generator)
            result_width += cross_layer_size[-1]
        self.exFM_out = Dense(result_width, 1, generator=generator)

    def _weight(self, i):
        if self.reduce_d:
            return torch.einsum('lfd,ldg->lfg', getattr(self, f'f0_{i}'),
                                getattr(self, f'f__{i}'))
        return getattr(self, f'f_{i}')

    def _bias(self, i):
        return getattr(self, f'bias_{i}') if self.use_bias else None

    def forward(self, x, training: bool = False) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(
                f'Wrong dimensions of inputs, expected 3 but input {x.dim()}.')
        last = len(self.cross_layer_size) - 1
        outputs = []
        if self.params.get('layout', 'auto') == 'batch_minor':
            B, F, D = x.shape
            xT = x.permute(1, 2, 0).reshape(F, D * B)
            hidden = xT
            for i, layer_size in enumerate(self.cross_layer_size):
                z = cin_contract_bm(xT, hidden, self._weight(i))  # (L, D·B)
                if self.use_bias:
                    z = z + self._bias(i)[:, None]
                z = self.activation(z)
                if self.direct or i == last:
                    hidden, out = z, z
                else:
                    hidden, out = z[:layer_size // 2], z[layer_size // 2:]
                outputs.append(out)
            result = torch.cat(outputs, dim=0).reshape(-1, D, B).sum(dim=1).t()
        else:
            hidden = x
            for i, layer_size in enumerate(self.cross_layer_size):
                z = cin_contract(x, hidden, self._weight(i),
                                 self.params.get('bwd', None))  # (B, L, D)
                if self.use_bias:
                    z = z + self._bias(i)[None, :, None]
                z = self.activation(z)
                if self.direct or i == last:
                    hidden, out = z, z
                else:
                    hidden, out = z[:, :layer_size // 2], z[:, layer_size // 2:]
                outputs.append(out)
            result = torch.cat(outputs, dim=1).sum(dim=-1)  # (B, ΣL)
        if self.use_residual:
            out0 = self.activation(self.exFM_out0(result))
            result = torch.cat([out0, result], dim=1)
        return self.exFM_out(result)
