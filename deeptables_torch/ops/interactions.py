# -*- coding:utf-8 -*-
"""Feature-interaction blocks (counterpart of
``deeptables_tpu/ops/interactions.py``).

Ported: ``FM``, ``CIN`` and ``MultiheadAttention``; the other blocks come
with the slices that carry their nets (see ``models/deepnets.py``).
"""

from typing import Any, Dict

import torch
from torch import nn

from ..utils import dt_logging
from .attention_grad import attention_block, field_attention
from .cin_grad import cin_contract, cin_contract_bm
from .embedding import concat_embeddings
from .initializers import get_activation, get_initializer
from .kernels.field_attention import (attention_weights, merge_heads,
                                      scale_for, split_heads)
from .kernels.fm import fm
from .layers import BatchNorm, Dense, dropout


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


class MultiheadAttention(nn.Module):
    """AutoInt interacting layer, (B, F, U) → (B, F, U) float32: the port of
    ``deeptables_tpu/ops/interactions.py::MultiheadAttention``.

    The projections ``dense_Q``, ``dense_K``, ``dense_V`` (and with
    ``use_residual`` ``dense_residual``), U → U with he_uniform kernels, run
    in x's type (flax's ``nn.Dense(dtype=x.dtype)``), then relu. Field
    attention per head (``ops/attention_grad.field_attention``: the K5
    kernels on a CUDA input) gives the context; with ``layout``
    ``'batch_minor'`` (the default) it is cast to x's type before the
    residual add, with any other layout it stays float32, as in the two JAX
    layouts. Then the residual, relu and ``batch_normalize`` (flax
    BatchNorm over the last axis, which returns float32: the next block of
    a stack runs in float32).

    ``autoint_params``: ``num_heads``, ``dropout_rate``, ``use_residual``,
    ``layout``, ``fuse_projections`` and ``use_fused_kernel``.
    - ``fuse_projections`` with ``use_residual``, ``dropout_rate == 0``,
      the batch-minor layout and ``use_fused_kernel`` (where the JAX
      package fuses) runs the whole block but BatchNorm as one kernel pair
      (``attention_block``: K6), on ``w_aug = [[Wq|Wk|Wv|Wr]; [bq|bk|bv|br]]``
      packed from the four Dense parameters each call (their names stay).
      Its q, k, v and r stay float32.
    - ``dropout_rate > 0`` drops attention weights in training, with masks
      from the model's ``torch.Generator``; no kernel runs on that path,
      whether training or not, as in the JAX package.
    - ``use_fused_kernel=False`` is accepted with a warning: on the TPU it
      chose the XLA formulation, the unfused block; here the unfused block
      runs with the K5 kernels.
    """

    # DeepTabularModel registers this module under its own name with the
    # layers nested in it (flax's ``autoint_attention_{i}/dense_Q``)
    flax_scope = True

    def __init__(self, num_units: int, params: Dict[str, Any],
                 generator=None):
        super().__init__()
        self.num_heads = int(params.get('num_heads', 1))
        self.dropout_rate = float(params.get('dropout_rate', 0))
        self.use_residual = bool(params.get('use_residual', True))
        if num_units % self.num_heads != 0:
            raise ValueError(f'embedding dim {num_units} must be divisible '
                             f'by num_heads {self.num_heads}')
        self.batch_minor = params.get('layout', 'batch_minor') == 'batch_minor'
        use_fused_kernel = bool(params.get('use_fused_kernel', True))
        # the JAX package fuses the block on its batch-minor kernel path only
        self.fused = (bool(params.get('fuse_projections', False))
                      and self.use_residual and self.dropout_rate == 0
                      and self.batch_minor and use_fused_kernel)
        if not use_fused_kernel:
            dt_logging.get_logger(__name__).warning(
                "autoint_params={'use_fused_kernel': False}: it selected the "
                'XLA formulation on a TPU; deeptables_torch runs the unfused '
                'block with the field attention kernels.')
        names = ['dense_Q', 'dense_K', 'dense_V']
        if self.use_residual:
            names.append('dense_residual')
        for name in names:
            self.add_module(name, Dense(num_units, num_units,
                                        kernel_init='he_uniform',
                                        generator=generator))
        self.batch_normalize = BatchNorm(num_units)

    def w_aug(self) -> torch.Tensor:
        """``(U+1, 4U)`` float32: the four kernels in flax's (in, out)
        layout side by side, their biases as the last row."""
        dense = [self.dense_Q, self.dense_K, self.dense_V,
                 self.dense_residual]
        return torch.cat([torch.cat([d.weight.t() for d in dense], dim=1),
                          torch.cat([d.bias for d in dense])[None]])

    def _attend_with_dropout(self, q, k, v, training, generator):
        """The attention in plain PyTorch, weights dropped in training:
        float32 (B, F, U)."""
        qh, kh, vh = (split_heads(t, self.num_heads) for t in (q, k, v))
        w = attention_weights(qh, kh, scale_for(qh.shape[-1]))
        if training:
            w = dropout(w, self.dropout_rate, generator)
        return merge_heads(torch.matmul(w, vh))

    def forward(self, x, training: bool = False,
                generator=None) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(
                f'Wrong dimensions of inputs, expected 3 but input {x.dim()}.')
        cd = x.dtype
        if self.fused:
            out = attention_block(x, self.w_aug(), self.num_heads)
            return self.batch_normalize(out, training=training)

        q = torch.relu(self.dense_Q(x, dtype=cd))
        k = torch.relu(self.dense_K(x, dtype=cd))
        v = torch.relu(self.dense_V(x, dtype=cd))
        out_dtype = cd if self.batch_minor else torch.float32
        if self.dropout_rate > 0:
            out = self._attend_with_dropout(q, k, v, training,
                                            generator).to(out_dtype)
        else:
            out = field_attention(q, k, v, self.num_heads, out_dtype)
        if self.use_residual:
            out = out + torch.relu(self.dense_residual(x, dtype=cd))
        out = torch.relu(out)
        return self.batch_normalize(out, training=training)
