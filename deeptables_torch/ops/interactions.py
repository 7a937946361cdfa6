# -*- coding:utf-8 -*-
"""Feature-interaction blocks (counterpart of
``deeptables_tpu/ops/interactions.py``).

Every block of the JAX package: ``FM``, ``CIN`` and ``MultiheadAttention``
run the port's CUDA kernels on a CUDA input; ``Cross``, ``InnerProduct``,
``OuterProduct``, ``AFM``, ``SENET``, ``BilinearInteraction`` and
``FGCNN`` are stock torch operations, as their JAX counterparts are plain
XLA. Each block's parameters and sublayers carry the flax names. The
blocks over field pairs enumerate the pairs as ``_pair_indices`` does, so
they take the fields in the order the JAX package stacks them (the model
reorders them for these blocks, ``models/deepnets.py``).
"""

import itertools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import dt_logging
from .attention_grad import attention_block, field_attention
from .cin_grad import cin_contract, cin_contract_bm
from .embedding import concat_embeddings
from .initializers import get_activation, get_initializer
from .kernels.field_attention import (attention_weights, merge_heads,
                                      scale_for, split_heads)
from .kernels.fm import fm
from .layers import BatchNorm, Conv2d, Dense, dropout, same_pads


def _pair_indices(num_fields: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row/col index vectors enumerating all unordered field pairs (i<j),
    in ``itertools.combinations`` order."""
    if num_fields < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    row, col = zip(*itertools.combinations(range(num_fields), 2))
    return np.asarray(row, np.int64), np.asarray(col, np.int64)


def _incidence(index: np.ndarray, n_fields: int) -> np.ndarray:
    """(n_fields, P) float32: 1 where ``index[p]`` is the field."""
    out = np.zeros((n_fields, len(index)), np.float32)
    out[index, np.arange(len(index))] = 1
    return out


class GatherFields(torch.autograd.Function):
    """``x.index_select(1, index)`` of a (B, F, D) tensor, with a backward
    that sums the gradients of each field's slots in a fixed order: one
    matrix product with the (F, P) 0/1 ``incidence`` of the index (a
    field's row holds a 1 at each slot that reads it), ``dx = incidence ·
    dP`` per example. ``index_select``'s own backward scatters with float
    atomic adds on a CUDA tensor, so a field read by many slots (F − 1 pairs
    each) would get its sum in another order every run; a matrix product's
    order is fixed. ``incidence`` may have more rows than x has fields
    (FiBiNet's ``field_each`` reads F − 1 of them): its first ones serve."""

    @staticmethod
    def forward(ctx, x, index, incidence):
        ctx.save_for_backward(incidence)
        ctx.n_fields = x.shape[1]
        return x.index_select(1, index)

    @staticmethod
    def backward(ctx, g):
        (incidence,) = ctx.saved_tensors
        dx = torch.matmul(incidence[:ctx.n_fields].to(g.dtype), g)
        return dx, None, None


class _Pairs(nn.Module):
    """Holds the pair indices of ``n_fields`` fields and their incidence
    matrices (``GatherFields``) as buffers (they move with the module to its
    device; not saved)."""

    def __init__(self, n_fields: int):
        super().__init__()
        row, col = _pair_indices(n_fields)
        for name, index in (('row', row), ('col', col)):
            self.register_buffer(name, torch.from_numpy(index),
                                 persistent=False)
            self.register_buffer(f'{name}_incidence', torch.from_numpy(
                _incidence(index, n_fields)), persistent=False)
        self.n_pairs = len(row)

    def gather(self, x, which: str):
        """The fields of a (B, F, D) tensor at ``which`` (``'row'`` or
        ``'col'``) of every pair."""
        return GatherFields.apply(x, getattr(self, which),
                                  getattr(self, f'{which}_incidence'))

    def pair(self, x):
        """``(x[:, row], x[:, col])`` of a (B, F, D) tensor."""
        return self.gather(x, 'row'), self.gather(x, 'col')


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
    """AutoInt interacting layer, (B, F, U_in) → (B, F, U) float32: the port
    of ``deeptables_tpu/ops/interactions.py::MultiheadAttention``.

    The projections ``dense_Q``, ``dense_K``, ``dense_V`` (and with
    ``use_residual`` ``dense_residual``), U_in → U with he_uniform kernels,
    U = ``num_units`` (``H·dh``; None, the default: U_in, as the JAX
    package builds every block), run in x's type (flax's
    ``nn.Dense(dtype=x.dtype)``), then relu. Field attention per head
    (``ops/attention_grad.field_attention``: the K5 kernels on a CUDA
    input) gives the context; with ``layout``
    ``'batch_minor'`` (the default) it is cast to x's type before the
    residual add, with any other layout it stays float32, as in the two JAX
    layouts. Then the residual, relu and ``batch_normalize`` (flax
    BatchNorm over the last axis, which returns float32: the next block of
    a stack runs in float32).

    ``autoint_params``: ``num_heads``, ``dropout_rate``, ``use_residual``,
    ``layout``, ``fuse_projections``, ``use_fused_kernel`` and
    ``num_units``.
    - ``num_units`` (the port's own key: the JAX package has none) sets U,
      the output width of every block, as the AutoInt paper's layers
      (arXiv:1810.11921: d = 16 → 2 heads of 32); the first block of a stack
      maps the embedding width to it.
    - ``fuse_projections`` with ``use_residual``, ``dropout_rate == 0``,
      the batch-minor layout and ``use_fused_kernel`` (where the JAX
      package fuses) runs the whole block but BatchNorm as one kernel pair
      (``attention_block``: K6), on ``w_aug = [[Wq|Wk|Wv|Wr]; [bq|bk|bv|br]]``
      packed from the four Dense parameters each call (their names stay).
      Its q, k, v and r stay float32. K6 takes square blocks only (U_in =
      U): a block that asks for it at another width is refused.
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

    def __init__(self, in_units: int, params: Dict[str, Any],
                 generator=None):
        super().__init__()
        self.num_heads = int(params.get('num_heads', 1))
        self.dropout_rate = float(params.get('dropout_rate', 0))
        self.use_residual = bool(params.get('use_residual', True))
        out = params.get('num_units')
        num_units = in_units if out is None else int(out)
        if num_units % self.num_heads != 0:
            raise ValueError(
                f'{"embedding dim" if out is None else "num_units"} '
                f'{num_units} must be divisible by num_heads {self.num_heads}')
        self.num_units = num_units
        self.batch_minor = params.get('layout', 'batch_minor') == 'batch_minor'
        use_fused_kernel = bool(params.get('use_fused_kernel', True))
        # the JAX package fuses the block on its batch-minor kernel path only
        self.fused = (bool(params.get('fuse_projections', False))
                      and self.use_residual and self.dropout_rate == 0
                      and self.batch_minor and use_fused_kernel)
        if params.get('fuse_projections') and num_units != in_units:
            raise ValueError(
                f"autoint_params={{'fuse_projections': True}} with num_units "
                f'{num_units} and an input of width {in_units}: the fused '
                f'block (K6) packs the four projections into one square '
                f'(U+1, 4U) w_aug, so its input and output widths must be '
                f'equal; leave fuse_projections unset at this width')
        if not use_fused_kernel:
            dt_logging.get_logger(__name__).warning(
                "autoint_params={'use_fused_kernel': False}: it selected the "
                'XLA formulation on a TPU; deeptables_torch runs the unfused '
                'block with the field attention kernels.')
        names = ['dense_Q', 'dense_K', 'dense_V']
        if self.use_residual:
            names.append('dense_residual')
        for name in names:
            self.add_module(name, Dense(in_units, num_units,
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


class Cross(nn.Module):
    """DCN cross network, (B, N) → (B, N) float32:
    ``x_{l+1} = x_0 ⊙ (x_l·w_l) + x_l + b_l`` with ``kernels_{l}`` (N, 1)
    glorot_uniform and ``bias_{l}`` (N,) zeros, ``cross_params``
    ``num_cross_layer`` of them (2 when unset)."""

    def __init__(self, n: int, params: Dict[str, Any], generator=None):
        super().__init__()
        self.num_cross_layer = int(params.get('num_cross_layer', 2))
        glorot = get_initializer('glorot_uniform')
        for i in range(self.num_cross_layer):
            self.register_parameter(f'kernels_{i}',
                                    nn.Parameter(glorot(generator, (n, 1))))
            self.register_parameter(f'bias_{i}',
                                    nn.Parameter(torch.zeros(n)))

    def forward(self, x, training: bool = False) -> torch.Tensor:
        if x.dim() != 2:
            raise ValueError(
                f'Wrong dimensions of x, expected 2 but input {x.dim()}.')
        # the first layer promotes x to float32, as flax does
        x0 = xl = x.float()
        for i in range(self.num_cross_layer):
            w = getattr(self, f'kernels_{i}')
            xl = x0 * torch.matmul(xl, w) + xl + getattr(self, f'bias_{i}')
        return xl


class InnerProduct(_Pairs):
    """PNN inner product over field pairs, (B, F, D) → (B, P) in x's type.
    No parameters."""

    def forward(self, x, training: bool = False) -> torch.Tensor:
        p, q = self.pair(concat_embeddings(x))
        return (p * q).sum(dim=-1)


class OuterProduct(_Pairs):
    """PNN kernel outer product over field pairs, (B, F, D) → (B, P)
    float32. ``pnn_params['outer_product_kernel_type']``: ``'mat'``
    (``kernel`` (D, P, D): ``p·K_p·q`` per pair, in float32), ``'vec'``
    (``kernel`` (P, D)) or ``'num'`` (``kernel`` (P, 1)); glorot_uniform."""

    def __init__(self, n_fields: int, dim: int, params: Dict[str, Any],
                 generator=None):
        super().__init__(n_fields)
        self.kernel_type = params.get('outer_product_kernel_type', 'mat')
        if self.kernel_type not in ('mat', 'vec', 'num'):
            raise ValueError('kernel_type must be mat,vec or num')
        n_pairs = max(self.n_pairs, 1)
        shape = {'mat': (dim, n_pairs, dim), 'vec': (n_pairs, dim),
                 'num': (n_pairs, 1)}[self.kernel_type]
        self.kernel = nn.Parameter(
            get_initializer('glorot_uniform')(generator, shape))

    def forward(self, x, training: bool = False) -> torch.Tensor:
        p, q = self.pair(concat_embeddings(x))
        if self.kernel_type == 'mat':
            pk = torch.einsum('bpe,epf->bpf', p.float(), self.kernel)
            return (pk * q.float()).sum(dim=-1)
        # the pair product in x's type, then promoted by the kernel
        return (p * q * self.kernel[None]).sum(dim=-1)


class AFM(_Pairs):
    """Attentional FM, (B, F, D) → (B, 1). The pair products (in x's type)
    go through ``dense_afm_attention`` (glorot_normal, ``hidden_factor``
    units, else ``attention_factor``, else 16) and the activation, then
    ``projection_h`` (hidden, 1) glorot_uniform and a softmax over the
    pairs weight them; the pooled (B, D) float32 is dropped in training
    (``dropout_rate``) and ``dense_out`` (no bias) gives the logit."""

    flax_scope = True

    def __init__(self, n_fields: int, dim: int, params: Dict[str, Any],
                 generator=None):
        super().__init__(n_fields)
        hidden = int(params.get('hidden_factor',
                                params.get('attention_factor', 16)))
        self.dropout_rate = float(params.get('dropout_rate', 0))
        self.activation = get_activation(params.get('activation', 'relu'))
        self.dense_afm_attention = Dense(dim, hidden,
                                         kernel_init='glorot_normal',
                                         generator=generator)
        self.projection_h = nn.Parameter(
            get_initializer('glorot_uniform')(generator, (hidden, 1)))
        self.dense_out = Dense(dim, 1, use_bias=False, generator=generator)

    def forward(self, x, training: bool = False,
                generator=None) -> torch.Tensor:
        p, q = self.pair(concat_embeddings(x))
        bi = p * q  # (B, P, D)
        att = self.activation(self.dense_afm_attention(bi))
        score = torch.softmax(torch.matmul(att, self.projection_h), dim=1)
        out = (score * bi).sum(dim=1)  # (B, D) float32
        if training:
            out = dropout(out, self.dropout_rate, generator)
        return self.dense_out(out)


class SENET(nn.Module):
    """Squeeze-and-excitation over fields, (B, F, D) → (B, F, D) float32:
    each field's ``mean`` (or ``max``) over D, ``dense_att1`` (F //
    reduction_ratio units, at least 1) and ``dense_att2`` (F units), both
    he_uniform with relu, weight the fields."""

    flax_scope = True

    def __init__(self, n_fields: int, pooling_op: str = 'mean',
                 reduction_ratio: int = 3, generator=None):
        super().__init__()
        self.pooling_op = pooling_op
        reduction_num = max(n_fields // reduction_ratio, 1)
        self.dense_att1 = Dense(n_fields, reduction_num,
                                kernel_init='he_uniform', generator=generator)
        self.dense_att2 = Dense(reduction_num, n_fields,
                                kernel_init='he_uniform', generator=generator)

    def forward(self, x, training: bool = False) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(
                f'Wrong dimensions of inputs, expected 3 but input {x.dim()}.')
        # amax shares the gradient among ties, as JAX's max does
        z = x.amax(dim=-1) if self.pooling_op == 'max' else x.mean(dim=-1)
        a1 = torch.relu(self.dense_att1(z))
        a2 = torch.relu(self.dense_att2(a1))
        return x * a2[:, :, None]


class BilinearInteraction(_Pairs):
    """FiBiNet bilinear interaction, (B, F, D) → (B, P, D) float32:
    ``(x_i·W) ⊙ x_j`` for every pair i < j, ``bilinear_weight`` glorot_uniform
    of shape (D, D) (``'field_all'``), (F − 1, D, D), one for each first
    field (``'field_each'``), or (P, D, D), one for each pair
    (``'field_interaction'``, the default)."""

    def __init__(self, n_fields: int, dim: int,
                 bilinear_type: str = 'field_interaction', generator=None):
        super().__init__(n_fields)
        self.bilinear_type = bilinear_type
        if bilinear_type == 'field_all':
            shape = (dim, dim)
        elif bilinear_type == 'field_each':
            shape = (max(n_fields - 1, 1), dim, dim)
        else:
            shape = (max(self.n_pairs, 1), dim, dim)
        self.bilinear_weight = nn.Parameter(
            get_initializer('glorot_uniform')(generator, shape))

    def forward(self, x, training: bool = False) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(
                f'Wrong dimensions of inputs, expected 3 but input {x.dim()}.')
        w = self.bilinear_weight
        if self.bilinear_type == 'field_all':
            xw = torch.matmul(x.float(), w)
            return self.gather(xw, 'row') * self.gather(x, 'col')
        if self.bilinear_type == 'field_each':
            xw = torch.einsum('bfe,feh->bfh', x[:, :w.shape[0]].float(), w)
            return self.gather(xw, 'row') * self.gather(x, 'col')
        p, q = self.pair(x)
        return torch.einsum('bpe,peh->bph', p.float(), w) * q


class FGCNN(nn.Module):
    """One Feature-Generation CNN stage, in flax's layouts: input
    ``(B, F, E, C)``, output ``(pooled (B, ceil(F / pool_height), E,
    filters), new features (B, F·new_filters, E))``, float32.

    ``conv2d`` convolves along the field axis (kernel ``(kernel_height,
    1)``, ``SAME`` padding, glorot_uniform, bias) and the activation
    (tanh) follows; a max pool of ``pool_height`` fields (``SAME``: the
    odd pad at the end) gives the next stage's input; ``dense_output``
    (glorot_uniform) reads it flattened in flax's ``(F', E, filters)``
    order and gives the new features. The convolution is ``layers.Conv2d``'s
    im2col product (its backward has no atomic adds)."""

    flax_scope = True

    def __init__(self, in_fields: int, emb: int, in_channels: int,
                 filters: int, kernel_height: int, new_filters: int,
                 pool_height: int, activation: str = 'tanh', generator=None):
        super().__init__()
        self.pool_height = pool_height
        self.new_filters = new_filters
        self.activation = get_activation(activation)
        self.conv2d = Conv2d(in_channels, filters, (kernel_height, 1),
                             kernel_init='glorot_uniform',
                             generator=generator)
        pooled_fields = math.ceil(in_fields / pool_height)
        self.dense_output = Dense(pooled_fields * emb * filters,
                                  in_fields * emb * new_filters,
                                  kernel_init='glorot_uniform',
                                  generator=generator)

    def forward(self, x, training: bool = False):
        B, n_fields, emb = x.shape[:3]
        conv = self.activation(self.conv2d(x))  # (B, F, E, filters)
        low, high = same_pads(n_fields, self.pool_height, self.pool_height)
        # max_pool2d on an NCHW view of the NHWC tensor; the windows do not
        # overlap, so its backward gathers one gradient an input element
        pooled = F.max_pool2d(
            F.pad(conv, (0, 0, 0, 0, low, high),
                  value=float('-inf')).permute(0, 3, 1, 2),
            (self.pool_height, 1), (self.pool_height, 1))
        pooled = pooled.permute(0, 2, 3, 1)  # (B, F', E, filters)
        new = self.activation(self.dense_output(pooled.reshape(B, -1)))
        return pooled, new.reshape(B, n_fields * self.new_filters, emb)
