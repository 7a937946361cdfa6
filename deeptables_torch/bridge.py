# -*- coding:utf-8 -*-
"""Carry a JAX model's weights into the port.

:func:`state_dict_from_flax` maps the flax variable tree of a
``deeptables_tpu`` ``DeepTabularModel`` (``{'params': ..., 'batch_stats':
...}`` as nested dicts of numpy arrays, e.g. after ``jax.device_get``) onto
the ``state_dict`` of the port's ``DeepTabularModel`` for the same schema and
config. It imports no JAX. A tree without ``batch_stats`` (a gradient tree
from ``jax.grad``, as ``{'params': grads}``) maps the same way, to the
parameters' entries only: every layout step and the field-order permutation
below are linear, so they carry gradients exactly as weights.

What it maps:

- Dense: ``kernel (in, out)`` → ``weight (out, in)``; ``bias`` → ``bias``.
- BatchNorm: ``scale`` → ``weight``, ``bias`` → ``bias``, ``batch_stats``
  ``mean``/``var`` → ``running_mean``/``running_var``.
- Embedding tables: the JAX table ``embeddings_d{D}`` is lane-packed,
  ``(P, k·D)`` with ``k = 128 // D`` when D divides 128, and its column
  regions follow the TPU plan (vocab-ascending, each region padded to a
  multiple of ``k·TILE_P`` rows, when that padding is cheap). Each column's
  rows are copied to the port's logical table in column order at offsets
  ``cumsum(vocab)``.
- Field order: with that aligned plan, the JAX stacked field tensor is in
  plan order, so the parameters that follow the field axis are too: rows
  ``[0:F]`` of ``linear_logit`` and the first ``F·D`` entries of
  ``bn_concat_emb_dense`` and rows of ``dnn_dense_1`` (blocks of D). They are
  permuted into column order.
- CIN (``cin_layer``): ``f_i``, ``bias_i``, ``f0_i``/``f__i`` as they are,
  ``exFM_out0``/``exFM_out`` as Dense. Every axis that runs over the input
  fields is in plan order and is permuted: axes 1 and 2 of ``f_0`` (h = x0
  at layer 0), axis 1 of ``f_i`` (i > 0) and ``f0_i``, axis 2 of ``f__0``.
  The hidden-unit axes are not.
- AutoInt (``autoint_attention_{i}``): the nested ``dense_Q``, ``dense_K``,
  ``dense_V``, ``dense_residual`` as Dense and ``batch_normalize`` (its
  ``batch_stats`` nested the same way) as BatchNorm. Attention treats every
  field alike, so these need no permutation; but the net's flattened
  ``(F·U)`` output is in plan order, so the layer that reads it
  (``task_output`` when AutoInt is the only net, else
  ``dense_logit_autoint_nets``) has its rows permuted in blocks of U, like
  ``dnn_dense_1``.
"""

from typing import Dict, List, Sequence

import numpy as np
import torch

from .utils import consts

# The JAX package's TPU layout constants (ops/embedding.py, ops/kernels/
# emb_grad.py), copied: the bridge has to reproduce that layout to read it.
_LANES = 128
_TILE_P = 256

_EMBEDDING = consts.LAYER_PREFIX_EMBEDDING + 'categorical_vars_all'
_BRIDGED_NETS = ('linear', 'fm_nets', 'cin_nets', 'autoint_nets',
                 'dnn_nets')
_CIN = 'cin_layer'
_AUTOINT = 'autoint_attention_'


def _pack_factor(dim: int) -> int:
    if dim < _LANES and _LANES % dim == 0:
        return _LANES // dim
    return 1


def flax_plan(input_dims: Sequence[int], output_dims: Sequence[int]):
    """The JAX package's ``plan_groups`` layout:
    ``[(dim, col_indices in plan order, logical row offsets)]``."""
    groups = {}
    for idx, (voc, dim) in enumerate(zip(input_dims, output_dims)):
        groups.setdefault(int(dim), []).append((idx, int(voc)))
    plan = []
    for dim in sorted(groups):
        cols = groups[dim]
        k = _pack_factor(dim)
        logical = sum(v for _, v in cols)
        align = k * _TILE_P
        aligned_total = sum(-(-v // align) * align for _, v in cols)
        if k > 1 and aligned_total <= max(4 * logical, logical + 8 * align):
            cols = sorted(cols, key=lambda cv: (cv[1], cv[0]))
            offsets, cur = [], 0
            for _, v in cols:
                offsets.append(cur)
                cur += -(-v // align) * align
        else:
            offsets = np.concatenate(
                [[0], np.cumsum([v for _, v in cols])[:-1]]).tolist()
        plan.append((dim, [c for c, _ in cols], [int(o) for o in offsets]))
    return plan


def flax_field_order(input_dims, output_dims) -> List[int]:
    """``order[p]`` = the column at field position p of the JAX stacked
    tensor (identity unless every column has one width)."""
    plan = flax_plan(input_dims, output_dims)
    if len(plan) == 1:
        return list(plan[0][1])
    return list(range(len(input_dims)))


def _to_column_order(a: np.ndarray, order: List[int], block: int):
    """Reorder the leading ``len(order)·block`` entries of axis 0 from JAX
    field order to column order."""
    n = len(order) * block
    head = a[:n].reshape((len(order), block) + a.shape[1:])
    out = np.empty_like(head)
    out[np.asarray(order)] = head
    return np.concatenate([out.reshape((n,) + a.shape[1:]), a[n:]])


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def state_dict_from_flax(variables, categorical_columns, continuous_columns,
                         config) -> Dict[str, torch.Tensor]:
    """flax variables of a JAX ``DeepTabularModel`` → the port's
    ``state_dict`` (CPU float32 tensors) for the same schema and config."""
    unknown = [n for n in config.nets if n not in _BRIDGED_NETS]
    if unknown:
        raise NotImplementedError(
            f'no weight bridge yet for nets {unknown}; bridged: '
            f'{list(_BRIDGED_NETS)}')
    params = variables['params']
    stats = variables.get('batch_stats', {})
    input_dims = [int(c.vocabulary_size) for c in categorical_columns]
    output_dims = [int(c.embeddings_output_dim) for c in categorical_columns]
    order = flax_field_order(input_dims, output_dims)
    # flax layers whose leading axis follows the fields → entries per field:
    # the per-field sums of `linear`, the flattened (F, D) embeddings
    dim = output_dims[0] if output_dims else 0
    blocks = {'linear_logit': 1, 'bn_concat_emb_dense': dim,
              'dnn_dense_1': dim}
    # the layer that reads AutoInt's flattened (F·U) output
    if tuple(config.nets) == ('autoint_nets',):
        blocks['task_output'] = dim
    else:
        blocks['dense_logit_autoint_nets'] = dim

    out = {}
    for name, node in params.items():
        if name == _EMBEDDING:
            out.update(_embedding_tables(node, input_dims, output_dims))
        elif name.startswith(consts.LAYER_PREFIX_EMBEDDING):
            raise NotImplementedError(f'no weight bridge yet for {name!r}')
        elif name == _CIN:
            out.update(_cin_weights(node, order))
        elif name.startswith(_AUTOINT):
            for key, layer in node.items():
                out.update(_layer(f'{name}.{key}', layer,
                                  stats.get(name, {}).get(key)))
        elif 'kernel' in node or 'scale' in node:
            out.update(_layer(name, node, stats.get(name),
                              blocks.get(name) if order else None, order))
        else:
            raise NotImplementedError(
                f'no weight bridge yet for flax module {name!r}')
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def _layer(name, node, stats=None, block=None, order=None):
    """A Dense (``kernel``, ``bias``) or BatchNorm (``scale``, ``bias``,
    ``stats`` ``mean``/``var``) node → the port's entries; with ``block``,
    the entries along the field axis (a kernel's rows, every BatchNorm
    vector) go from JAX field order to column order in blocks of that
    size."""
    def fields(value):
        value = _f32(value)
        return _to_column_order(value, order, block) if block else value
    if 'kernel' in node:  # kernel (in, out) → weight (out, in)
        out = {f'{name}.weight': fields(node['kernel']).T}
        if 'bias' in node:
            out[f'{name}.bias'] = _f32(node['bias'])
        return out
    if 'scale' not in node:
        raise NotImplementedError(f'no weight bridge yet for {name!r}')
    entries = {'weight': node['scale'], 'bias': node['bias']}
    if stats is not None:
        entries.update(running_mean=stats['mean'], running_var=stats['var'])
    return {f'{name}.{key}': fields(value) for key, value in entries.items()}


def _permute_axis(a: np.ndarray, order: List[int], axis: int):
    """Axis ``axis`` of ``a`` (one entry per field) from JAX field order to
    column order."""
    return np.moveaxis(_to_column_order(np.moveaxis(a, axis, 0), order, 1),
                       0, axis)


def _cin_weights(node, order):
    out = {}
    for key, value in node.items():
        if 'kernel' in value:  # exFM_out0, exFM_out
            out[f'{_CIN}.{key}.weight'] = _f32(value['kernel']).T
            if 'bias' in value:
                out[f'{_CIN}.{key}.bias'] = _f32(value['bias'])
            continue
        value = _f32(value)
        kind, layer = key.rsplit('_', 1)
        axes = {'f': (1, 2) if layer == '0' else (1,), 'f0': (1,),
                'f_': (2,) if layer == '0' else (), 'bias': ()}
        if kind not in axes:
            raise NotImplementedError(
                f'no weight bridge yet for {_CIN}/{key}')
        if order:
            for axis in axes[kind]:
                value = _permute_axis(value, order, axis)
        out[f'{_CIN}.{key}'] = value
    return out


def _embedding_tables(node, input_dims, output_dims):
    tables = {}
    for dim, cols, offsets in flax_plan(input_dims, output_dims):
        logical = _f32(node[f'embeddings_d{dim}']).reshape(-1, dim)
        rows = {c: logical[o:o + input_dims[c]] for c, o in zip(cols, offsets)}
        tables[f'{_EMBEDDING}.embeddings_d{dim}'] = np.concatenate(
            [rows[c] for c in sorted(cols)])
    return tables
