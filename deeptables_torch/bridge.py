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
  ``dnn_dense_1``. A model that sets ``autoint_params['num_units']`` (the
  port's own key) is refused: the JAX package has no such blocks.
- The nets that read the fields in the JAX package's order in the port too
  (the pair products, AFM, FGCNN, FiBiNet; ``models/deepnets.py``) map one
  to one: ``*outer_product_layer/kernel``, ``bilinear_weight`` and AFM's
  ``projection_h`` as they are; the nested Dense layers of AFM, SENET and
  each FGCNN stage as Dense; each stage's ``conv2d`` kernel ``(kh, kw, in,
  out)`` → ``weight (out, in, kh, kw)``; ``fgcnn_cin_layer`` as CIN without
  a permutation. The Denses after them read their outputs as the JAX
  package lays them out, and the dense inputs, so they map one to one too,
  except for the part of ``pnn_dense_1``, ``ipnn_dense_1`` and
  ``opnn_dense_1`` that reads ``concat_emb_dense`` (rows from the
  products' width on, permuted in blocks of D). The first layer of
  ``custom_dnn_D_A_D_B`` (``{cell}_custom_dense_1``) is permuted as the
  MLP's it replaces; a custom DNN of other names is mapped as it is.
- Cross (``cross_layer``, ``cross_dnn_layer``, ``dcn_cross_layer``) acts
  element by element on ``concat_emb_dense``, which the port keeps in
  column order: the first F·D entries of each ``kernels_{i}`` and
  ``bias_{i}`` are permuted in blocks of D, and so are the first F·D rows
  of each Dense that reads a tensor laid out like it: ``cross_dnn_dense_1``,
  ``dcn_dense_1``, ``dense_logit_cross_nets``, ``dense_logit_dcn_nets``,
  and ``task_output`` when ``cross_nets`` or ``dcn_nets`` is the only net.
- Var-len columns (``emb_{name}``): the lane-packed ``embeddings`` table
  unpacked to its ``vocabulary_size`` logical rows. Their pooled fields
  follow the categorical fields in both packages.
"""

from typing import Dict, List, Mapping

import numpy as np
import torch

from .ops.embedding import flax_field_order, flax_plan, var_len_width
from .utils import consts

_EMBEDDING = consts.LAYER_PREFIX_EMBEDDING + 'categorical_vars_all'
_CINS = ('cin_layer', 'fgcnn_cin_layer')
_CROSSES = ('cross_layer', 'cross_dnn_layer', 'dcn_cross_layer')
# the MLPs whose input starts with concat_emb_dense's layout, by cell name,
# after as many (B, P) product layers
_MLP_CELLS = {'dnn': 0, 'cross_dnn': 0, 'dcn': 0, 'ipnn': 1, 'opnn': 1,
              'pnn': 2}


def _to_column_order(a: np.ndarray, order: List[int], block: int,
                     offset: int = 0):
    """Reorder ``len(order)·block`` entries of axis 0, from ``offset`` on,
    from JAX field order to column order."""
    n = len(order) * block
    head = a[offset:offset + n].reshape((len(order), block) + a.shape[1:])
    out = np.empty_like(head)
    out[np.asarray(order)] = head
    return np.concatenate([a[:offset], out.reshape((n,) + a.shape[1:]),
                           a[offset + n:]])


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def state_dict_from_flax(variables, categorical_columns, continuous_columns,
                         config, var_len_categorical_columns=()
                         ) -> Dict[str, torch.Tensor]:
    """flax variables of a JAX ``DeepTabularModel`` → the port's
    ``state_dict`` (CPU float32 tensors) for the same schema and config."""
    del continuous_columns  # their width is the same in both layouts
    if 'autoint_nets' in tuple(config.nets) and \
            config.autoint_params.get('num_units') is not None:
        raise ValueError(
            "autoint_params['num_units'] is the port's own key: the JAX "
            'package builds every AutoInt block at the embedding width, so '
            'its variables cannot fill a model of another block width')
    params = variables['params']
    stats = variables.get('batch_stats', {})
    var_cols = {consts.LAYER_PREFIX_EMBEDDING + c.name: c
                for c in var_len_categorical_columns or ()}
    input_dims = [int(c.vocabulary_size) for c in categorical_columns]
    output_dims = [int(c.embeddings_output_dim) for c in categorical_columns]
    order = flax_field_order(input_dims, output_dims,
                             [var_len_width(c) for c in var_cols.values()])
    if order == sorted(order):
        order = None
    # flax layers whose leading axis follows the fields → (offset, entries
    # per field): the per-field sums of `linear`, the flattened (F, D)
    # embeddings of concat_emb_dense and what keeps its layout
    dim = output_dims[0] if output_dims else 0
    blocks = {'linear_logit': (0, 1), 'bn_concat_emb_dense': (0, dim)}
    n_fields = len(input_dims) + len(var_cols)
    n_pairs = n_fields * (n_fields - 1) // 2
    # the first layer of each MLP over concat_emb_dense (or Cross's output),
    # custom_dnn_D_A_D_B's too; after the pair products in PNN's
    for cell, products in _MLP_CELLS.items():
        for layer in ('_dense_1', '_custom_dense_1'):
            blocks[cell + layer] = (products * n_pairs, dim)
    # the layer that reads AutoInt's flattened (F·U) output, or Cross's
    for net in ('autoint_nets', 'cross_nets', 'dcn_nets'):
        if tuple(config.nets) == (net,):
            blocks['task_output'] = (0, dim)
        else:
            blocks[f'dense_logit_{net}'] = (0, dim)

    out = {}
    for name, node in params.items():
        if name == _EMBEDDING:
            out.update(_embedding_tables(node, input_dims, output_dims))
        elif name in var_cols:
            col = var_cols[name]
            out[f'{name}.embeddings'] = _f32(node['embeddings']).reshape(
                -1, int(col.embeddings_output_dim))[:int(col.vocabulary_size)]
        elif name.startswith(consts.LAYER_PREFIX_EMBEDDING):
            raise ValueError(f'flax module {name!r} is no embedding of this '
                             f'schema')
        elif name in _CINS:
            out.update(_cin_weights(name, node,
                                    order if name == 'cin_layer' else None))
        elif name in _CROSSES:
            out.update({f'{name}.{key}': _permute_axis(
                _f32(value), order, 0, dim) for key, value in node.items()})
        elif name.endswith('outer_product_layer'):
            out[f'{name}.kernel'] = _f32(node['kernel'])
        elif 'kernel' in node or 'scale' in node:
            out.update(_layer(name, node, stats.get(name),
                              blocks.get(name) if order else None, order))
        else:
            out.update(_scope(name, node, stats.get(name, {})))
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def _scope(name, node: Mapping, stats: Mapping):
    """A flax module with sublayers and parameters of its own (AutoInt's
    blocks, AFM, SENET, the bilinear layers, FGCNN stages): each Dense or
    BatchNorm sublayer (its ``batch_stats`` nested the same way) as such, a
    ``conv2d`` as a convolution, a parameter as it is."""
    out = {}
    for key, value in node.items():
        path = f'{name}.{key}'
        if not isinstance(value, Mapping):
            out[path] = _f32(value)
        elif key == 'conv2d':  # kernel (kh, kw, in, out) → (out, in, kh, kw)
            out[f'{path}.weight'] = _f32(value['kernel']).transpose(3, 2, 0, 1)
            out[f'{path}.bias'] = _f32(value['bias'])
        else:
            out.update(_layer(path, value, stats.get(key)))
    return out


def _layer(name, node, stats=None, block=None, order=None):
    """A Dense (``kernel``, ``bias``) or BatchNorm (``scale``, ``bias``,
    ``stats`` ``mean``/``var``) node → the port's entries; with ``block``
    ``(offset, size)``, the entries along the field axis (a kernel's rows,
    every BatchNorm vector) from ``offset`` on go from JAX field order to
    column order in blocks of that size."""
    def fields(value):
        value = _f32(value)
        if not block or not block[1]:
            return value
        return _to_column_order(value, order, block[1], block[0])
    if 'kernel' in node:  # kernel (in, out) → weight (out, in)
        out = {f'{name}.weight': fields(node['kernel']).T}
        if 'bias' in node:
            out[f'{name}.bias'] = _f32(node['bias'])
        return out
    if 'scale' not in node:
        raise ValueError(f'flax module {name!r} is no Dense or BatchNorm')
    entries = {'weight': node['scale'], 'bias': node['bias']}
    if stats is not None:
        entries.update(running_mean=stats['mean'], running_var=stats['var'])
    return {f'{name}.{key}': fields(value) for key, value in entries.items()}


def _permute_axis(a: np.ndarray, order, axis: int, block: int = 1):
    """Axis ``axis`` of ``a`` (``block`` entries per field, then any others)
    from JAX field order to column order; as it is without an order."""
    if not order:
        return a
    return np.moveaxis(_to_column_order(np.moveaxis(a, axis, 0), order,
                                        block), 0, axis)


def _cin_weights(scope, node, order):
    """A CIN's weights; ``order`` permutes every axis over its input
    fields (``cin_layer``, which reads the fields in column order)."""
    out = {}
    for key, value in node.items():
        if isinstance(value, Mapping):  # exFM_out0, exFM_out
            out.update(_layer(f'{scope}.{key}', value))
            continue
        value = _f32(value)
        kind, layer = key.rsplit('_', 1)
        axes = {'f': (1, 2) if layer == '0' else (1,), 'f0': (1,),
                'f_': (2,) if layer == '0' else (), 'bias': ()}
        if kind not in axes:
            raise ValueError(f'unknown CIN parameter {scope}/{key}')
        for axis in axes[kind]:
            value = _permute_axis(value, order, axis)
        out[f'{scope}.{key}'] = value
    return out


def _embedding_tables(node, input_dims, output_dims):
    tables = {}
    for dim, cols, offsets in flax_plan(input_dims, output_dims):
        logical = _f32(node[f'embeddings_d{dim}']).reshape(-1, dim)
        rows = {c: logical[o:o + input_dims[c]] for c, o in zip(cols, offsets)}
        tables[f'{_EMBEDDING}.embeddings_d{dim}'] = np.concatenate(
            [rows[c] for c in sorted(cols)])
    return tables


def dae_params_from_flax(variables) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``fe.dae.DAEModule`` from a JAX
    DAE's variables (``{'params': ...}`` or the params alone, nested dicts
    of numpy arrays; a gradient tree maps the same way): each Dense's
    ``kernel (in, out)`` → ``weight (out, in)``, ``bias`` as it is."""
    params = variables.get('params', variables)
    out = {}
    for name, node in params.items():
        out.update(_layer(name, node))
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}
