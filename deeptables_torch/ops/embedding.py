# -*- coding:utf-8 -*-
"""Multi-column embedding (counterpart of ``deeptables_tpu/ops/embedding.py``).

Columns are grouped by embedding width; each group keeps ONE logical
``(Σ vocab, dim)`` table (parameter ``embeddings_d{dim}``) whose column
regions follow the original column order at offsets ``cumsum(vocab)``, and
is read with one gather per group. The TPU layout (lane-packed rows,
``TILE_P``-aligned regions, vocab-ascending column order) is not ported;
``deeptables_torch.bridge`` maps a JAX table onto this one.

``EmbeddingList`` keeps the "list of per-column (B, 1, d) tensors" contract
and exposes ``.stacked``, the (B, F, D) tensor in column order when every
width agrees. :func:`flax_field_order` gives the order in which the JAX
package stacks the same fields, which the nets whose function depends on
the field order read (``models/deepnets.py``).

``VarLenColumnEmbedding`` embeds a padded multi-valued column and pools its
tokens to one field.

The gather of a group is the forward half of :class:`EmbeddingLookup`, whose
backward is the embedding-gradient kernel (``kernels/emb_grad.py``, K1): a
dense float32 gradient of the whole logical table.

Under a ``TableSharding`` (``parallel/sharded_embedding.py``: a model axis
larger than 1 and ``embedding_device_strategy`` ``'sharded'`` or
``'sharded_a2a'``) a group's table of enough rows is this rank's
``(R, dim)`` row shard of it, looked up by ``sharded_lookup`` or
``sharded_lookup_a2a``; its backward is K1 over the shard's rows.
"""

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .initializers import get_initializer
from .kernels.emb_grad import emb_grad
from .layers import dropout
from ..parallel.sharded_embedding import (TABLE_PREFIX, gather_table,
                                          shard_rows)

# The JAX package's TPU layout constants (its ops/embedding.py and
# ops/kernels/emb_grad.py), copied: its field order and its tables' layout
# follow from them.
_LANES = 128
_TILE_P = 256


class EmbeddingLookup(torch.autograd.Function):
    """Rows ``table[ids]`` of a ``(V, D)`` float32 table; the backward is
    :func:`~.kernels.emb_grad.emb_grad` (the kernel on a CUDA tensor, its
    plain version on a CPU tensor)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return emb_grad(ids, g.float().contiguous(), ctx.num_rows), None


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``table`` at the flat int32 ``ids``; differentiable
    through :class:`EmbeddingLookup` when the table needs a gradient."""
    if table.requires_grad and torch.is_grad_enabled():
        return EmbeddingLookup.apply(table, ids)
    return table.index_select(0, ids)


class EmbeddingList(list):
    """A list of per-column (B, 1, d_i) embeddings with an optional fused view.

    ``stacked`` is the (B, F, D) tensor when all widths agree, else None.
    """

    def __init__(self, items=(), stacked=None):
        super().__init__(items)
        self.stacked = stacked


def concat_embeddings(embeddings) -> Optional[torch.Tensor]:
    """(B, F, D) from a (possibly fused) embedding list; None when empty."""
    if embeddings is None:
        return None
    if isinstance(embeddings, torch.Tensor):
        return embeddings
    if getattr(embeddings, 'stacked', None) is not None:
        return embeddings.stacked
    if len(embeddings) == 0:
        return None
    if len(embeddings) == 1:
        return embeddings[0]
    return torch.cat(list(embeddings), dim=1)


def flatten_embeddings(embeddings) -> Optional[torch.Tensor]:
    """(B, Σ d_i) flat view; works with heterogeneous widths."""
    if embeddings is None or len(embeddings) == 0:
        return None
    if getattr(embeddings, 'stacked', None) is not None:
        st = embeddings.stacked
        return st.reshape(st.shape[0], -1)
    flat = [e.reshape(e.shape[0], -1) for e in embeddings]
    return flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)


def plan_groups(input_dims: Sequence[int], output_dims: Sequence[int]):
    """Group column indices by embedding width, widths ascending.

    Returns ``[(dim, col_indices, offsets, total_vocab)]``: columns in
    their original order, each column's rows at ``offsets[i]`` of the
    group's logical table of ``total_vocab`` rows."""
    groups = {}
    for idx, (voc, dim) in enumerate(zip(input_dims, output_dims)):
        groups.setdefault(int(dim), []).append((idx, int(voc)))
    plan = []
    for dim in sorted(groups):
        cols = [c for c, _ in groups[dim]]
        vocabs = [v for _, v in groups[dim]]
        offsets = np.concatenate([[0], np.cumsum(vocabs)[:-1]]).astype(np.int32)
        plan.append((dim, cols, offsets, int(np.sum(vocabs))))
    return plan


def _pack_factor(dim: int) -> int:
    if dim < _LANES and _LANES % dim == 0:
        return _LANES // dim
    return 1


def flax_plan(input_dims: Sequence[int], output_dims: Sequence[int]):
    """The JAX package's ``plan_groups`` layout:
    ``[(dim, col_indices in plan order, logical row offsets)]``. Where the
    lane-packed alignment is cheap, a group's columns go in ascending
    vocabulary, each region padded to a multiple of ``k·TILE_P`` rows."""
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


def flax_field_order(input_dims: Sequence[int], output_dims: Sequence[int],
                     var_len_widths: Sequence[int] = ()) -> List[int]:
    """``order[p]``: the field at position p of the JAX package's stacked
    field tensor, numbering the categorical columns first and the var-len
    columns after them. The JAX package stacks the categorical columns in
    its plan's order when they share one width (vocabulary-ascending where
    the plan aligns them) and every var-len column pools to that width too,
    then the var-len columns; otherwise it concatenates every field in
    column order."""
    n = len(input_dims)
    var = list(range(n, n + len(var_len_widths)))
    plan = flax_plan(input_dims, output_dims)
    if len(plan) == 1 and all(int(w) == plan[0][0] for w in var_len_widths):
        return list(plan[0][1]) + var
    return list(range(n)) + var


class MultiColumnEmbedding(nn.Module):
    """Fused per-column embedding over a single (B, n_cat) int tensor.

    ``sharding`` (a ``parallel.sharded_embedding.TableSharding``, or None)
    row-shards the tables it takes: each is drawn whole from ``generator``,
    as a replicated table is, and this rank keeps its rows. Such a module
    loads a ``state_dict`` that holds either its shards or the whole
    logical tables, and :meth:`full_tables` puts the tables back together
    (a collective over the model axis). A row-sharded parameter carries
    the sharding as ``row_sharding`` and its table's rows as
    ``logical_rows``."""

    def __init__(self, input_dims: Sequence[int], output_dims: Sequence[int],
                 dropout_rate: float = 0.,
                 embeddings_initializer='uniform', generator=None,
                 sharding=None):
        super().__init__()
        if len(input_dims) != len(output_dims):
            raise ValueError(
                'The length of [input_dims] and [output_dims] must be the same.')
        self.n_cols = len(input_dims)
        self.dropout_rate = dropout_rate
        self.sharding = sharding
        # dim → the logical rows of each row-sharded table
        self.sharded_rows = {}
        init = get_initializer(embeddings_initializer, default='uniform')
        self._groups = []
        for dim, cols, offsets, total_vocab in plan_groups(input_dims,
                                                           output_dims):
            table = nn.Parameter(init(generator, (total_vocab, dim)))
            if sharding is not None and sharding.shards(total_vocab):
                axis = sharding.axis
                table = nn.Parameter(shard_rows(table.detach(), axis.size,
                                                axis.rank))
                table.row_sharding = sharding
                table.logical_rows = total_vocab
                self.sharded_rows[dim] = total_vocab
            self.register_parameter(f'{TABLE_PREFIX}{dim}', table)
            self.register_buffer(f'offsets_d{dim}', torch.from_numpy(offsets),
                                 persistent=False)
            self.register_buffer(f'cols_d{dim}', torch.tensor(cols),
                                 persistent=False)
            self._groups.append((dim, cols))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # a whole logical table loads as this rank's rows of it
        for dim, num_rows in self.sharded_rows.items():
            key = f'{prefix}{TABLE_PREFIX}{dim}'
            value = state_dict.get(key)
            if value is not None and value.shape[0] == num_rows:
                axis = self.sharding.axis
                state_dict[key] = shard_rows(value, axis.size, axis.rank)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def full_tables(self) -> dict:
        """``{parameter name: the logical table}`` of every row-sharded
        table, gathered over the model axis (every model rank calls it)."""
        return {f'{TABLE_PREFIX}{dim}': gather_table(
            getattr(self, f'{TABLE_PREFIX}{dim}'), num_rows,
            self.sharding.axis)
            for dim, num_rows in self.sharded_rows.items()}

    def forward(self, ids: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout mask in training."""
        if self.n_cols == 0 or ids.shape[1] == 0:
            return EmbeddingList()
        if ids.shape[1] != self.n_cols:
            raise ValueError(
                'The inputs dimension on axis 1 must be the same as the '
                'length of [input_dims].')
        ids = ids.to(torch.int32)
        batch = ids.shape[0]
        one_group = len(self._groups) == 1
        per_col = [None] * self.n_cols
        stacked = None
        for dim, cols in self._groups:
            table = getattr(self, f'embeddings_d{dim}')
            # one group holds every column in order: no column gather
            group_ids = ids if one_group \
                else ids[:, getattr(self, f'cols_d{dim}')]
            group_ids = group_ids + getattr(self, f'offsets_d{dim}')
            if dim in self.sharded_rows:
                emb = self.sharding(table, group_ids)
            else:
                emb = lookup(table, group_ids.reshape(-1)).reshape(
                    batch, len(cols), dim)
            if training:
                # SpatialDropout1D: drop whole embedding channels per
                # (example, channel), the same channels in every field
                emb = dropout(emb, self.dropout_rate, generator,
                              broadcast_dims=(1,))
            if one_group:
                stacked = emb
            for k, col in enumerate(cols):
                per_col[col] = emb[:, k:k + 1, :]
        return EmbeddingList(per_col, stacked=stacked)


def var_len_width(col) -> int:
    """The width of a var-len column's pooled field: D, or L·D when its
    tokens are kept flat (``pooling_strategy='flat'``)."""
    dim = int(col.embeddings_output_dim)
    if col.pooling_strategy == 'flat':
        return int(col.max_elements_length) * dim
    return dim


class VarLenColumnEmbedding(nn.Module):
    """Embedding of a padded multi-valued categorical column, ``(B, L)`` ids
    with 0 the padding id, pooled to one field: the port of
    ``deeptables_tpu/ops/embedding.py::VarLenColumnEmbedding``.

    ``pooling_strategy`` ``'max'`` and ``'avg'`` pool the tokens' rows to
    ``(B, 1, D)`` (a row with no tokens gives zeros), ``'flat'`` keeps them
    as ``(B, 1, L·D)`` with the padding's rows zeroed. The table is the
    parameter ``embeddings``, ``(vocabulary_size, D)`` float32, read through
    :func:`lookup`, so its gradient is the embedding-gradient kernel (K1).
    Dropout in training drops elements of the pooled field, its mask shared
    along the field axis, as the JAX package's ``broadcast_dims=(1,)``."""

    def __init__(self, vocabulary_size: int, output_dim: int,
                 dropout_rate: float = 0., pooling_strategy: str = 'max',
                 embeddings_initializer='uniform', generator=None):
        super().__init__()
        if pooling_strategy not in ('max', 'avg', 'flat'):
            raise ValueError(
                f'Unknown var-len pooling strategy: {pooling_strategy!r}')
        init = get_initializer(embeddings_initializer, default='uniform')
        self.embeddings = nn.Parameter(
            init(generator, (int(vocabulary_size), int(output_dim))))
        self.output_dim = int(output_dim)
        self.dropout_rate = dropout_rate
        self.pooling_strategy = pooling_strategy

    def forward(self, ids: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None):
        ids = ids.to(torch.int32)
        B, L = ids.shape
        emb = lookup(self.embeddings, ids.reshape(-1)).reshape(
            B, L, self.output_dim)
        mask = (ids > 0).to(emb.dtype)[..., None]  # (B, L, 1)
        if self.pooling_strategy == 'avg':
            denom = torch.clamp_min(mask.sum(dim=1), 1.0)
            out = ((emb * mask).sum(dim=1) / denom)[:, None, :]
        elif self.pooling_strategy == 'max':
            neg = torch.finfo(emb.dtype).min
            masked = torch.where(mask > 0, emb, torch.full((), neg,
                                                           dtype=emb.dtype,
                                                           device=emb.device))
            # amax shares the gradient among ties, as JAX's max does
            out = masked.amax(dim=1)
            any_tok = mask.sum(dim=1) > 0
            out = torch.where(any_tok, out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))
            out = out[:, None, :]
        else:
            out = (emb * mask).reshape(B, 1, L * self.output_dim)
        if training:
            out = dropout(out, self.dropout_rate, generator,
                          broadcast_dims=(1,))
        return out
