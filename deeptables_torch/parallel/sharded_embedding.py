# -*- coding:utf-8 -*-
"""Row-sharded embedding tables over the model axis of a ``(data, model)``
mesh (counterpart of ``deeptables_tpu/parallel/sharded_embedding.py``).

Layout. Model rank m holds rows ``[m·R, (m+1)·R)`` of a logical ``(V, D)``
table, ``R = ceil(V / S)`` over a model axis of S ranks, the last shard
padded with zero rows to R (:func:`shard_rows`, :func:`unshard_rows`). The
JAX package shards only tables whose lane-packed rows divide S, and pads
the packed rows to S under ``'sharded_a2a'`` (its ``ops/embedding.py``);
the port's tables are logical, so it pads under both strategies. The
padding is a layout of the port, not a change of results: no id reaches a
padding row, its gradient is zero, and it stays zero.

Placement. :func:`shard_plan` says which tables are row-sharded: the
``embeddings_d{dim}`` tables of ``MultiColumnEmbedding`` with at least
``max(shard_threshold, S)`` rows (var-len tables stay replicated, as in
the JAX package's a2a dry run). ``MultiColumnEmbedding`` draws the whole
table from the model's seed and keeps its rank's rows, so a sharded model
starts from the replicated model's weights.

Lookups, each over the ids of this rank's data shard, returning the rows
replicated over the model axis:

- :func:`sharded_lookup` (``'sharded'``): a masked local gather and a sum
  over the model axis.
- :func:`sharded_lookup_a2a` (``'sharded_a2a'``): a stripe of the ids for
  each model rank, a stable sort-by-owner dispatch with a capacity
  (:func:`_dispatch_plan`), two ``all_to_all``\\ s around a masked local
  gather, and an ``all_gather`` of the stripes.

Gradients. Every model rank of a data shard runs the same dense forward on
the same rows, so it holds the same upstream gradient: the backward of the
final sum is the identity and the backward of the final ``all_gather``
takes the rank's own stripe (a library ``all_reduce``'s backward would sum
the gradient over the model axis, S times too much). The return trip sends
each row's gradient to its owner, and the shard's gradient is the
embedding-gradient kernel (``ops/kernels/emb_grad.py``, K1) over the
shard's R rows at the local ids; slots that are unused or not owned carry
a zero gradient at a clipped id. The data axis then sums the shard's
gradient with the dense ones (``mesh.all_reduce_gradients``).
"""

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..ops.kernels.emb_grad import emb_grad
from ..utils import dt_logging
from .mesh import SHARDED_TABLES, Mesh, ModelAxis

logger = dt_logging.get_logger(__name__)

TABLE_PREFIX = 'embeddings_d'


def is_embedding_table(name: str, value) -> bool:
    """A 2-D tensor under an ``emb_*`` module is an embedding table."""
    if getattr(value, 'ndim', 0) != 2:
        return False
    return any(part.startswith('emb_') for part in name.split('.'))


def rows_per_shard(num_rows: int, model_size: int) -> int:
    """R: the rows each of ``model_size`` ranks holds of a table of
    ``num_rows`` rows."""
    return -(-int(num_rows) // int(model_size))


def shards_table(num_rows: int, model_size: int,
                 shard_threshold: int = 0) -> bool:
    """Whether a ``MultiColumnEmbedding`` table of ``num_rows`` rows is
    row-sharded over a model axis of ``model_size``."""
    return model_size > 1 and num_rows >= max(shard_threshold, model_size)


def shard_plan(named_tensors, model_size: int, shard_threshold: int = 0):
    """``{name: R}`` for the tables of ``named_tensors`` (name → tensor or
    array, e.g. a ``state_dict``) that are row-sharded over a model axis
    of ``model_size``; every other tensor is replicated."""
    plan = {}
    for name, value in dict(named_tensors).items():
        if is_embedding_table(name, value) \
                and name.rsplit('.', 1)[-1].startswith(TABLE_PREFIX) \
                and shards_table(value.shape[0], model_size,
                                 shard_threshold):
            plan[name] = rows_per_shard(value.shape[0], model_size)
    return plan


def shard_rows(table: torch.Tensor, model_size: int,
               model_rank: int) -> torch.Tensor:
    """Model rank ``model_rank``'s rows of the logical ``table``:
    ``[m·R, (m+1)·R)``, zero rows past its end."""
    R = rows_per_shard(table.shape[0], model_size)
    part = table[model_rank * R:(model_rank + 1) * R]
    out = table.new_zeros((R,) + tuple(table.shape[1:]))
    out[:part.shape[0]] = part
    return out


def unshard_rows(shards, num_rows: int) -> torch.Tensor:
    """The logical table of ``num_rows`` rows from every rank's shard, in
    model-rank order (the padding rows dropped)."""
    return torch.cat(list(shards))[:num_rows]


def gather_table(shard: torch.Tensor, num_rows: int,
                 axis: ModelAxis) -> torch.Tensor:
    """The logical table from the shards of the model axis (a collective:
    every model rank calls it); no gradient."""
    parts = [torch.empty_like(shard) for _ in range(axis.size)]
    dist.all_gather(parts, shard.detach().contiguous(), group=axis.group)
    return unshard_rows(parts, num_rows)


def _masked(rows, valid):
    """``rows`` with the rows that ``valid`` does not mark zeroed."""
    return torch.where(valid[:, None], rows, torch.zeros(
        (), dtype=rows.dtype, device=rows.device))


class _LocalGather(torch.autograd.Function):
    """``shard[rel]`` with the rows that ``valid`` does not mark zeroed;
    the backward is K1 over the shard's rows, a zero gradient at the rows
    not marked."""

    @staticmethod
    def forward(ctx, shard, rel, valid):
        ctx.save_for_backward(rel, valid)
        ctx.num_rows = shard.shape[0]
        return _masked(shard.index_select(0, rel), valid)

    @staticmethod
    def backward(ctx, g):
        rel, valid = ctx.saved_tensors
        g = _masked(g.float(), valid).contiguous()
        return emb_grad(rel, g, ctx.num_rows), None, None


def _local_gather(shard, ids, model_rank):
    """Rows of the shard at the flat global ``ids``: the local ids, clipped
    into the shard, and the mask of those it owns."""
    R = shard.shape[0]
    rel = ids - model_rank * R
    valid = (rel >= 0) & (rel < R)
    rel = rel.clamp(0, R - 1).to(torch.int32).contiguous()
    return _LocalGather.apply(shard, rel, valid)


class _SumOverModel(torch.autograd.Function):
    """The sum over the model axis of the rows each rank owns; the result
    is replicated, and so is its gradient: the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sharded_lookup(table_shard: torch.Tensor, ids: torch.Tensor,
                   mesh: Mesh) -> torch.Tensor:
    """Row-sharded lookup, ``'sharded'``: a masked local gather and a sum
    over the model axis (the counterpart of the JAX ``sharded_lookup``,
    whose ``psum`` XLA inserts under a row-sharded table).

    table_shard: this rank's ``(R, D)`` rows; ids: ``(B, F)`` global row
    ids of this rank's data shard (every model rank of it passes the same).
    Returns ``(B, F, D)``, replicated over the model axis. A collective
    over the model axis."""
    axis = mesh.model_axis
    flat = ids.reshape(-1)
    rows = _SumOverModel.apply(_local_gather(table_shard, flat, axis.rank),
                               axis.group)
    return rows.reshape(*ids.shape, table_shard.shape[1])


def _dispatch_plan(flat_ids, n_shards, capacity, rows_per_shard):
    """Sort-by-owner dispatch for an all-to-all exchange (MoE-style).

    Returns (send_ids, order, slot_owner, slot_pos, keep): ``send_ids[s,
    c]`` is the id this rank asks shard ``s`` for in slot ``c`` (0 when
    unused); ``order`` sorts the ids by owner, stably; entry j of the
    sorted ids goes to slot ``(slot_owner[j], slot_pos[j])`` when
    ``keep[j]``. Ids past ``capacity`` for one owner are dropped (zero
    rows, zero gradient)."""
    n = flat_ids.shape[0]
    owner = torch.clamp(torch.div(flat_ids.long(), rows_per_shard,
                                  rounding_mode='floor'), 0, n_shards - 1)
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order]
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(
        sorted_owner, torch.arange(n_shards, device=owner.device))
    pos = torch.arange(n, device=owner.device) - seg_start[sorted_owner]
    keep = pos < capacity
    slot_pos = torch.where(keep, pos, torch.full_like(pos, capacity))
    send_ids = torch.zeros((n_shards, capacity), dtype=flat_ids.dtype,
                           device=flat_ids.device)
    send_ids[sorted_owner[keep], slot_pos[keep]] = sorted_ids[keep]
    return send_ids, order, sorted_owner, slot_pos, keep


def _all_to_all(x, group):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _Exchange(torch.autograd.Function):
    """One stripe's rows through the all-to-all exchange: its requests out,
    a masked local gather at each owner, the rows back, un-permuted into
    the stripe's order. The backward is the exact transpose: the stripe's
    row gradients permuted into their slots, ``all_to_all``'d back to their
    owners, and K1 over each owner's shard at the local ids."""

    @staticmethod
    def forward(ctx, shard, recv_rel, recv_valid, src, group):
        S, C = recv_rel.shape
        D = shard.shape[1]
        rows = _masked(shard.index_select(0, recv_rel.reshape(-1)),
                       recv_valid.reshape(-1))
        back = _all_to_all(rows.reshape(S, C, D), group).reshape(S * C, D)
        # src[i]: the slot of stripe entry i, or S·C (the zero row) where
        # it was dropped
        back = torch.cat([back, back.new_zeros((1, D))])
        ctx.save_for_backward(recv_rel, recv_valid, src)
        ctx.group = group
        ctx.num_rows = shard.shape[0]
        return back.index_select(0, src)

    @staticmethod
    def backward(ctx, g):
        recv_rel, recv_valid, src = ctx.saved_tensors
        S, C = recv_rel.shape
        D = g.shape[1]
        g = g.float()
        kept = src < S * C
        slots = g.new_zeros((S * C, D))
        slots[src[kept]] = g[kept]
        g_rows = _all_to_all(slots.reshape(S, C, D), ctx.group).reshape(
            S * C, D)
        g_rows = _masked(g_rows, recv_valid.reshape(-1)).contiguous()
        return (emb_grad(recv_rel.reshape(-1).contiguous(), g_rows,
                         ctx.num_rows), None, None, None, None)


class _GatherStripes(torch.autograd.Function):
    """The model axis's stripes put together; every rank holds the same
    upstream gradient, so the backward takes this rank's stripe of it."""

    @staticmethod
    def forward(ctx, stripe_rows, axis):
        parts = [torch.empty_like(stripe_rows) for _ in range(axis.size)]
        dist.all_gather(parts, stripe_rows.contiguous(), group=axis.group)
        ctx.rank = axis.rank
        ctx.stripe = stripe_rows.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.stripe
        return g[lo:lo + ctx.stripe], None


def a2a_capacity(stripe: int, n_model: int, capacity_factor=None) -> int:
    """Slots a rank offers each shard: the whole stripe (exact for any
    skew) when ``capacity_factor`` is None, else ``ceil(stripe / S)·
    max(1, capacity_factor)`` within ``[1, stripe]``."""
    if capacity_factor is None:
        return stripe
    return int(min(stripe, max(1, -(-stripe // n_model) *
                               max(1.0, capacity_factor))))


def sharded_lookup_a2a(table_shard: torch.Tensor, ids: torch.Tensor,
                       mesh: Mesh, capacity_factor: Optional[float] = None,
                       use_pallas_gather: bool = False) -> torch.Tensor:
    """Row-sharded lookup via an explicit all-to-all exchange
    (``'sharded_a2a'``; the counterpart of the JAX ``sharded_lookup_a2a``,
    step for step). Each model rank:

    1. takes a stripe of ``ceil(n / S)`` of the n flat ids (padded with id 0
       to ``S`` stripes),
    2. routes each id to its owner with a stable sort-by-owner dispatch
       (:func:`_dispatch_plan`) of ``capacity`` slots an owner,
    3. ``all_to_all``\\ s the requests, answers them with a masked local
       gather, ``all_to_all``\\ s the rows back and un-permutes them,
    4. ``all_gather``\\ s the stripes over the model axis.

    table_shard: this rank's ``(R, D)`` rows; ids: ``(B, F)`` global row
    ids of this rank's data shard (every model rank of it passes the same).
    Returns ``(B, F, D)``, replicated over the model axis. A collective
    over the model axis.

    ``capacity_factor=None`` (the default) is exact for any skew; a number
    opts into MoE-style capacity bounding: each owner takes at most
    ``ceil(stripe/S)·capacity_factor`` requests of a stripe, ids beyond it
    give zero rows and zero gradient, and the drops, summed over the model
    axis, are logged (``sharded_lookup_a2a.drops`` adds them up).

    Where the JAX function differs: it takes the global batch and pads a
    remainder batch to the data shards; the port's ranks each take their
    data shard's rows (``DeepModel`` pads a remainder batch before it
    splits it). Its lane-packing argument ``dim`` (k logical rows a TPU
    row) is a TPU layout; the port's tables are logical (k = 1).
    ``use_pallas_gather`` is accepted and only warns, as there."""
    axis = mesh.model_axis
    S, me = axis.size, axis.rank
    R, D = table_shard.shape
    flat = ids.reshape(-1)
    n_local = flat.shape[0]
    stripe = max(1, -(-n_local // S))
    capacity = a2a_capacity(stripe, S, capacity_factor)
    pad = stripe * S - n_local
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    my_ids = flat[me * stripe:(me + 1) * stripe]

    send_ids, order, slot_owner, slot_pos, keep = _dispatch_plan(
        my_ids, S, capacity, R)
    if capacity < stripe:  # sub-exact capacity opt-in: surface the drops
        dropped = (~keep).sum().reshape(1)
        dist.all_reduce(dropped, group=axis.group)
        dropped = int(dropped.item())
        sharded_lookup_a2a.drops += dropped
        if dropped and me == 0:
            logger.warning(
                f'sharded_lookup_a2a: {dropped} ids exceeded the per-shard '
                f'capacity and were dropped (zero rows, zero gradient). '
                f'Raise capacity_factor (None = exact) to avoid silent '
                f'quality loss.')
    if use_pallas_gather:
        logger.warning(
            'use_pallas_gather is a no-op: the JAX package removed its '
            'Pallas gather after two measured declines; the port gathers '
            'with index_select.')
    recv_ids = _all_to_all(send_ids, axis.group)
    rel = recv_ids - me * R
    valid = (rel >= 0) & (rel < R)
    rel = rel.clamp(0, R - 1).to(torch.int32).contiguous()
    # where each stripe entry's row comes back: its slot, or the zero row
    slot = slot_owner * capacity + slot_pos
    src = torch.full((stripe,), S * capacity, dtype=torch.long,
                     device=flat.device)
    src[order] = torch.where(keep, slot, torch.full_like(slot, S * capacity))
    mine = _Exchange.apply(table_shard, rel, valid, src, axis.group)
    full = _GatherStripes.apply(mine, axis)
    return full[:n_local].reshape(*ids.shape, D)


sharded_lookup_a2a.drops = 0


class TableSharding(NamedTuple):
    """How ``MultiColumnEmbedding`` row-shards its tables: over the model
    axis of ``strategy``'s mesh (found on first use), looked up by
    ``lookup`` (``'sharded'`` or ``'sharded_a2a'``, the latter with
    ``capacity_factor``), tables of at least ``shard_threshold`` rows."""
    strategy: object
    lookup: str = 'sharded'
    capacity_factor: Optional[float] = None
    shard_threshold: int = 0

    @property
    def mesh(self) -> Mesh:
        return self.strategy.mesh

    @property
    def axis(self) -> ModelAxis:
        return self.mesh.model_axis

    def shards(self, num_rows: int) -> bool:
        return shards_table(num_rows, self.axis.size, self.shard_threshold)

    def __call__(self, table_shard, ids):
        if self.lookup == 'sharded':
            return sharded_lookup(table_shard, ids, self.mesh)
        return sharded_lookup_a2a(table_shard, ids, self.mesh,
                                  capacity_factor=self.capacity_factor)


def table_sharding(config, strategy) -> Optional[TableSharding]:
    """The ``TableSharding`` of a model's config under ``strategy``, or
    None where its tables are replicated (``'replicated'``, or a model axis
    of 1)."""
    if config.embedding_device_strategy not in SHARDED_TABLES \
            or strategy.model_axis is None:
        return None
    return TableSharding(strategy, config.embedding_device_strategy,
                         config.embedding_a2a_capacity_factor,
                         int(getattr(strategy, 'shard_threshold', 0) or 0))
