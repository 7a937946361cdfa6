# -*- coding:utf-8 -*-
"""Distribution strategies over ``torch.distributed`` (counterpart of
``deeptables_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, model)`` mesh over its devices and lets XLA
insert the collectives. The port keeps the names and the shape: a
:class:`Mesh` is a ``(data, model)`` view of a process group, one process a
device, and a strategy goes in ``ModelConfig.distribute_strategy`` as it
does there.

- :class:`DistributionStrategy` itself (what ``distribute_strategy=None``
  gives) trains in this process alone: one data shard, no collective.
- :class:`DataParallel` trains over every rank of the process group (the
  default group, or ``group``): each rank takes its rows of each global
  batch, BatchNorm's statistics, the loss's normalisation, GHMC's histogram
  and the dropout masks are those of the global batch, and the gradients
  are summed over the ranks, one ``all_reduce`` a tensor in parameter order
  (``models/deepmodel.py``). ``num_devices`` must equal the group's size.
- :class:`DataAndModelParallel` adds a model axis: rank ``r = d·S + m`` of
  a group of ``D·S`` processes is data shard ``d`` and model rank ``m``, the
  JAX mesh's row-major ``reshape(data, model)``. Under
  ``embedding_device_strategy='sharded'`` or ``'sharded_a2a'`` every
  ``embeddings_d{dim}`` table is row-sharded over the model axis
  (``parallel/sharded_embedding.py``); the model ranks of a data shard run
  the same dense forward on the same rows. BatchNorm, dropout, GHMC, the
  loss and the gradients' sum run over the data axis (the ranks with the
  same m); the lookups exchange rows over the model axis (the ranks with
  the same d). With a model axis of 1 it is ``DataParallel``.

Start ``D·S`` processes (``torchrun --nproc-per-node``), initialise the
default group (``parallel.initialize_distributed``), and pass
``DataAndModelParallel(data_parallel=D, model_parallel=S)``; every rank calls
``fit``, ``predict``, ``evaluate`` and ``save`` with the same arguments.

A strategy holds a process-group handle, which does not pickle: it is
dropped with the mesh when a strategy is pickled, as the JAX package drops
its mesh, and found again on first use.
"""

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

SHARDED_TABLES = ('sharded', 'sharded_a2a')


def _world(group) -> tuple:
    """(rank, size) of this process in ``group`` (the default group when
    None), (0, 1) without an initialised process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


class Mesh(NamedTuple):
    """A ``(data, model)`` grid of the ranks of ``group``; ``shape`` maps
    each axis to its size, as a JAX mesh's does. ``rank`` is this process's
    rank in ``group``, ``d·S + m``; ``data_group`` holds the ranks with this
    rank's m (None with one data shard), ``model_group`` those with its d
    (None with a model axis of 1)."""
    shape: dict
    rank: int
    group: Optional[object]
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[MODEL_AXIS]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[MODEL_AXIS]

    @property
    def model_axis(self) -> 'ModelAxis':
        return ModelAxis(self.model_index, self.shape[MODEL_AXIS],
                         self.model_group)


class ModelAxis(NamedTuple):
    """This rank's place on the model axis: index m of ``size`` ranks in
    ``group``, the ranks of its data shard."""
    rank: int
    size: int
    group: Optional[object]


def build_mesh(data_parallel: Optional[int] = None, model_parallel: int = 1,
               group=None) -> Mesh:
    """A ``(data, model)`` mesh over the processes of ``group`` (the
    default process group; one process without one). ``data_parallel``
    defaults to the group's size over ``model_parallel``; the product must
    equal the group's size. Rank ``r = d·S + m`` is data shard ``d`` and
    model rank ``m``. With both axes larger than 1 it makes the process
    groups of each axis (``dist.new_group``, every group on every rank in
    one order: the data-axis groups by m, then the model-axis groups by d),
    so every rank of the default group calls it."""
    rank, size = _world(group)
    if model_parallel is None or model_parallel <= 0:
        model_parallel = 1
    if data_parallel is None:
        data_parallel = size // model_parallel
    if data_parallel * model_parallel != size:
        raise ValueError(
            f'Mesh {data_parallel}x{model_parallel} needs '
            f'{data_parallel * model_parallel} processes, but the process '
            f'group has {size}: start one process a device (torchrun) and '
            f'initialise the group (parallel.initialize_distributed) first.')
    shape = {DATA_AXIS: data_parallel, MODEL_AXIS: model_parallel}
    if model_parallel == 1:
        return Mesh(shape, rank, group, group if data_parallel > 1 else None)
    if data_parallel == 1:
        return Mesh(shape, rank, group, None, group)
    ranks = list(range(size)) if group is None \
        else dist.get_process_group_ranks(group)
    S = model_parallel
    data_groups = [dist.new_group([ranks[d * S + m]
                                   for d in range(data_parallel)])
                   for m in range(S)]
    model_groups = [dist.new_group(ranks[d * S:(d + 1) * S])
                    for d in range(data_parallel)]
    return Mesh(shape, rank, group, data_groups[rank % S],
                model_groups[rank // S])


class RowShard(NamedTuple):
    """This rank's share of a global batch: rows ``[rank·n/size, (rank +
    1)·n/size)`` of each batch of n rows; ``rank`` is the data index d,
    ``group`` the data-axis group (the ranks that hold the other rows)."""
    rank: int
    size: int
    group: Optional[object]

    def rows(self, n: int) -> slice:
        if n % self.size:
            raise ValueError(
                f'a batch of {n} rows does not divide {self.size} data '
                f'shards')
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    'deeptables_torch_row_shard', default=None)


def active_shard() -> Optional[RowShard]:
    """The data-parallel shard of the training step running in this
    context (``row_shard``), or None: BatchNorm, dropout and GHMC read it
    to compute over the global batch."""
    return _ACTIVE.get()


@contextlib.contextmanager
def row_shard(shard: Optional[RowShard]):
    """Run a training step's forward and backward as ``shard`` of the
    global batch (None: as the whole batch)."""
    token = _ACTIVE.set(shard)
    try:
        yield shard
    finally:
        _ACTIVE.reset(token)


class DistributionStrategy:
    """One process, one data shard, no collective; the base of the others.
    ``mesh`` is built on first use (``build_default_mesh``)."""

    def __init__(self, mesh: Optional[Mesh] = None, group=None):
        self._mesh = mesh
        self._group = group

    @property
    def mesh(self) -> Mesh:
        if self._mesh is None:
            self._mesh = self.build_default_mesh()
        return self._mesh

    def build_default_mesh(self) -> Mesh:
        return Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, 0, None)

    @property
    def num_data_shards(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def shard(self) -> Optional[RowShard]:
        """This rank's rows of a global batch, or None with one data
        shard."""
        if self.num_data_shards == 1:
            return None
        return RowShard(self.mesh.data_index, self.num_data_shards,
                        self.mesh.data_group)

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        """This rank's place on the model axis, or None with a model axis
        of 1."""
        if self.mesh.shape[MODEL_AXIS] == 1:
            return None
        return self.mesh.model_axis

    @property
    def is_chief(self) -> bool:
        """Whether this process writes what the job writes once (model
        files, logs): rank 0."""
        return self.mesh.rank == 0

    def validate(self, embedding_device_strategy: str = 'replicated'):
        """Raise unless the process group matches the strategy (its mesh
        builds) and ``embedding_device_strategy`` is ``'replicated'``,
        ``'sharded'`` or ``'sharded_a2a'`` (the sharded ones row-shard the
        tables over a model axis larger than 1; over a model axis of 1 the
        tables are replicated, as in the JAX package)."""
        self.mesh
        if embedding_device_strategy not in ('replicated',) + \
                SHARDED_TABLES:
            raise ValueError(f'Unknown embedding_device_strategy: '
                             f'{embedding_device_strategy!r}')

    # a process group handle does not pickle (the JAX package drops its
    # mesh the same way)
    def __getstate__(self):
        state = dict(self.__dict__)
        state['_mesh'] = None
        state['_group'] = None
        return state


class DataParallel(DistributionStrategy):
    """Data parallelism over the process group: each rank a device and a
    shard of every batch, the parameters replicated and the gradients
    summed. ``num_devices`` (default: the group's size) must equal the
    group's size."""

    def __init__(self, num_devices: Optional[int] = None, mesh=None,
                 group=None):
        super().__init__(mesh, group)
        self.num_devices = num_devices

    def build_default_mesh(self):
        return build_mesh(data_parallel=self.num_devices, model_parallel=1,
                          group=self._group)


class DataAndModelParallel(DistributionStrategy):
    """Data parallelism and a model axis for row-sharded embedding tables.

    Use with ``ModelConfig.embedding_device_strategy='sharded'`` (a masked
    local gather and a sum over the model axis) or ``'sharded_a2a'`` (an
    all-to-all exchange): tables of at least ``max(shard_threshold,
    model_parallel)`` rows are row-sharded over the model axis
    (``parallel/sharded_embedding.py``), the others replicated."""

    def __init__(self, data_parallel: Optional[int] = None,
                 model_parallel: int = 1, mesh=None, shard_threshold: int = 0,
                 group=None):
        super().__init__(mesh, group)
        self.data_parallel = data_parallel
        self.model_parallel = model_parallel
        self.shard_threshold = shard_threshold

    def build_default_mesh(self):
        return build_mesh(data_parallel=self.data_parallel,
                          model_parallel=self.model_parallel,
                          group=self._group)


def get_strategy(config_strategy) -> DistributionStrategy:
    """``ModelConfig.distribute_strategy`` as a strategy: None trains in
    this process alone; ``'data'``, ``'data_parallel'`` or ``'mirrored'``
    over the process group."""
    if config_strategy is None:
        return DistributionStrategy()
    if isinstance(config_strategy, DistributionStrategy):
        return config_strategy
    if isinstance(config_strategy, str):
        if config_strategy in ('data', 'data_parallel', 'mirrored'):
            return DataParallel()
        raise ValueError(f'Unknown distribute_strategy: {config_strategy!r}')
    raise ValueError(
        f'[distribute_strategy] must be a DistributionStrategy, got '
        f'{type(config_strategy)}')


def all_reduce_gradients(parameters, shard: RowShard):
    """Sum every gradient over the shard's ranks (the data axis) in place,
    one ``all_reduce`` a tensor in the order of ``parameters``: the dense
    parameters' and a row-sharded table's alike (the ranks of one data-axis
    group hold the same rows of it)."""
    for p in parameters:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=shard.group)


def all_gather_rows(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The ranks' row shards of x put back together in global-batch order
    (no gradient); bfloat16 travels as float32, exactly."""
    wire = (x.float() if x.dtype == torch.bfloat16 else x).contiguous()
    parts = [torch.empty_like(wire) for _ in range(shard.size)]
    dist.all_gather(parts, wire, group=shard.group)
    return torch.cat(parts).to(x.dtype)
