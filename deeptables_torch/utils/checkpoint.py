# -*- coding:utf-8 -*-
"""Checkpoints of a model and its optimizer (counterpart of
``deeptables_tpu/utils/checkpoint.py``, whose directory checkpoints are
orbax's).

The port writes ``torch.distributed.checkpoint`` directories, which ship
inside torch. They hold a ``DeepModel``'s parameters and BatchNorm
statistics, its optimizer's state (Adam's moments and step, or any
``torch.optim.Optimizer`` subclass's) and a stateful loss's state (GHMC's
histogram); or a module's and an optimizer's; or a nested dict of tensors.
They work in one process with no process group; under a data-parallel
group every rank calls them, the replicated tensors are written once, and
every rank restores them. A table row-sharded over a model axis
(``parallel/sharded_embedding.py``), and its optimizer state, is written as
a ``DTensor`` sharded over the model-axis group, with the logical table's
global shape (a plain tensor under one key on every rank would be taken as
replicated, and only rank 0's rows kept): it restores on the same mesh bit
for bit, and :func:`restore_checkpoint` without a template reads it whole.
``save_orbax`` and ``restore_orbax`` are the same functions under the JAX
package's names.
"""

import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata
from torch.distributed.checkpoint.state_dict import (get_state_dict,
                                                     set_state_dict)

from . import dt_logging

logger = dt_logging.get_logger(__name__)


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _parts(state, optimizer):
    """(module, optimizer, the DeepModel or None) of what is checkpointed;
    a DeepModel's optimizer is made if it has none yet."""
    if hasattr(state, 'build') and hasattr(state, 'make_optimizer'):
        return state.build(), state.make_optimizer(), state
    return state, optimizer, None


def _as_dtensor(local: torch.Tensor, num_rows: int, axis):
    """This rank's ``(R, ...)`` rows of a row-sharded table (or of a tensor
    of its shape) as a DTensor sharded on dim 0 over the model-axis group,
    of global shape ``(num_rows, ...)``: DTensor's ``Shard(0)`` puts rows
    ``[m·R, (m+1)·R)`` on rank m, as the sharded table does (its zero
    padding rows left out)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    mesh = DeviceMesh.from_group(
        axis.group if axis.group is not None else dist.group.WORLD,
        local.device.type)
    R = local.shape[0]
    rows = max(0, min(R, num_rows - axis.rank * R))
    shape = torch.Size((num_rows,) + tuple(local.shape[1:]))
    return DTensor.from_local(local[:rows], mesh, [Shard(0)],
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device='meta')
                              .stride())


def _shard_tensors(module, model_sd, optim_sd) -> dict:
    """Put the row-sharded tables of ``module`` in ``model_sd`` and their
    optimizer state (the tensors of the table's shape) in ``optim_sd`` as
    DTensors, in place. Returns ``{(dict, key): the plain tensor}`` of what
    was replaced."""
    replaced = {}
    for name, p in module.named_parameters():
        sharding = getattr(p, 'row_sharding', None)
        if sharding is None:
            continue
        axis = sharding.axis
        places = [(model_sd, name)]
        if optim_sd is not None:
            per = optim_sd['state'].get(name, {})
            places += [(per, k) for k, v in per.items()
                       if torch.is_tensor(v) and v.shape == p.shape]
        for where, key in places:
            replaced[(id(where), key)] = (where, key, where[key])
            where[key] = _as_dtensor(where[key], p.logical_rows, axis)
    return replaced


def _unshard_tensors(replaced):
    """Undo :func:`_shard_tensors`, the DTensors' rows copied back into the
    plain tensors."""
    for where, key, plain in replaced.values():
        local = where[key].to_local()
        plain[:local.shape[0]].copy_(local)
        where[key] = plain


def _state(state, optimizer) -> tuple:
    """The flat-keyed dict that is written or restored in place, and what
    :func:`_shard_tensors` replaced in it."""
    if isinstance(state, dict):
        return state, {}
    module, optimizer, deep_model = _parts(state, optimizer)
    if optimizer is None:
        model_sd = module.state_dict()
        return {'model': model_sd}, _shard_tensors(module, model_sd, None)
    model_sd, optim_sd = get_state_dict(module, optimizer)
    replaced = _shard_tensors(module, model_sd, optim_sd)
    out = {'model': model_sd, 'optimizer': optim_sd}
    if deep_model is not None:
        loss_state = deep_model.initial_loss_state()
        if loss_state is not None:
            out['loss_state'] = loss_state
    return out, replaced


def save_checkpoint(path, state, optimizer: Optional[torch.optim.Optimizer]
                    = None, force: bool = True) -> str:
    """Write ``state`` to the directory ``path``: a ``DeepModel`` (its
    module, optimizer and loss state), an ``nn.Module`` (with
    ``optimizer``, its state too) or a nested dict of tensors. ``force``
    replaces a checkpoint already there. Returns the absolute path."""
    path = os.path.abspath(path)
    in_group = _in_group()
    if os.path.exists(path):
        if not force:
            raise FileExistsError(f'checkpoint {path} exists')
        if not in_group or dist.get_rank() == 0:
            shutil.rmtree(path)
    if in_group:
        dist.barrier()
    out, replaced = _state(state, optimizer)
    try:
        dcp.save(out, checkpoint_id=path, no_dist=not in_group)
    finally:
        _unshard_tensors(replaced)
    return path


def _saved_tensors(path) -> dict:
    """Empty CPU tensors of every tensor a checkpoint holds, nested as they
    were saved."""
    reader = dcp.FileSystemReader(path)
    metadata = reader.read_metadata()
    flat = {key: torch.empty(md.size, dtype=md.properties.dtype)
            for key, md in metadata.state_dict_metadata.items()
            if isinstance(md, TensorStorageMetadata)}
    dcp.load(flat, storage_reader=reader, no_dist=not _in_group())
    paths = metadata.planner_data or {}
    out = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = paths.get(key, (key,))
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def restore_checkpoint(path, template=None,
                       optimizer: Optional[torch.optim.Optimizer] = None):
    """Read the checkpoint at ``path`` into ``template``, in place, on the
    template's devices: a ``DeepModel`` (its module, optimizer and loss
    state; the optimizer is made if it has none), an ``nn.Module`` (with
    ``optimizer``) or a nested dict of tensors; returns the template.
    Without one, returns the checkpoint's tensors as a nested dict on the
    CPU."""
    path = os.path.abspath(path)
    if template is None:
        return _saved_tensors(path)
    state, replaced = _state(template, optimizer)
    dcp.load(state, checkpoint_id=path, no_dist=not _in_group())
    _unshard_tensors(replaced)
    if isinstance(template, dict):
        return template
    module, optimizer, deep_model = _parts(template, optimizer)
    if optimizer is None:
        module.load_state_dict(state['model'])
    else:
        set_state_dict(module, optimizer, model_state_dict=state['model'],
                       optim_state_dict=state['optimizer'])
    if deep_model is not None and 'loss_state' in state:
        deep_model.loss_state = state['loss_state']
    return template


# the JAX package's names
save_orbax = save_checkpoint
restore_orbax = restore_checkpoint
