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
every rank restores them. ``save_orbax`` and ``restore_orbax`` are the same
functions under the JAX package's names.
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


def _state(state, optimizer) -> dict:
    """The flat-keyed dict that is written or restored in place."""
    if isinstance(state, dict):
        return state
    module, optimizer, deep_model = _parts(state, optimizer)
    if optimizer is None:
        return {'model': module.state_dict()}
    model_sd, optim_sd = get_state_dict(module, optimizer)
    out = {'model': model_sd, 'optimizer': optim_sd}
    if deep_model is not None:
        loss_state = deep_model.initial_loss_state()
        if loss_state is not None:
            out['loss_state'] = loss_state
    return out


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
    dcp.save(_state(state, optimizer), checkpoint_id=path,
             no_dist=not in_group)
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
    state = _state(template, optimizer)
    dcp.load(state, checkpoint_id=path, no_dist=not _in_group())
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
