# -*- coding:utf-8 -*-
"""Multi-process initialisation helpers (counterpart of
``deeptables_tpu/parallel/multihost.py``).

The port runs one process a device. ``initialize_distributed`` joins the
``torch.distributed`` process group from the arguments, or from the
environment that ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); in one process with neither it
does nothing. ``host_info`` and ``per_host_batch`` give the data-sharding
facts the input pipeline needs (``ChunkedSource(host_id=...,
num_hosts=...)``), with the JAX package's keys: a process is a host there.
"""

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..utils import dt_logging

logger = dt_logging.get_logger(__name__)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, init_method=None, backend=None,
                           timeout: Optional[timedelta] = None):
    """Join the process group (a no-op in one process with no arguments and
    no environment, or when this process has joined already).

    ``coordinator_address`` (``'host:port'``, else ``MASTER_ADDR`` and
    ``MASTER_PORT``) or ``init_method`` (any ``torch.distributed`` URL, a
    ``file://`` store among them) says where the processes meet;
    ``num_processes`` (else ``WORLD_SIZE``) and ``process_id`` (else
    ``RANK``) say how many and which. ``backend`` defaults to NCCL where
    CUDA is available and gloo on the CPU; under NCCL the process takes the
    card ``LOCAL_RANK`` (else its rank modulo the cards). Returns
    :func:`host_info`."""
    if dist.is_initialized():
        return host_info()
    if num_processes is None:
        num_processes = _env_int('WORLD_SIZE')
    if process_id is None:
        process_id = _env_int('RANK')
    if coordinator_address is None and os.environ.get('MASTER_ADDR') \
            and os.environ.get('MASTER_PORT'):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if init_method is None and coordinator_address is not None:
        init_method = f'tcp://{coordinator_address}'
    if init_method is None and num_processes is None:
        return host_info()
    if init_method is None or num_processes is None or process_id is None:
        raise ValueError(
            'initialize_distributed needs where the processes meet '
            '(coordinator_address, init_method or MASTER_ADDR/MASTER_PORT), '
            'their number (num_processes or WORLD_SIZE) and this one\'s rank '
            '(process_id or RANK).')
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        local = _env_int('LOCAL_RANK')
        torch.cuda.set_device(local if local is not None
                              else process_id % torch.cuda.device_count())
    kwargs = {} if timeout is None else {'timeout': timeout}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    logger.info(f'joined the process group ({backend}): process '
                f'{dist.get_rank()}/{dist.get_world_size()}')
    return host_info()


def host_info():
    """``host_id`` (this process's rank), ``num_hosts`` (the processes),
    ``local_device_count`` (the devices this process drives: one) and
    ``global_device_count`` (one a process)."""
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    return {
        'host_id': rank,
        'num_hosts': size,
        'local_device_count': 1,
        'global_device_count': size,
    }


def per_host_batch(global_batch_size: int) -> int:
    """Rows each process must feed a step for a given global batch."""
    n = host_info()['num_hosts']
    if global_batch_size % n != 0:
        raise ValueError(
            f'global batch {global_batch_size} must divide {n} hosts')
    return global_batch_size // n
