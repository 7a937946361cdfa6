# -*- coding:utf-8 -*-
"""Device selection and the GPU's memory knobs: the port's counterpart of
``deeptables_tpu/utils/device.py`` (itself the analog of upstream's
``utils/gpu.py``: ``set_memory_growth`` at 6, ``set_memory_limit`` at 20).

PyTorch's caching allocator takes device memory as tensors need it and
never preallocates it, so ``set_memory_growth`` has nothing to turn on;
``set_memory_limit`` caps this process's share of the card through the
allocator. Eager PyTorch compiles nothing, so there is no compilation cache
to enable either.
"""

import torch

from . import dt_logging

logger = dt_logging.get_logger(__name__)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device; without a CUDA device that is an
    error, never a silent move to the CPU. Pass ``'cpu'`` to run the plain
    PyTorch path (the tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'No CUDA device is available. deeptables_torch runs on a CUDA '
                "GPU by default; pass device='cpu' to run its plain PyTorch "
                'path on the CPU.')
        return torch.device('cuda', torch.cuda.current_device())
    device = torch.device(device)
    if device.type not in ('cuda', 'cpu'):
        raise ValueError(f'Unsupported device {device}: use cuda or cpu.')
    return device


def set_memory_growth():
    """Accepted for the config's ``gpu_usage_strategy``: PyTorch's allocator
    already grows on demand and never preallocates the card's memory."""
    logger.debug('set_memory_growth: the CUDA caching allocator already '
                 'allocates on demand')


def set_memory_limit(fraction: float, device=None):
    """Cap the fraction of the card's memory this process may allocate
    (``torch.cuda.set_per_process_memory_fraction``); an allocation past it
    raises an out-of-memory error."""
    if not 0 < fraction <= 1:
        raise ValueError(f'memory fraction must lie in (0, 1]: {fraction}')
    device = resolve_device(device)
    if device.type != 'cuda':
        raise ValueError(f'set_memory_limit needs a CUDA device, not {device}')
    torch.cuda.set_per_process_memory_fraction(fraction, device)


def device_info():
    """Inventory of the visible devices: platform, kind, count, and for a
    CUDA card its memory, SM count and compute capability."""
    distributed = torch.distributed.is_available() \
        and torch.distributed.is_initialized()
    info = {
        'platform': 'gpu' if torch.cuda.is_available() else 'cpu',
        'device_kind': None, 'num_devices': 0, 'num_local_devices': 0,
        'process_index': torch.distributed.get_rank() if distributed else 0,
        'num_processes':
            torch.distributed.get_world_size() if distributed else 1,
    }
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        info.update(device_kind=props.name,
                    num_devices=torch.cuda.device_count(),
                    num_local_devices=torch.cuda.device_count(),
                    total_memory_bytes=props.total_memory,
                    multi_processor_count=props.multi_processor_count,
                    compute_capability=f'{props.major}.{props.minor}')
    return info


def memory_stats(device=None):
    """The CUDA caching allocator's statistics for ``device`` (default: the
    current one; ``torch.cuda.memory_stats``: ``allocated_bytes.all.peak``
    and the rest), or None without a CUDA device."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats(device)


def enable_compilation_cache(path=None):
    """The JAX package enables jax's persistent compilation cache here. The
    port runs eagerly and builds its CUDA kernels once into
    ``build/deeptables_torch/<hash>/`` (``ops/kernels/_build.py``), so
    there is nothing to enable: it logs that and returns None."""
    logger.info('enable_compilation_cache: eager PyTorch has no compilation '
                'cache; the CUDA kernels are built once into '
                'build/deeptables_torch/')
    return None
