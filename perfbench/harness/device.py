"""The card: synchronising, memory, and the port's launch counters."""

import gc
import importlib
import pkgutil

import torch


def is_cuda(device) -> bool:
    return torch.device(device).type == 'cuda'


def synchronize(device):
    if is_cuda(device):
        torch.cuda.synchronize(device)


def reset_peak(device):
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if is_cuda(device) else 0


def free(device):
    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()


def launch_counters() -> dict:
    """Every ``launches`` counter of the port's kernel wrappers
    (``deeptables_torch.ops.kernels``), by the wrapper's name: each module
    of the package is read, and each function it defines that carries an
    int ``launches``. Two wrappers of one name are refused, since the
    kernels' bounds and calls know a wrapper by its name alone."""
    from deeptables_torch.ops import kernels
    counters = {}
    for info in pkgutil.iter_modules(kernels.__path__):
        module = importlib.import_module(f'{kernels.__name__}.{info.name}')
        for name, obj in vars(module).items():
            launches = getattr(obj, 'launches', None)
            if isinstance(launches, int) and \
                    getattr(obj, '__module__', None) == module.__name__:
                if name in counters:
                    raise ValueError(f'two kernel wrappers named {name!r}: '
                                     f'{module.__name__} and another')
                counters[name] = launches
    return counters


def counter_deltas(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}
