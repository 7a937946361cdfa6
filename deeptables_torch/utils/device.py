# -*- coding:utf-8 -*-
"""Device selection for the port's entry points."""

import torch


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
