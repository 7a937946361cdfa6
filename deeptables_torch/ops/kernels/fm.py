# -*- coding:utf-8 -*-
"""FM second-order pooling, forward: ``(B, F, D) → (B, 1)``,
``out_b = 0.5 · Σ_d [(Σ_f x_bfd)² − Σ_f x_bfd²]``.

Port of ``deeptables_tpu/ops/kernels/fm.py::fm_pallas`` (forward). The CUDA
kernel is ``deeptables_torch/csrc/fm.cu``; its header says what bounds it
(memory: one read of x) and how the design meets that. :func:`fm` launches
it for a CUDA tensor and runs :func:`fm_reference` for a CPU tensor only.

Inference only: the backward kernel (``_fm_bwd``, ``dx = g·(Σ_f x − x)``)
comes with training.
"""

import ctypes
import functools

import torch

from . import _build

_ENTRY_POINTS = {
    torch.float32: 'dt_fm_fwd_f32',
    torch.bfloat16: 'dt_fm_fwd_bf16',
}


def fm_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FM pooling: float32 sums, one rounding to x's type.

    The CPU path of :func:`fm` and the oracle the kernel is held against."""
    xf = x.float()
    s = xf.sum(dim=1)
    q = (xf * xf).sum(dim=1)
    return (0.5 * (s * s - q).sum(dim=1, keepdim=True)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library('fm')
    for name in _ENTRY_POINTS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.dt_fm_error_string.argtypes = [ctypes.c_int]
    lib.dt_fm_error_string.restype = ctypes.c_char_p
    return lib


def fm(x: torch.Tensor) -> torch.Tensor:
    """FM pooling of a contiguous ``(B, F, D)`` float32 or bfloat16 tensor.

    On a CUDA tensor this launches the kernel or raises; it never falls
    back to the plain version. ``fm.launches`` counts the launches."""
    if x.dim() != 3:
        raise ValueError(f'fm expects a (B, F, D) tensor, got shape '
                         f'{tuple(x.shape)}')
    if x.device.type == 'cpu':
        return fm_reference(x)
    if x.device.type != 'cuda':
        raise ValueError(f'fm runs on cuda or cpu tensors, got {x.device}')
    if x.dtype not in _ENTRY_POINTS:
        raise TypeError(f'fm kernel takes float32 or bfloat16, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError('fm kernel needs a contiguous (B, F, D) tensor')
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError('FM backward kernel: training slice')
    B, F, D = x.shape
    out = torch.empty((B, 1), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        err = getattr(lib, _ENTRY_POINTS[x.dtype])(
            x.data_ptr(), out.data_ptr(), B, F, D,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'fm kernel launch failed: CUDA error {err} '
                           f'({lib.dt_fm_error_string(err).decode()})')
    fm.launches += 1
    return out


fm.launches = 0
