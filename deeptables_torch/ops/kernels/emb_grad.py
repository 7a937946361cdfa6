# -*- coding:utf-8 -*-
"""Embedding-table gradient of a fused multi-column lookup:
``dtable = 0; dtable[ids[n]] += g[n]`` over the flat ids of one width group.

Port of ``deeptables_tpu/ops/kernels/emb_grad.py::emb_grad_matmul``. The
CUDA kernel is ``deeptables_torch/csrc/emb_grad.cu``; its header says what
bounds it (memory, and L2's rate of float32 reductions) and why it adds with
atomics. :func:`emb_grad` launches it for a CUDA tensor and runs
:func:`emb_grad_reference` for a CPU tensor only. :func:`emb_grad_design`
names the design a call runs, by shape and alignment.

The result is the dense float32 ``(V, D)`` gradient of the group's logical
table, which the optimizer updates whole (as the JAX package's dense optax
update does), not the TPU's lane-packed layout.
"""

import ctypes
import functools

import torch

from . import _build, pointer_alignment


def emb_grad_reference(ids: torch.Tensor, g: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Plain PyTorch embedding gradient: ``zeros(V, D).index_add_``.

    The CPU path of :func:`emb_grad` and the kernel's oracle."""
    out = torch.zeros((num_rows, g.shape[-1]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, ids.reshape(-1).long(),
                          g.reshape(-1, g.shape[-1]).float())


# the C entry point of each design
_ENTRY = {'v4': 'dt_emb_grad_v4_f32', 'scalar': 'dt_emb_grad_f32'}


def emb_grad_design(N: int, D: int, V: int, ptr_alignment: int) -> str:
    """Which scatter a CUDA call with ``N`` rows of a contiguous float32
    ``g`` of width ``D`` into a ``(V, D)`` table runs, by shape and the
    alignment in bytes of g's data pointer (every N and V runs either):
    ``'v4'`` (csrc/emb_grad.cu's 16-byte reductions, a thread a 16-byte
    piece of a row of g) where D % 4 == 0 and g is 16-byte aligned, else
    ``'scalar'`` (a 4-byte reduction an element)."""
    del N, V
    return 'v4' if D % 4 == 0 and ptr_alignment % 16 == 0 else 'scalar'


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library('emb_grad')
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.dt_emb_grad_error_string.argtypes = [ctypes.c_int]
    lib.dt_emb_grad_error_string.restype = ctypes.c_char_p
    return lib


def emb_grad(ids: torch.Tensor, g: torch.Tensor,
             num_rows: int) -> torch.Tensor:
    """The float32 ``(num_rows, D)`` gradient of a table read at the flat
    ``ids`` (``N`` int32 row indices, offsets included), given the gathered
    rows' gradient ``g`` (``(N, D)`` float32).

    Every id must lie in ``[0, num_rows)``: the model checks them on the
    host. On a CUDA tensor this launches the kernel or raises; it never
    falls back to the plain version. ``emb_grad.launches`` counts the
    launches."""
    if g.dim() != 2 or ids.dim() != 1 or ids.shape[0] != g.shape[0]:
        raise ValueError(f'emb_grad expects ids (N,) and g (N, D), got '
                         f'{tuple(ids.shape)} and {tuple(g.shape)}')
    if num_rows < 1:
        raise ValueError(f'emb_grad needs a table of at least one row, got '
                         f'{num_rows}')
    if g.device.type == 'cpu' and ids.device.type == 'cpu':
        return emb_grad_reference(ids, g, num_rows)
    if g.device.type != 'cuda' or ids.device != g.device:
        raise ValueError(f'emb_grad runs on cuda or cpu tensors on one '
                         f'device, got ids on {ids.device}, g on {g.device}')
    if ids.dtype != torch.int32 or g.dtype != torch.float32:
        raise TypeError(f'emb_grad kernel takes int32 ids and float32 g, got '
                        f'{ids.dtype} and {g.dtype}')
    if not (ids.is_contiguous() and g.is_contiguous()):
        raise ValueError('emb_grad kernel needs contiguous ids and g')
    N, D = g.shape
    out = torch.empty((num_rows, D), dtype=torch.float32, device=g.device)
    lib = _library()
    entry = _ENTRY[emb_grad_design(N, D, num_rows, pointer_alignment(g))]
    with torch.cuda.device(g.device):
        err = getattr(lib, entry)(ids.data_ptr(), g.data_ptr(),
                                  out.data_ptr(), N, D, num_rows,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f'emb_grad kernel launch failed: CUDA error {err} '
            f'({lib.dt_emb_grad_error_string(err).decode()})')
    emb_grad.launches += 1
    return out


emb_grad.launches = 0
