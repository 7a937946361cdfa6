# -*- coding:utf-8 -*-
"""FM second-order pooling, ``(B, F, D) → (B, 1)``,
``out_b = 0.5 · Σ_d [(Σ_f x_bfd)² − Σ_f x_bfd²]``, and its gradient
``dx_bfd = g_b · (Σ_f' x_bf'd − x_bfd)``.

Port of ``deeptables_tpu/ops/kernels/fm.py::fm_pallas`` and the backward of
its custom VJP (``_fm_bwd``). The CUDA kernels are in
``deeptables_torch/csrc/fm.cu``; its header says what bounds them (memory)
and how the designs meet that. :func:`fm` and :func:`fm_backward` launch
them for a CUDA tensor and run :func:`fm_reference` and
:func:`fm_backward_reference` for a CPU tensor only. :func:`fm_design`
names the forward's design a call runs, by shape and alignment.
:class:`FMFunction` pairs the two as a ``torch.autograd.Function``;
:func:`fm` goes through it whenever its input needs a gradient.
"""

import ctypes
import functools

import torch

from . import _build, pointer_alignment
from ...utils.profiling import spanned

_FWD = {torch.float32: 'dt_fm_fwd_f32', torch.bfloat16: 'dt_fm_fwd_bf16'}
_FWD_VEC16 = {torch.float32: 'dt_fm_fwd_vec16_f32',
              torch.bfloat16: 'dt_fm_fwd_vec16_bf16'}
_BWD = {torch.float32: 'dt_fm_bwd_f32', torch.bfloat16: 'dt_fm_bwd_bf16'}


def fm_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FM pooling: float32 sums, one rounding to x's type.

    The CPU path of :func:`fm` and the oracle the kernel is held against."""
    xf = x.float()
    s = xf.sum(dim=1)
    q = (xf * xf).sum(dim=1)
    return (0.5 * (s * s - q).sum(dim=1, keepdim=True)).to(x.dtype)


def fm_backward_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FM gradient: float32 sums, one rounding to x's type.

    The CPU path of :func:`fm_backward` and the kernel's oracle."""
    xf = x.float()
    dx = g.float().reshape(-1, 1, 1) * (xf.sum(dim=1, keepdim=True) - xf)
    return dx.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library('fm')
    for name in (*_FWD.values(), *_FWD_VEC16.values()):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _BWD.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.dt_fm_error_string.argtypes = [ctypes.c_int]
    lib.dt_fm_error_string.restype = ctypes.c_char_p
    return lib


def fm_vec16_plan(dtype, F: int, D: int):
    """``(chunks, slices)`` of the forward's vec16 design at ``(F, D)`` in
    ``dtype``: a row of x is ``chunks`` 16-byte chunks (a power of two up
    to 32) and an example takes ``chunks * slices`` threads (slices the
    largest power of two within a warp and at most ``ceil(F / 3)``); None
    where the row is no such number of chunks. Mirrors csrc/fm.cu's
    ``vec16_chunks`` and ``vec16_slices``."""
    row = D * torch.empty((), dtype=dtype).element_size()
    chunks = row // 16
    if row % 16 or not 1 <= chunks <= 32 or chunks & (chunks - 1):
        return None
    want = (F + 2) // 3 if F > 3 else 1
    slices = 1
    while slices * 2 <= want and chunks * slices * 2 <= 32:
        slices *= 2
    return chunks, slices


def fm_design(dtype, B: int, F: int, D: int, ptr_alignment: int) -> str:
    """Which forward kernel a CUDA call on a contiguous ``(B, F, D)`` x in
    ``dtype`` runs, by shape and the alignment in bytes of x's data
    pointer (every B runs either): ``'vec16'`` (csrc/fm.cu's 16-byte
    loads, several threads an example) where a row of x is a power of two
    of 16-byte chunks, at most 32, and x is 16-byte aligned, else
    ``'scalar'`` (one thread a d)."""
    del B
    if (dtype in _FWD and fm_vec16_plan(dtype, F, D) is not None
            and ptr_alignment % 16 == 0):
        return 'vec16'
    return 'scalar'


def _check_cuda(x: torch.Tensor, what: str):
    if x.device.type != 'cuda':
        raise ValueError(f'{what} runs on cuda or cpu tensors, got {x.device}')
    if x.dtype not in _FWD:
        raise TypeError(f'{what} kernel takes float32 or bfloat16, got '
                        f'{x.dtype}')
    if not x.is_contiguous():
        raise ValueError(f'{what} kernel needs a contiguous (B, F, D) tensor')


def _raise_on(err: int, lib, what: str):
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err} '
                           f'({lib.dt_fm_error_string(err).decode()})')


@spanned('deeptables.kernel.fm')
def _fm_forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == 'cpu':
        return fm_reference(x)
    _check_cuda(x, 'fm')
    B, F, D = x.shape
    out = torch.empty((B, 1), dtype=x.dtype, device=x.device)
    if B == 0:
        return out
    lib = _library()
    design = fm_design(x.dtype, B, F, D, pointer_alignment(x))
    entry = _FWD_VEC16 if design == 'vec16' else _FWD
    with torch.cuda.device(x.device):
        err = getattr(lib, entry[x.dtype])(
            x.data_ptr(), out.data_ptr(), B, F, D,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, lib, 'fm')
    fm.launches += 1
    return out


@spanned('deeptables.kernel.fm_backward')
def fm_backward(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient of FM pooling with respect to a contiguous ``(B, F, D)``
    float32 or bfloat16 ``x``, given the output's gradient ``g`` (``B`` values
    in x's type). On a CUDA tensor this launches the kernel or raises;
    ``fm_backward.launches`` counts the launches."""
    if x.dim() != 3:
        raise ValueError(f'fm_backward expects a (B, F, D) tensor, got shape '
                         f'{tuple(x.shape)}')
    if g.numel() != x.shape[0]:
        raise ValueError(f'fm_backward expects one gradient per example, got '
                         f'{tuple(g.shape)} for B={x.shape[0]}')
    if x.device.type == 'cpu':
        return fm_backward_reference(x, g)
    _check_cuda(x, 'fm_backward')
    if g.device != x.device or g.dtype != x.dtype or not g.is_contiguous():
        raise TypeError(f'fm_backward kernel takes g contiguous on {x.device} '
                        f'in {x.dtype}, got {g.dtype} on {g.device}')
    B, F, D = x.shape
    dx = torch.empty_like(x)
    if B == 0:
        return dx
    lib = _library()
    with torch.cuda.device(x.device):
        err = getattr(lib, _BWD[x.dtype])(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), B, F, D,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, lib, 'fm_backward')
    fm_backward.launches += 1
    return dx


class FMFunction(torch.autograd.Function):
    """FM pooling with its backward kernel. Saves x, not Σ_f x, as the JAX
    VJP does."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _fm_forward(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return fm_backward(x, g.to(x.dtype).contiguous())


def fm(x: torch.Tensor) -> torch.Tensor:
    """FM pooling of a contiguous ``(B, F, D)`` float32 or bfloat16 tensor.

    On a CUDA tensor this launches the kernel or raises; it never falls
    back to the plain version. ``fm.launches`` counts the launches. When
    ``x`` needs a gradient, the call goes through :class:`FMFunction`, whose
    backward is :func:`fm_backward`."""
    if x.dim() != 3:
        raise ValueError(f'fm expects a (B, F, D) tensor, got shape '
                         f'{tuple(x.shape)}')
    if x.requires_grad and torch.is_grad_enabled():
        return FMFunction.apply(x)
    return _fm_forward(x)


fm.launches = 0
fm_backward.launches = 0
