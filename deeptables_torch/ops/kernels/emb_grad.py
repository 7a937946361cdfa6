# -*- coding:utf-8 -*-
"""Embedding-table gradient of a fused multi-column lookup:
``dtable = 0; dtable[ids[n]] += g[n]`` over the flat ids of one width group.

Port of ``deeptables_tpu/ops/kernels/emb_grad.py::emb_grad_matmul``. The
CUDA kernel is ``deeptables_torch/csrc/emb_grad.cu``; its header says what
bounds it (memory) and how it sums: the wrapper sorts the ids stably, and
the kernel sums each row's segment of the sorted entries in batch order,
in pieces of at most :data:`CHUNK` entries added in order, without atomics,
so the same inputs give the same bits on every run (as the TPU kernel's
ordered grid does). :func:`emb_grad` launches it for a CUDA tensor and runs
:func:`emb_grad_reference` for a CPU tensor only.
:func:`emb_grad_sorted_reference` is the plain twin of the kernel's order
of summation. :func:`emb_grad_design` names the variant a call runs, by
shape and alignment.

The result is the dense float32 ``(V, D)`` gradient of the group's logical
table, which the optimizer updates whole (as the JAX package's dense optax
update does), not the TPU's lane-packed layout.
"""

import ctypes
import functools

import torch

from . import _build, pointer_alignment
from ...utils.profiling import spanned


def emb_grad_reference(ids: torch.Tensor, g: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """Plain PyTorch embedding gradient: ``zeros(V, D).index_add_``.

    The CPU path of :func:`emb_grad` and the kernel's oracle."""
    out = torch.zeros((num_rows, g.shape[-1]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, ids.reshape(-1).long(),
                          g.reshape(-1, g.shape[-1]).float())


# sorted entries a group of threads sums before it hands a cut segment's
# pieces to the merge (csrc/emb_grad.cu)
CHUNK = 32


def emb_grad_sorted_reference(ids: torch.Tensor, g: torch.Tensor,
                              num_rows: int,
                              chunk: int = CHUNK) -> torch.Tensor:
    """The plain twin of the kernel's order of summation, float32 add for
    float32 add: a stable sort of the ids; each run of equal ids inside a
    chunk of ``chunk`` sorted entries summed from 0 in batch order; each
    row's runs added in order. Ids outside ``[0, num_rows)`` are skipped.
    Same bits as the kernel on the same inputs, on any device."""
    ids = ids.reshape(-1).long()
    D = g.shape[-1]
    g = g.reshape(-1, D).float()
    out = torch.zeros((num_rows, D), dtype=torch.float32, device=g.device)
    N = ids.shape[0]
    if N == 0:
        return out
    sorted_ids, perm = torch.sort(ids, stable=True)
    rows_g = g[perm]
    pos = torch.arange(N, device=g.device)
    new_id = torch.ones(N, dtype=torch.bool, device=g.device)
    new_id[1:] = sorted_ids[1:] != sorted_ids[:-1]
    # runs: equal ids inside one chunk; each summed from 0, entry by entry
    run_start = new_id | (pos % chunk == 0)
    run_of = torch.cumsum(run_start.long(), 0) - 1
    starts = pos[run_start]
    step = pos - starts[run_of]
    run_sum = torch.zeros((len(starts), D), dtype=torch.float32,
                          device=g.device)
    for k in range(min(chunk, N)):
        at = step == k
        run_sum[run_of[at]] = run_sum[run_of[at]] + rows_g[at]
    # a row's runs (the pieces of its segment), added in order
    run_row = sorted_ids[starts]
    seg_of = torch.cumsum(new_id[starts].long(), 0) - 1
    seg_first = torch.nonzero(new_id[starts]).reshape(-1)
    piece = torch.arange(len(starts), device=g.device) - seg_first[seg_of]
    seg_sum = run_sum[seg_first].clone()
    for k in range(1, int(piece.max()) + 1):
        at = piece == k
        seg_sum[seg_of[at]] = seg_sum[seg_of[at]] + run_sum[at]
    seg_row = run_row[seg_first]
    valid = (seg_row >= 0) & (seg_row < num_rows)
    out[seg_row[valid]] = seg_sum[valid]
    return out


# the C entry point of each design
_ENTRY = {'segment_v4': 'dt_emb_grad_v4_f32',
          'segment_scalar': 'dt_emb_grad_f32'}


def emb_grad_design(N: int, D: int, V: int, ptr_alignment: int) -> str:
    """Which variant of the sorted segment sum a CUDA call with ``N`` rows
    of a contiguous float32 ``g`` of width ``D`` into a ``(V, D)`` table
    runs, by shape and the alignment in bytes of g's data pointer (every N
    and V runs either): ``'segment_v4'`` (csrc/emb_grad.cu with float4
    loads and stores, a thread a 16-byte piece of a row) where D % 4 == 0
    and g is 16-byte aligned, else ``'segment_scalar'`` (a float each).
    Both sum in the same order and give the same bits."""
    del N, V
    if D % 4 == 0 and ptr_alignment % 16 == 0:
        return 'segment_v4'
    return 'segment_scalar'


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library('emb_grad')
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.dt_emb_grad_error_string.argtypes = [ctypes.c_int]
    lib.dt_emb_grad_error_string.restype = ctypes.c_char_p
    return lib


@spanned('deeptables.kernel.emb_grad')
def emb_grad(ids: torch.Tensor, g: torch.Tensor,
             num_rows: int) -> torch.Tensor:
    """The float32 ``(num_rows, D)`` gradient of a table read at the flat
    ``ids`` (``N`` int32 row indices, offsets included), given the gathered
    rows' gradient ``g`` (``(N, D)`` float32).

    Every id must lie in ``[0, num_rows)``: the model checks them on the
    host. On a CUDA tensor this launches the kernel or raises; it never
    falls back to the plain version, and it gives the same bits on every
    run of the same inputs (those of :func:`emb_grad_sorted_reference`).
    ``emb_grad.launches`` counts the launches."""
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
    # index preparation: the ids in order, stably, and where each came from
    sorted_ids, perm = torch.sort(ids, stable=True)
    out = torch.empty((num_rows, D), dtype=torch.float32, device=g.device)
    partial = torch.empty((-(-N // CHUNK), 2, D), dtype=torch.float32,
                          device=g.device)
    lib = _library()
    entry = _ENTRY[emb_grad_design(N, D, num_rows, pointer_alignment(g))]
    with torch.cuda.device(g.device):
        err = getattr(lib, entry)(sorted_ids.data_ptr(), perm.data_ptr(),
                                  g.data_ptr(), out.data_ptr(),
                                  partial.data_ptr(), N, D, num_rows, CHUNK,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f'emb_grad kernel launch failed: CUDA error {err} '
            f'({lib.dt_emb_grad_error_string(err).decode()})')
    emb_grad.launches += 1
    return out


emb_grad.launches = 0
