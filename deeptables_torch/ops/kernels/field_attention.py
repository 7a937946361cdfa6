# -*- coding:utf-8 -*-
"""Field attention (AutoInt's interacting layer) and the fused attention
block, with their gradients.

Port of ``deeptables_tpu/ops/kernels/field_attention.py``:

- :func:`fa_fwd` (K5-fwd, ``field_attention``): per example and head,
  ``o = softmax_g(q·kᵀ·scale)·v`` over the F fields, scores and softmax in
  float32, ``scale = 1/√dh``;
- :func:`fa_bwd` (K5-bwd, ``_fa_bwd``): dq, dk, dv with the softmax
  recomputed from q, k, v;
- :func:`ab_fwd` (K6-fwd, ``attention_block``): ``post = relu(w_augᵀ·[x;1])``
  split into q, k, v, r (float32, not rounded), then
  ``relu(attention(q, k, v) + r)``;
- :func:`ab_bwd` (K6-bwd, the kernel of ``_ab_bwd``): the masked gradient of
  the four projections' pre-activations, ``dpre = 1[pre>0]·[dq;dk;dv;dr]``
  with ``dr = dctx = 1[ctx+r>0]·do``, rounded to x's type.

Layouts are the projections' own: q, k, v, x and the outputs are
``(B, F, U)`` with ``U = H·dh``, head h in columns ``h·dh:(h+1)·dh`` (the
JAX package's batch-minor ``(H, F, dh, B)`` was a TPU layout); ``w_aug`` is
``(U+1, 4U)`` = ``[[Wq|Wk|Wv|Wr]; [bq|bk|bv|br]]``; dpre is ``(B, F, 4U)``.

The CUDA kernels are in ``deeptables_torch/csrc/field_attention.cu``; its
header says what bounds them, how the scores stay out of device memory and
how every shape runs (heads wider than 64 in slices, buffers past shared
memory in a scratch this module allocates). K5 and K6 each have two
designs, named by :func:`fa_design` and :func:`ab_design` from the shape
alone: ``'tile'`` (a block walks tiles of several examples, a thread a
(example, head, field) row; K6's projection on the tensor cores) wherever
the tile fits, and ``'warp'`` (one warp an example) past that. On a CUDA
tensor each
wrapper launches its kernel or raises; the ``*_reference`` functions run
for CPU tensors only and are the oracles the kernels are held against. The
autograd Functions are in ``ops/attention_grad.py``.
"""

import ctypes
import functools

import torch

from . import _build
from ...utils.profiling import spanned

_FA = {(torch.float32, torch.float32): 'f32_f32',
       (torch.bfloat16, torch.bfloat16): 'bf16_bf16',
       (torch.bfloat16, torch.float32): 'bf16_f32'}
_AB = {torch.float32: 'f32', torch.bfloat16: 'bf16'}
# csrc/field_attention.cu's kinds of launch, for dt_fa_scratch_floats
_KIND = {'fa_fwd': 0, 'fa_bwd': 1, 'ab_fwd': 2, 'ab_bwd': 3}

# the tile designs (csrc/field_attention.cu, "K6, the tile design" and
# "K5, the tile design")
_TILE_MAX_U = 64
_TILE_MAX_DH = 64  # K5's tile: the attention's register width
_TILE_TARGET_SMEM = 113 * 1024  # two blocks an SM
_TILE_MAX_SMEM = 232448  # 227 KB, a block's limit on Hopper


def scale_for(d_head: int) -> float:
    """``1/√dh``, the score scale of the JAX package."""
    return 1.0 / (d_head ** 0.5)


def split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, F, H·dh) → (B, H, F, dh) float32."""
    B, F, U = t.shape
    return t.float().reshape(B, F, num_heads, U // num_heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, F, dh) → (B, F, H·dh)."""
    B, H, F, dh = t.shape
    return t.transpose(1, 2).reshape(B, F, H * dh)


def attention_weights(q, k, scale):
    """(B, H, F, G) float32 weights, max-subtracted, ``e / Σe``."""
    return torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)


def fa_fwd_reference(q, k, v, num_heads: int, out_dtype=None):
    """Plain PyTorch K5 forward: float32 scores, softmax and context, one
    rounding to ``out_dtype`` (default q's type)."""
    qh, kh, vh = (split_heads(t, num_heads) for t in (q, k, v))
    w = attention_weights(qh, kh, scale_for(qh.shape[-1]))
    return merge_heads(torch.matmul(w, vh)).to(out_dtype or q.dtype)


def fa_bwd_reference(q, k, v, do, num_heads: int):
    """Plain PyTorch K5 backward, the TPU kernel's formulas in float32:
    ``dv = wᵀ·do``, ``ds = w·(dw − Σ_g w·dw)·scale`` with ``dw = do·vᵀ``,
    ``dq = ds·k``, ``dk = dsᵀ·q``; each rounded once to q's type."""
    qh, kh, vh, doh = (split_heads(t, num_heads) for t in (q, k, v, do))
    scale = scale_for(qh.shape[-1])
    w = attention_weights(qh, kh, scale)
    dw = torch.matmul(doh, vh.transpose(-1, -2))
    ds = w * (dw - (w * dw).sum(dim=-1, keepdim=True)) * scale
    grads = (torch.matmul(ds, kh), torch.matmul(ds.transpose(-1, -2), qh),
             torch.matmul(w.transpose(-1, -2), doh))
    return tuple(merge_heads(g).to(q.dtype) for g in grads)


def _block_post(x, w_aug):
    """(B, F, 4U) float32 ``relu(w_augᵀ·[x;1])`` with w_aug in x's type."""
    U = x.shape[-1]
    w = w_aug.to(x.dtype).float()
    return torch.relu(torch.matmul(x.float(), w[:U]) + w[U])


def ab_fwd_reference(x, w_aug, num_heads: int):
    """Plain PyTorch K6 forward: the projections in float32 from x and w_aug
    in x's type, attention, ``relu(ctx + r)``, one rounding to x's type."""
    U = x.shape[-1]
    post = _block_post(x, w_aug)
    q, k, v, r = (post[..., i * U:(i + 1) * U] for i in range(4))
    ctx = fa_fwd_reference(q, k, v, num_heads, torch.float32)
    return torch.relu(ctx + r).to(x.dtype)


def ab_bwd_reference(x, w_aug, do, num_heads: int):
    """Plain PyTorch K6 backward: dpre ``(B, F, 4U)`` in x's type, the
    projections and attention recomputed in float32 and masked as the TPU
    kernel masks (strict ``> 0``)."""
    U = x.shape[-1]
    post = _block_post(x, w_aug)
    q, k, v, r = (post[..., i * U:(i + 1) * U] for i in range(4))
    ctx = fa_fwd_reference(q, k, v, num_heads, torch.float32)
    zero = torch.zeros((), device=x.device)
    dctx = torch.where(ctx + r > 0, do.float(), zero)
    dq, dk, dv = fa_bwd_reference(q, k, v, dctx, num_heads)
    dpost = torch.cat([dq, dk, dv, dctx], dim=-1)
    return torch.where(post > 0, dpost, zero).to(x.dtype)


def ab_mask_margin(x, w_aug, num_heads: int) -> torch.Tensor:
    """Per example, the smallest ``|pre|`` of the block (float32, ``(B,)``):
    how far its relu masks are from 0. Where it is within rounding, the
    kernel and the plain version, which sum in another order, may take the
    two sides of ``pre > 0``, and that example's dpre differs by whole
    gradient values; comparisons leave such examples out. The other mask,
    ``ctx + r > 0``, needs no margin: ctx and r are sums of products of
    relu outputs and softmax weights, never negative, and are exactly 0 on
    both sides where every relu input of theirs is at most 0."""
    U = x.shape[-1]
    w = w_aug.to(x.dtype).float()
    pre = torch.matmul(x.float(), w[:U]) + w[U]
    return pre.abs().amin(dim=(1, 2))


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


def _tile_dhp(d_head: int) -> int:
    """A head's row in the tile, padded to the kernel's register width."""
    return 8 if d_head <= 8 else 16 if d_head <= 16 else \
        32 if d_head <= 32 else 64


def _tile_max_threads(d_head: int) -> int:
    return 512 if _tile_dhp(d_head) <= 16 else 256


def ab_tile_smem(kind: str, dtype, examples: int, F: int, H: int,
                 d_head: int) -> int:
    """Bytes of shared memory a block of K6's tile design takes for
    ``kind`` (``'ab_fwd'`` or ``'ab_bwd'``) at ``examples`` a tile, as
    ``tile_of`` in csrc/field_attention.cu lays it out: w_aug as the
    projection reads it and the post offset of each of its columns, two
    stages of the input span(s), q/k/v/r in float32 with each head's row
    padded, the backward's weights and ds (rows of an odd stride), and the
    staged output span."""
    bwd = kind == 'ab_bwd'
    itemsize = dtype.itemsize
    U, rows = H * d_head, examples * F
    n_pad = _up(4 * U, 8)
    # B fragments of the mma's k-steps (16 deep in bfloat16, 8 in TF32),
    # then the bias row
    w = -(-U // (16 if itemsize == 2 else 8)) * n_pad * 32 + n_pad * 4
    span_in = _up(rows * U * itemsize + 16, 16)
    post = 4 * H * rows * _tile_dhp(d_head) * 4
    wgt = H * rows * (F | 1) * 4 if bwd else 0
    out = _up(rows * (4 if bwd else 1) * U * itemsize + 16, 16)
    return (_up(_up(w + n_pad * 4, 16) + 2 * (2 if bwd else 1) * span_in
                + post + 2 * wgt, 16) + out)


def _fill_block(smem, F: int, H: int, d_head: int):
    """Examples a tile of ``smem(examples)`` bytes, or None where more
    (head, field) rows than a block's threads or one example's tile past
    shared memory: as many examples as fill the block's threads (a thread
    a row), no more than leave two blocks an SM (113 KB each), at least
    one."""
    most = _tile_max_threads(d_head)
    if H * F > most:
        return None
    examples = most // (H * F)
    while examples > 1 and smem(examples) > _TILE_TARGET_SMEM:
        examples -= 1
    return examples if smem(examples) <= _TILE_MAX_SMEM else None


@functools.lru_cache(maxsize=None)
def ab_tile_examples(kind: str, dtype, F: int, H: int, d_head: int):
    """Examples a tile of K6's tile design for ``kind``, or None where the
    design does not take the shape: U past 64, or as :func:`_fill_block`
    finds."""
    if H * d_head > _TILE_MAX_U:
        return None
    return _fill_block(functools.partial(ab_tile_smem, kind, dtype, F=F, H=H,
                                         d_head=d_head), F, H, d_head)


def fa_tile_smem(kind: str, dtype, out_dtype, examples: int, F: int,
                 H: int, d_head: int) -> int:
    """Bytes of shared memory a block of K5's tile design takes for
    ``kind`` (``'fa_fwd'`` or ``'fa_bwd'``) at ``examples`` a tile, q, k, v
    in ``dtype`` and the output (forward) or do (backward) in
    ``out_dtype``, as ``fa_tile_of`` in csrc/field_attention.cu lays it
    out: two stages of the input spans (q, k, v and, backward, do; the
    outputs are staged over q, k and v), q/k/v (and, backward, dctx) in
    float32 with each head's row padded, and rows of an odd stride for the
    scores (forward) or the weights and ds (backward)."""
    bwd = kind == 'fa_bwd'
    U, rows = H * d_head, examples * F
    span = _up(rows * U * dtype.itemsize + 16, 16)
    stage = 3 * span + (_up(rows * U * out_dtype.itemsize + 16, 16)
                        if bwd else 0)
    post = (4 if bwd else 3) * H * rows * _tile_dhp(d_head) * 4
    wgt = H * rows * (F | 1) * 4
    return 2 * stage + post + (2 if bwd else 1) * wgt


@functools.lru_cache(maxsize=None)
def fa_tile_examples(kind: str, dtype, out_dtype, F: int, H: int,
                     d_head: int):
    """Examples a tile of K5's tile design for ``kind``, or None where the
    design does not take the shape: a head past the kernel's register width
    (64), or as :func:`_fill_block` finds."""
    if d_head > _TILE_MAX_DH:
        return None
    return _fill_block(functools.partial(fa_tile_smem, kind, dtype, out_dtype,
                                         F=F, H=H, d_head=d_head),
                       F, H, d_head)


def fa_design(dtype, out_dtype, B: int, F: int, H: int, d_head: int) -> str:
    """Which K5 kernels a CUDA call runs, by shape alone (every B runs
    either), q, k, v in ``dtype`` and the output or do in ``out_dtype``:
    ``'tile'`` (csrc/field_attention.cu's tile design: a block walks tiles
    of several examples, their rows a thread each) where both the
    forward's and the backward's tiles fit (dh ≤ 64, H·F rows within a
    block, one example's buffers within shared memory), else ``'warp'``
    (one warp an example; its buffers in shared memory or, past it, in a
    device scratch)."""
    del B
    if (dtype, out_dtype) not in _FA:
        return 'warp'
    fits = all(fa_tile_examples(kind, dtype, out_dtype, F, H, d_head)
               is not None for kind in ('fa_fwd', 'fa_bwd'))
    return 'tile' if fits else 'warp'


def ab_design(dtype, B: int, F: int, H: int, d_head: int) -> str:
    """Which K6 kernels a CUDA call runs, by shape alone (every B runs
    either): ``'tile'`` (csrc/field_attention.cu's tile design: a block
    walks tiles of several examples, their rows a thread each, the
    projection on mma.sync) where both the forward's and the backward's
    tiles fit (U ≤ 64, H·F rows within a block, one example's buffers
    within shared memory), else ``'warp'`` (one warp an example; its
    buffers in shared memory or, past it, in a device scratch)."""
    del B
    if dtype not in _AB:
        return 'warp'
    fits = all(ab_tile_examples(kind, dtype, F, H, d_head) is not None
               for kind in ('ab_fwd', 'ab_bwd'))
    return 'tile' if fits else 'warp'


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library('field_attention')
    shape = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    tail = shape + [ctypes.c_float, ctypes.c_void_p]
    for suffix in _FA.values():
        fn = getattr(lib, f'dt_fa_fwd_{suffix}')
        fn.argtypes = [ctypes.c_void_p] * 4 + tail + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f'dt_fa_bwd_{suffix}')
        fn.argtypes = [ctypes.c_void_p] * 7 + tail + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for suffix in _AB.values():
        fn = getattr(lib, f'dt_ab_fwd_{suffix}')
        fn.argtypes = [ctypes.c_void_p] * 3 + tail + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        fn = getattr(lib, f'dt_ab_bwd_{suffix}')
        fn.argtypes = [ctypes.c_void_p] * 4 + tail + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    for suffix in _AB.values():
        for kind, n_ptrs in (('fwd', 3), ('bwd', 4)):
            fn = getattr(lib, f'dt_ab_tile_{kind}_{suffix}')
            fn.argtypes = [ctypes.c_void_p] * n_ptrs + shape + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    for suffix in _FA.values():
        for kind, n_ptrs in (('fwd', 4), ('bwd', 7)):
            fn = getattr(lib, f'dt_fa_tile_{kind}_{suffix}')
            fn.argtypes = [ctypes.c_void_p] * n_ptrs + shape + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.dt_ab_tile_smem.argtypes = [ctypes.c_int] * 6
    lib.dt_ab_tile_smem.restype = ctypes.c_int64
    lib.dt_fa_tile_smem.argtypes = [ctypes.c_int] * 7
    lib.dt_fa_tile_smem.restype = ctypes.c_int64
    lib.dt_fa_scratch_floats.argtypes = [ctypes.c_int] + shape
    lib.dt_fa_scratch_floats.restype = ctypes.c_int64
    lib.dt_ab_w_in_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dt_ab_w_in_smem.restype = ctypes.c_int
    lib.dt_fa_error_string.argtypes = [ctypes.c_int]
    lib.dt_fa_error_string.restype = ctypes.c_char_p
    return lib


def _count(fn, key):
    """One launch of ``fn``'s kernel, for the types ``key``."""
    fn.launches += 1
    fn.launches_by_type[key] = fn.launches_by_type.get(key, 0) + 1


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _d_head(what, t, num_heads):
    if t.dim() != 3:
        raise ValueError(f'{what} expects (B, F, U) tensors, got shape '
                         f'{tuple(t.shape)}')
    if num_heads < 1 or t.shape[-1] % num_heads:
        raise ValueError(f'{what}: U={t.shape[-1]} is not a multiple of '
                         f'num_heads={num_heads}')
    return t.shape[-1] // num_heads


def _check_like(what, ref, *tensors):
    for t in tensors:
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f'{what}: shapes differ: {tuple(t.shape)} and '
                             f'{tuple(ref.shape)}')


def _check_cuda(what, dtype, *tensors):
    for t in tensors:
        if t.device != tensors[0].device:
            raise ValueError(f'{what} runs on cuda or cpu tensors on one '
                             f'device, got {t.device} and {tensors[0].device}')
        if t.dtype != dtype:
            raise TypeError(f'{what} kernel takes {dtype} here, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{what} kernel needs contiguous operands')


def _launch(what, fn_name, ptrs, B, F, num_heads, d_head, device,
            w_aug=None):
    """Launch ``fn_name``. Where one warp's buffers do not fit in a
    block's shared memory the kernel keeps them in a float32 scratch that
    this allocates, and K6 (``w_aug`` given) reads a float32 copy of w_aug
    where that does not fit either."""
    lib = _library()
    floats = lib.dt_fa_scratch_floats(_KIND[what], B, F, num_heads, d_head)
    if floats < 0:
        raise ValueError(f'{what}: (B, F, H, dh) = '
                         f'{(B, F, num_heads, d_head)} is out of range')
    scratch = torch.empty(floats, dtype=torch.float32, device=device) \
        if floats else None
    extra = [None if scratch is None else scratch.data_ptr()]
    if w_aug is not None:
        w_f32 = None if lib.dt_ab_w_in_smem(num_heads, d_head) \
            else w_aug.float().contiguous()
        extra.append(None if w_f32 is None else w_f32.data_ptr())
    err = getattr(lib, fn_name)(*ptrs, B, F, num_heads, d_head,
                                scale_for(d_head), *extra,
                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed at (B, F, H, dh) = '
                           f'{(B, F, num_heads, d_head)}: CUDA error {err} '
                           f'({lib.dt_fa_error_string(err).decode()})')


def _launch_tile(what, ptrs, x, num_heads, d_head, out_dtype=None):
    """Launch K6's tile design for x's type, or K5's (``out_dtype`` given)
    for x's and the output's or do's type, E examples a tile."""
    lib = _library()
    B, F, _ = x.shape
    if out_dtype is None:
        examples = ab_tile_examples(what, x.dtype, F, num_heads, d_head)
        suffix = _AB[x.dtype]
    else:
        examples = fa_tile_examples(what, x.dtype, out_dtype, F, num_heads,
                                    d_head)
        suffix = _FA[x.dtype, out_dtype]
    fn = getattr(lib, f'dt_{what[:2]}_tile_{what[3:]}_{suffix}')
    err = fn(*ptrs, B, F, num_heads, d_head, scale_for(d_head), examples,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f'{what} tile kernel launch failed at (B, F, H, '
                           f'dh) = {(B, F, num_heads, d_head)}: CUDA error '
                           f'{err} ({lib.dt_fa_error_string(err).decode()})')


@spanned('deeptables.kernel.fa_fwd')
def fa_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           num_heads: int, out_dtype=None) -> torch.Tensor:
    """K5 forward on contiguous ``(B, F, H·dh)`` q, k, v of one type
    (float32 or bfloat16); the output ``(B, F, H·dh)`` in ``out_dtype``
    (default q's type; float32 is taken beside bfloat16 inputs).

    On a CUDA tensor this launches the kernel or raises; it never falls back
    to the plain version. ``fa_fwd.launches`` counts the launches, and
    ``fa_fwd.launches_by_type`` the same launches by type pair."""
    dh = _d_head('fa_fwd', q, num_heads)
    _check_like('fa_fwd', q, k, v)
    out_dtype = out_dtype or q.dtype
    if q.device.type == 'cpu':
        return fa_fwd_reference(q, k, v, num_heads, out_dtype)
    key = (q.dtype, out_dtype)
    if key not in _FA:
        raise TypeError(f'fa_fwd kernel takes float32 or bfloat16 inputs and '
                        f'their type or float32 out, got {key}')
    _check_cuda('fa_fwd', q.dtype, q, k, v)
    B, F, U = q.shape
    out = torch.empty((B, F, U), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        if fa_design(*key, B, F, num_heads, dh) == 'tile':
            _launch_tile('fa_fwd', _ptrs(q, k, v, out), q, num_heads, dh,
                         out_dtype)
        else:
            _launch('fa_fwd', f'dt_fa_fwd_{_FA[key]}', _ptrs(q, k, v, out),
                    B, F, num_heads, dh, q.device)
    _count(fa_fwd, _FA[key])
    return out


@spanned('deeptables.kernel.fa_bwd')
def fa_bwd(q, k, v, do, num_heads: int):
    """K5 backward: ``(dq, dk, dv)`` in q's type, given do ``(B, F, H·dh)``
    in the forward output's type (q's, or float32). The softmax is recomputed
    from q, k, v.

    On a CUDA tensor this launches the kernel or raises;
    ``fa_bwd.launches`` counts the launches (``launches_by_type`` by type
    pair)."""
    dh = _d_head('fa_bwd', q, num_heads)
    _check_like('fa_bwd', q, k, v, do)
    if q.device.type == 'cpu':
        return fa_bwd_reference(q, k, v, do, num_heads)
    key = (q.dtype, do.dtype)
    if key not in _FA:
        raise TypeError(f'fa_bwd kernel takes float32 or bfloat16 inputs and '
                        f'do in their type or float32, got {key}')
    _check_cuda('fa_bwd', q.dtype, q, k, v)
    _check_cuda('fa_bwd', do.dtype, do)
    if do.device != q.device:
        raise ValueError(f'fa_bwd: do is on {do.device}, q on {q.device}')
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.numel() == 0:
        return dq, dk, dv
    B, F, U = q.shape
    with torch.cuda.device(q.device):
        ptrs = _ptrs(q, k, v, do, dq, dk, dv)
        if fa_design(*key, B, F, num_heads, dh) == 'tile':
            _launch_tile('fa_bwd', ptrs, q, num_heads, dh, do.dtype)
        else:
            _launch('fa_bwd', f'dt_fa_bwd_{_FA[key]}', ptrs, B, F, num_heads,
                    dh, q.device)
    _count(fa_bwd, _FA[key])
    return dq, dk, dv


def _check_block(what, x, w_aug, num_heads):
    dh = _d_head(what, x, num_heads)
    U = x.shape[-1]
    if tuple(w_aug.shape) != (U + 1, 4 * U):
        raise ValueError(f'{what}: w_aug must be {(U + 1, 4 * U)}, got '
                         f'{tuple(w_aug.shape)}')
    return dh


@spanned('deeptables.kernel.ab_fwd')
def ab_fwd(x: torch.Tensor, w_aug: torch.Tensor,
           num_heads: int) -> torch.Tensor:
    """K6 forward on a contiguous ``(B, F, U)`` x and ``(U+1, 4U)`` w_aug,
    both in one type (float32 or bfloat16): the block's output
    ``(B, F, U)`` in that type.

    On a CUDA tensor this launches the kernel or raises;
    ``ab_fwd.launches`` counts the launches (``launches_by_type`` by
    type)."""
    dh = _check_block('ab_fwd', x, w_aug, num_heads)
    if x.device.type == 'cpu':
        return ab_fwd_reference(x, w_aug, num_heads)
    if x.dtype not in _AB:
        raise TypeError(f'ab_fwd kernel takes float32 or bfloat16, got '
                        f'{x.dtype}')
    _check_cuda('ab_fwd', x.dtype, x, w_aug)
    B, F, U = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        if ab_design(x.dtype, B, F, num_heads, dh) == 'tile':
            _launch_tile('ab_fwd', _ptrs(x, w_aug, out), x, num_heads, dh)
        else:
            _launch('ab_fwd', f'dt_ab_fwd_{_AB[x.dtype]}',
                    _ptrs(x, w_aug, out), B, F, num_heads, dh, x.device,
                    w_aug)
    _count(ab_fwd, _AB[x.dtype])
    return out


@spanned('deeptables.kernel.ab_bwd')
def ab_bwd(x: torch.Tensor, w_aug: torch.Tensor, do: torch.Tensor,
           num_heads: int) -> torch.Tensor:
    """K6 backward: dpre ``(B, F, 4U)`` in x's type, given x, w_aug and do
    contiguous in one type (float32 or bfloat16).

    On a CUDA tensor this launches the kernel or raises;
    ``ab_bwd.launches`` counts the launches (``launches_by_type`` by
    type)."""
    dh = _check_block('ab_bwd', x, w_aug, num_heads)
    _check_like('ab_bwd', x, do)
    if x.device.type == 'cpu':
        return ab_bwd_reference(x, w_aug, do, num_heads)
    if x.dtype not in _AB:
        raise TypeError(f'ab_bwd kernel takes float32 or bfloat16, got '
                        f'{x.dtype}')
    _check_cuda('ab_bwd', x.dtype, x, w_aug, do)
    B, F, U = x.shape
    dpre = torch.empty((B, F, 4 * U), dtype=x.dtype, device=x.device)
    if dpre.numel() == 0:
        return dpre
    with torch.cuda.device(x.device):
        if ab_design(x.dtype, B, F, num_heads, dh) == 'tile':
            _launch_tile('ab_bwd', _ptrs(x, w_aug, do, dpre), x, num_heads,
                         dh)
        else:
            _launch('ab_bwd', f'dt_ab_bwd_{_AB[x.dtype]}',
                    _ptrs(x, w_aug, do, dpre), B, F, num_heads, dh,
                    x.device, w_aug)
    _count(ab_bwd, _AB[x.dtype])
    return dpre


for _fn in (fa_fwd, fa_bwd, ab_fwd, ab_bwd):
    _fn.launches, _fn.launches_by_type = 0, {}
del _fn
