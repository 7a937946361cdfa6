# -*- coding:utf-8 -*-
"""The CIN field-pair contraction and its gradient.

``z[b,l,d] = Σ_{f,g} w[l,f,g]·x0[b,f,d]·h[b,g,d]`` with x0 ``(B, F, D)``,
h ``(B, G, D)``, w ``(L, F, G)`` and z ``(B, L, D)`` float32; the gradient
takes dz ``(B, L, D)`` and gives dx0, dh and the float32 dW.

Port of ``deeptables_tpu/ops/kernels/cin_bwd.py``: :func:`cin_fwd` of
``cin_fwd_pallas`` (K4, ``_fwd_kernel``) and :func:`cin_bwd` of
``cin_bwd_pallas`` (K3, ``_bwd_kernel`` and ``_bwd_kernel_chunked``). The
CUDA kernels are in ``deeptables_torch/csrc/cin.cu``; its header says what
bounds them (operations: K3 takes 112.8 GFLOP at xDeepFM's second layer,
B = 8192, a floor of 0.114 ms on the bfloat16 tensor cores), how the pair
stays out of device memory and how both types run on the tensor cores:
:func:`fwd_design` and :func:`bwd_design` name the kernels a call runs,
``'wgmma'`` for bfloat16 (the pair split exactly into two bfloat16 halves),
``'wgmma_f32'`` for float32 (every float32 operand split exactly into three
bfloat16 planes by :func:`split_bf16x3`, six plane products: float32
products, not TF32), ``'wgmma_f32_rs'`` for a float32 K3 whose dz planes do
not fit a block (dz split in registers instead) and ``'simt'``, the CUDA
cores, for shapes past the tensor-core kernels' shared memory. The
tensor-core designs sum in wgmma's float32 accumulator, which rounds
unlike IEEE float32 summation (see :func:`cin_fwd`). On a CUDA tensor each
wrapper launches its kernels or raises; :func:`cin_fwd_reference` and
:func:`cin_bwd_reference` run for CPU tensors only. The JAX package's
batch-minor ``(F, D·B)`` operands are ``(1, F, D·B)`` tensors here.

The autograd Functions and the rounding points of the JAX custom VJPs are
in ``ops/cin_grad.py``.
"""

import ctypes
import functools
import math

import torch

from . import _build
from ...utils.profiling import spanned

_FWD = {torch.float32: 'dt_cin_fwd_f32', torch.bfloat16: 'dt_cin_fwd_bf16'}
_BWD = {torch.float32: 'dt_cin_bwd_f32', torch.bfloat16: 'dt_cin_bwd_bf16'}
# the tensor-core K3 of each design
_BWD_WGMMA = {'wgmma': 'dt_cin_bwd_bf16_wgmma',
              'wgmma_f32': 'dt_cin_bwd_f32_wgmma',
              'wgmma_f32_rs': 'dt_cin_bwd_f32_rs_wgmma'}

# csrc/cin.cu's tiling, which sizes the scratch buffers of the backward
_DW_TILE = 128
_SM_COUNT = 132  # H100 SXM
_MIN_COLS_PER_SPLIT = 512
# ... and the bfloat16 forward on the tensor cores (cin.cu's
# wg::smem_bytes<__nv_bfloat16>):
# W's k padded to whole 64-wide TMA chunks; the x0 and h tiles ((F + G) rows
# of 136 bfloat16) beside a 67,584-byte ring and staging area, 8 barriers
# and 1 KB of alignment slack must fit a block's 232,448 bytes
_K_CHUNK = 64
_TILE_LD = 136
_WGMMA_REGION_BYTES = 67584
_MAX_SMEM_BYTES = 232448
# ... and the bfloat16 backward on the tensor cores (cin.cu's
# wg::dx_smem_bytes and wg::dw_smem_bytes of __nv_bfloat16). dx0/dh pass:
# 128 columns of dz (L padded to 64) beside a 4-stage ring of W tiles (64 l
# x the G tile) and the x0 tile. dW pass: two buffers, each a 16 KB dz
# chunk and the x0 and h rows of 64 columns (72 bfloat16 a row) with one
# zero row.
_L_CHUNK = 64
_DX_COLS = 128
_DX_STAGES = 4
_DW_ROWS = 128
_DW_COLS = 64
_DW_LD = 72
# ... and the float32 kernels on the tensor cores (cin.cu's wg::smem_bytes,
# dx_smem_bytes and dw_buffer_bytes of float), one block an SM. K4: two
# stages of the three W planes (98,304 bytes) beside float32 x0 and h
# tiles of 132 floats a row, W's planes with L padded to whole 128-row
# tiles. dx0/dh pass: dz in three planes beside a ring of 4, 3 or 2 stages
# of one f's tile of the three W planes. dW pass: two buffers,
# each the three 16 KB dz planes and float32 x0/h rows of 72 floats.
_F32_RING_BYTES = 98304
_TILE_LD_F32 = 132
_L_TILE = 128
_DW_LD_F32 = 72
_DW_DZ_BYTES = 16384
# ... and the float32 dx0/dh pass that keeps dz once in float32 (cin.cu's
# wg::dx_rs_smem_bytes): a ring of 4, 3 or 2 stages of one f's tile of the
# three W planes beside 128 float32 dz columns, L padded to 16 and 8 floats
# more a row
_L_STEP = 16
_DZ_SKEW = 8
# ... whose dW ranges hold at most this many columns (see wgmma_bwd_plan)
_RS_MAX_COLS = 2048
_BF16_MAX = float(torch.finfo(torch.bfloat16).max)


def cin_fwd_reference(x0: torch.Tensor, h: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch contraction: the (B, F·G, D) pair materialised in
    float32, contracted with ``torch.matmul``; float32 out.

    The CPU path of :func:`cin_fwd` and the oracle the kernel is held
    against."""
    B, F, D = x0.shape
    G = h.shape[1]
    L = w.shape[0]
    pair = (x0.float()[:, :, None, :] * h.float()[:, None, :, :]
            ).reshape(B, F * G, D)
    return torch.matmul(w.float().reshape(L, F * G), pair)


def cin_bwd_reference(x0: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                      dz: torch.Tensor):
    """Plain PyTorch gradient of the contraction, ``cin_bwd_oracle``'s math:
    float32 products and sums, one rounding of dx0 and dh to x0's and h's
    types; dW float32.

    The CPU path of :func:`cin_bwd` and the kernel's oracle."""
    B, F, D = x0.shape
    G = h.shape[1]
    L = w.shape[0]
    x0f, hf, dzf = x0.float(), h.float(), dz.float()
    dpair = torch.matmul(w.float().reshape(L, F * G).t(), dzf
                         ).reshape(B, F, G, D)
    dx0 = (dpair * hf[:, None, :, :]).sum(dim=2)
    dh = (dpair * x0f[:, :, None, :]).sum(dim=1)
    pair = (x0f[:, :, None, :] * hf[:, None, :, :]).reshape(B, F * G, D)
    dw = torch.einsum('bld,bkd->lk', dzf, pair).reshape(L, F, G)
    return dx0.to(x0.dtype), dh.to(h.dtype), dw


def bwd_plan(N: int, F: int, G: int, L: int):
    """``(splits, g_tiles)`` of the CUDA-core backward (:func:`bwd_design`
    ``'simt'``) for N = B·D columns: the dW
    reduction over N is cut into ``splits`` column ranges (enough blocks for
    four waves over the card's SMs, none under 512 columns), and dx0 sums
    over ``g_tiles`` tiles of G (one for G ≤ 64), as ``csrc/cin.cu`` tiles
    them."""
    tiles = math.ceil(F * G / _DW_TILE) * math.ceil(L / _DW_TILE)
    splits = max(1, min(math.ceil(4 * _SM_COUNT / tiles),
                        math.ceil(N / _MIN_COLS_PER_SPLIT), 65535))
    return splits, math.ceil(G / bwd_g_tile(G))


def fwd_design(dtype: torch.dtype, F: int, G: int) -> str:
    """Which K4 kernel a CUDA call runs, by type and shape: ``'wgmma'``
    (bfloat16 on the tensor cores, the pair split exactly into two bfloat16
    halves; F + G ≤ 602), ``'wgmma_f32'`` (float32 on the tensor cores, the
    pair and W split exactly into three bfloat16 planes; F + G ≤ 252) or
    ``'simt'`` (the CUDA cores: tiles past a block's shared memory)."""
    if dtype == torch.bfloat16:
        tile = ((F + G) * _TILE_LD * 2 + 7) // 8 * 8
        fits = 1024 + _WGMMA_REGION_BYTES + tile + 64 <= _MAX_SMEM_BYTES
        return 'wgmma' if fits else 'simt'
    tile = (F + G) * _TILE_LD_F32 * 4
    fits = 1024 + _F32_RING_BYTES + tile + 32 <= _MAX_SMEM_BYTES
    return 'wgmma_f32' if fits else 'simt'


def split_bf16x3(v: torch.Tensor) -> torch.Tensor:
    """The exact three-plane split of a float32 tensor: ``(3, *v.shape)``
    bfloat16 planes, each rounded to nearest from what the planes before it
    leave (an exact float32 residual), so that ``p[0] + p[1] + p[2] == v``
    for every float32 whose low planes stay in bfloat16's normal range
    (``|v| ≥ 2⁻¹¹⁰``). The first plane is rounded from v clamped to
    bfloat16's largest finite value, so it never rounds to infinity. The
    float32 kernels split their operands so (``csrc/cin.cu``'s ``split``);
    the wrapper splits W with it."""
    v = v.float()
    p0 = v.clamp(-_BF16_MAX, _BF16_MAX).bfloat16()
    r = v - p0.float()
    p1 = r.bfloat16()
    return torch.stack((p0, p1, (r - p1.float()).bfloat16()))


def padded_w(w: torch.Tensor) -> torch.Tensor:
    """w ``(L, F, G)`` as the tensor-core K4 reads it: bfloat16 w as
    ``(L, K_pad)``, K = F·G padded with zeros to a multiple of 64 (TMA
    takes row strides in multiples of 16 bytes; the chunks are 64 wide);
    float32 w as its three planes (:func:`split_bf16x3`), ``(3, L_pad,
    K_pad)`` bfloat16 with L padded with zero rows to a multiple of 128, so
    that each 128-row tile of a plane is one TMA box."""
    L, F, G = w.shape
    K = F * G
    k_pad = -(-K // _K_CHUNK) * _K_CHUNK
    if w.dtype == torch.float32:
        l_pad = -(-L // _L_TILE) * _L_TILE
        out = torch.zeros((3, l_pad, k_pad), dtype=torch.bfloat16,
                          device=w.device)
        out[:, :L, :K] = split_bf16x3(w.reshape(L, K))
        return out
    out = w.new_zeros((L, k_pad))
    out[:, :K] = w.reshape(L, K)
    return out


def bwd_g_tile(G: int) -> int:
    """The G tile of the tensor-core K3's dx0/dh pass: its wgmma width,
    n32 for G ≤ 32, else n64 (more tiles past 64, their dx0 partials summed
    in a fixed order)."""
    return 32 if G <= 32 else 64


def dx_rs_smem_bytes(G: int, L: int, stages: int) -> int:
    """Shared memory of the float32 dx0/dh pass that keeps dz once in
    float32 (:func:`bwd_design` ``'wgmma_f32_rs'``), as ``csrc/cin.cu``'s
    ``wg::dx_rs_smem_bytes`` reckons it: 1 KB of alignment slack, a ring of
    ``stages`` stages of one f's 64 l × G tile of the three bfloat16 W
    planes, the 128 columns of dz in float32 with L padded to 16 and 8
    floats more a row (the rows 8 banks apart), 16 bytes of barrier and
    counter a stage. A block takes at most 232,448 bytes: with the fewest
    stages, 2, L ≤ 336 fits at a G tile of 64 and L ≤ 384 at 32."""
    ld = -(-L // _L_STEP) * _L_STEP + _DZ_SKEW
    return (1024 + stages * 3 * bwd_g_tile(G) * _L_CHUNK * 2
            + _DX_COLS * ld * 4 + 2 * stages * 8)


def bwd_design(dtype: torch.dtype, F: int, G: int, L: int) -> str:
    """Which K3 kernels a CUDA call runs, by type and shape: ``'wgmma'``
    (bfloat16 on the tensor cores: dpair = Wᵀ·dz as a bfloat16 GEMM folded
    into dx0 and dh in registers, and dW with the pair split exactly into
    two bfloat16 halves), ``'wgmma_f32'`` (float32 the same way, every
    operand split exactly into three bfloat16 planes, dz's stored in shared
    memory), ``'wgmma_f32_rs'`` (float32 where those dz planes do not fit a
    block: dz kept once in float32 and split in registers at every l step,
    :func:`dx_rs_smem_bytes`; the same dW pass, the same six plane products)
    or ``'simt'`` (the CUDA cores: shapes whose tiles do not fit a block's
    shared memory; the dz tile grows with L, the dW pass's h rows with G).
    So float32 takes the tensor cores for L ≤ 336 (L ≤ 384 for G ≤ 32) and
    G ≤ 228 at F = 3."""
    l_pad = -(-L // _L_CHUNK) * _L_CHUNK
    x_rows = min(F, 127 // G + 2)
    if dtype == torch.bfloat16:
        dx = (1024 + _DX_COLS * l_pad * 2
              + _DX_STAGES * bwd_g_tile(G) * _L_CHUNK * 2
              + (F * _TILE_LD * 2 + 7) // 8 * 8 + 2 * _DX_STAGES * 8)
        buffer = -(-(_DW_ROWS * _DW_COLS * 2 + (x_rows + 1 + G) * _DW_LD * 2)
                   // 1024) * 1024
        fits = max(dx, 1024 + 2 * buffer) <= _MAX_SMEM_BYTES
        return 'wgmma' if fits else 'simt'
    buffer = -(-(3 * _DW_DZ_BYTES + (x_rows + 1 + G) * _DW_LD_F32 * 4)
               // 1024) * 1024
    if 1024 + 2 * buffer > _MAX_SMEM_BYTES:
        return 'simt'
    # the dz planes and the dx0/dh ring at its fewest stages, 2 (it takes
    # 4, 3 or 2, the most that fit)
    dx = (1024 + 3 * _DX_COLS * l_pad * 2
          + 2 * (3 * bwd_g_tile(G) * _L_CHUNK * 2 + 2 * 8))
    if dx <= _MAX_SMEM_BYTES:
        return 'wgmma_f32'
    if dx_rs_smem_bytes(G, L, 2) <= _MAX_SMEM_BYTES:
        return 'wgmma_f32_rs'
    return 'simt'


def dpair_w(w: torch.Tensor) -> torch.Tensor:
    """w ``(L, F, G)`` as the tensor-core K3 reads it: ``(F, G_pad, L_pad)``
    with ``out[f, g, l] = w[l, f, g]``, zeros past G and L. G_pad is a
    multiple of the G tile (:func:`bwd_g_tile`), L_pad of 64: each TMA load
    is one f's 64 l × G-tile block, l contiguous (the K-major B operand of
    ``dpairᵀ = dzᵀ·W[:, f, :]``). Float32 w comes as its three planes
    (:func:`split_bf16x3`) in that layout: ``(3, F, G_pad, L_pad)``
    bfloat16."""
    L, F, G = w.shape
    g_tile = bwd_g_tile(G)
    g_pad = -(-G // g_tile) * g_tile
    l_pad = -(-L // _L_CHUNK) * _L_CHUNK
    if w.dtype == torch.float32:
        out = torch.zeros((3, F, g_pad, l_pad), dtype=torch.bfloat16,
                          device=w.device)
        out[:, :, :G, :L] = split_bf16x3(w).permute(0, 2, 3, 1)
        return out
    out = w.new_zeros((F, g_pad, l_pad))
    out[:, :G, :L] = w.permute(1, 2, 0)
    return out


def wgmma_bwd_plan(N: int, F: int, G: int, L: int, design: str = 'wgmma'):
    """``(splits, cols_per_split, g_tiles)`` of the tensor-core K3 for
    N = B·D columns. The dW pass's blocks own 128 pair rows × 128 l and one
    range of ``cols_per_split`` columns (a multiple of 64), none under 512
    columns and none empty. ``'wgmma'`` (bfloat16, two blocks an SM): as
    many ranges as fill one wave of two blocks on each of the card's SMs.
    ``'wgmma_f32'`` (one block an SM): the fewest ranges whose blocks fill
    their last wave of the card's SMs to 90% (at most 64; else the
    fullest). ``'wgmma_f32_rs'`` (the same dW pass): as many, and at least
    enough that no range holds over 2048 columns. wgmma's accumulator
    drops the bits below each step's largest term, an error that grows
    with the range one block sums: at xDeepFM's 200 maps, B = 8192, D = 10,
    three ranges left the second layer's dW gradient 1.7e-4 of its norm
    from the float32 reference and 2048-column ranges 4.4e-5; the partials
    are summed in IEEE float32 (H100). The dx0/dh pass sums dx0 over
    ``g_tiles`` tiles of G."""
    tiles = math.ceil(F * G / _DW_ROWS) * math.ceil(L / _DW_ROWS)
    most = max(1, min(math.ceil(N / _MIN_COLS_PER_SPLIT), 65535))
    if design == 'wgmma':
        splits = max(1, min(2 * _SM_COUNT // tiles, most))
    else:
        def fill(s):
            blocks = tiles * s
            return blocks / (math.ceil(blocks / _SM_COUNT) * _SM_COUNT)
        candidates = range(1, min(64, most) + 1)
        splits = next((s for s in candidates if fill(s) >= 0.9),
                      max(candidates, key=fill))
        if design == 'wgmma_f32_rs':
            splits = max(splits, min(math.ceil(N / _RS_MAX_COLS), 65535))
    cols = math.ceil(math.ceil(N / splits) / _DW_COLS) * _DW_COLS
    return math.ceil(N / cols), cols, math.ceil(G / bwd_g_tile(G))


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library('cin')
    for name in _FWD.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.dt_cin_fwd_bf16_wgmma.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.dt_cin_fwd_bf16_wgmma.restype = ctypes.c_int
    lib.dt_cin_fwd_f32_wgmma.argtypes = [ctypes.c_void_p] * 4 \
        + [ctypes.c_int64] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.dt_cin_fwd_f32_wgmma.restype = ctypes.c_int
    for name in _BWD.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _BWD_WGMMA.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64] \
            + [ctypes.c_int] * 7 + [ctypes.c_int64] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.dt_cin_error_string.argtypes = [ctypes.c_int]
    lib.dt_cin_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(what, x0, h, w, dz=None):
    if x0.dim() != 3 or h.dim() != 3 or w.dim() != 3:
        raise ValueError(f'{what} expects x0 (B, F, D), h (B, G, D) and w '
                         f'(L, F, G), got {tuple(x0.shape)}, '
                         f'{tuple(h.shape)} and {tuple(w.shape)}')
    B, F, D = x0.shape
    L = w.shape[0]
    if h.shape[0] != B or h.shape[2] != D or w.shape[1:] != (F, h.shape[1]):
        raise ValueError(f'{what}: shapes do not agree: x0 {tuple(x0.shape)}, '
                         f'h {tuple(h.shape)}, w {tuple(w.shape)}')
    if dz is not None and tuple(dz.shape) != (B, L, D):
        raise ValueError(f'{what}: dz must be {(B, L, D)}, got '
                         f'{tuple(dz.shape)}')


def _check_cuda(what, *tensors):
    x0 = tensors[0]
    for t in tensors:
        if t.device != x0.device:
            raise ValueError(f'{what} runs on cuda or cpu tensors on one '
                             f'device, got {t.device} and {x0.device}')
        if t.dtype != x0.dtype or t.dtype not in _FWD:
            raise TypeError(f'{what} kernel takes float32 or bfloat16 '
                            f'operands of one type, got {t.dtype} beside '
                            f'{x0.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{what} kernel needs contiguous operands')


def _raise_on(err: int, lib, what: str):
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err} '
                           f'({lib.dt_cin_error_string(err).decode()})')


@spanned('deeptables.kernel.cin_fwd')
def cin_fwd(x0: torch.Tensor, h: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """The contraction z ``(B, L, D)`` float32 of contiguous x0, h and w of
    one type (float32 or bfloat16).

    On a CUDA tensor this launches the kernel :func:`fwd_design` names or
    raises; it never falls back to the plain version or to another design.
    Every design takes the float32 products of the inputs and sums them in
    float32. ``'simt'`` sums in IEEE float32 FMAs; the tensor-core designs
    (``'wgmma'``, ``'wgmma_f32'``) in wgmma's float32 accumulator, which
    aligns a step's products to the largest and drops the bits below it:
    their sums differ from IEEE float32 summation by up to about half of
    1e-5·Σ|terms| at F·G ≈ 10⁴ (float32 on an H100).
    ``cin_fwd.launches`` counts the launches."""
    _check_shapes('cin_fwd', x0, h, w)
    if x0.device.type == 'cpu':
        return cin_fwd_reference(x0, h, w)
    _check_cuda('cin_fwd', x0, h, w)
    B, F, D = x0.shape
    L, _, G = w.shape
    z = torch.empty((B, L, D), dtype=torch.float32, device=x0.device)
    if z.numel() == 0:
        return z
    if F * G == 0:
        return z.zero_()
    lib = _library()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        design = fwd_design(x0.dtype, F, G)
        if design == 'wgmma':
            w_pad = padded_w(w)
            err = lib.dt_cin_fwd_bf16_wgmma(
                x0.data_ptr(), h.data_ptr(), w_pad.data_ptr(), z.data_ptr(),
                B, F, G, L, D, w_pad.shape[1], stream)
        elif design == 'wgmma_f32':
            planes = padded_w(w)
            err = lib.dt_cin_fwd_f32_wgmma(
                x0.data_ptr(), h.data_ptr(), planes.data_ptr(),
                z.data_ptr(), B, F, G, L, D, planes.shape[1],
                planes.shape[2], stream)
        else:
            err = getattr(lib, _FWD[x0.dtype])(
                x0.data_ptr(), h.data_ptr(), w.data_ptr(), z.data_ptr(), B,
                F, G, L, D, stream)
    _raise_on(err, lib, 'cin_fwd')
    cin_fwd.launches += 1
    return z


@spanned('deeptables.kernel.cin_bwd')
def cin_bwd(x0: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
            dz: torch.Tensor):
    """Gradient of :func:`cin_fwd` given dz ``(B, L, D)``, all operands
    contiguous and of one type: ``(dx0, dh, dW)``, dx0 and dh in that type,
    dW ``(L, F, G)`` float32.

    On a CUDA tensor this launches the kernels :func:`bwd_design` names
    (their passes, one call) or raises; it never falls back to the plain
    version or to another design. Every design takes the float32 products
    of the inputs, sums them in float32 and rounds dx0 and dh once; the
    tensor-core designs sum dpair and dW in wgmma's float32 accumulator,
    which rounds unlike IEEE float32 summation (see :func:`cin_fwd`). The
    two float32 tensor-core designs differ in where the dx0/dh pass splits
    dz, ``'wgmma_f32'`` once into three bfloat16 planes in shared memory,
    ``'wgmma_f32_rs'`` (L past the planes' shared memory) in registers from
    a float32 tile, and in the dW pass's ranges (:func:`wgmma_bwd_plan`);
    both launch one ``cin_bwd_dx`` kernel a call. ``cin_bwd.launches`` counts the calls, ``cin_bwd.designs`` the
    calls by design name."""
    _check_shapes('cin_bwd', x0, h, w, dz)
    if x0.device.type == 'cpu':
        return cin_bwd_reference(x0, h, w, dz)
    _check_cuda('cin_bwd', x0, h, w, dz)
    B, F, D = x0.shape
    L, _, G = w.shape
    dx0 = torch.empty_like(x0)
    dh = torch.empty_like(h)
    dw = torch.empty((L, F, G), dtype=torch.float32, device=x0.device)
    if B * D == 0 or L == 0 or F * G == 0:
        return dx0.zero_(), dh.zero_(), dw.zero_()
    N = B * D
    design = bwd_design(x0.dtype, F, G, L)
    if design == 'simt':
        splits, g_tiles = bwd_plan(N, F, G, L)
    else:
        splits, cols, g_tiles = wgmma_bwd_plan(N, F, G, L, design)
    dw_part = torch.empty((splits, L, F, G), dtype=torch.float32,
                          device=x0.device)
    dx0_part = torch.empty((g_tiles, B, F, D), dtype=torch.float32,
                           device=x0.device) if g_tiles > 1 else None
    part_ptr = None if dx0_part is None else dx0_part.data_ptr()
    lib = _library()
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design != 'simt':
            w_t = dpair_w(w)
            err = getattr(lib, _BWD_WGMMA[design])(
                x0.data_ptr(), h.data_ptr(), w_t.data_ptr(), dz.data_ptr(),
                dx0.data_ptr(), dh.data_ptr(), dw.data_ptr(), part_ptr,
                dw_part.data_ptr(), B, F, G, L, D, w_t.shape[-2],
                w_t.shape[-1], splits, cols, stream)
        else:
            err = getattr(lib, _BWD[x0.dtype])(
                x0.data_ptr(), h.data_ptr(), w.data_ptr(), dz.data_ptr(),
                dx0.data_ptr(), dh.data_ptr(), dw.data_ptr(), part_ptr,
                dw_part.data_ptr(), B, F, G, L, D, splits, stream)
    _raise_on(err, lib, 'cin_bwd')
    cin_bwd.launches += 1
    cin_bwd.designs[design] = cin_bwd.designs.get(design, 0) + 1
    return dx0, dh, dw


cin_fwd.launches = 0
cin_bwd.launches = 0
cin_bwd.designs = {}
