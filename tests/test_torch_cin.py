# -*- coding:utf-8 -*-
"""The port's CIN (``deeptables_torch.ops.kernels.cin``,
``ops/cin_grad.py``, ``ops/interactions.CIN``, ``cin_nets``) against the
JAX package, on the CPU.

- The plain versions against the Pallas kernels in interpret mode
  (``cin_fwd_pallas``, ``cin_bwd_pallas`` over several grid blocks) and
  ``cin_bwd_oracle``, float32, at (F, G, L) with G = 7 and L not a multiple
  of 8: rtol/atol 1e-4, dW atol 1e-3, as the JAX package's own kernel tests
  hold the kernel to its oracle (sums of ~100 terms in another order).
- The ``CIN`` module against the JAX ``CIN`` over the same weights, for each
  option: output, and the gradients of x and of every weight. float32
  rtol 1e-4 with an absolute term of 1e-4 times the tensor's largest value
  (only the summation order differs). bfloat16: 2⁻⁶ of the tensor's
  largest value, a few bfloat16 roundings: on the CPU the JAX backward takes
  its XLA fallback, which rounds dpair (a sum over L) to bfloat16 before the
  sums over f and g, where the port (like the Pallas kernel) keeps it in
  float32; the forward rounds at other places as well (the batch-minor XLA
  forward rounds the pair product itself). The bfloat16 cases use tanh in
  place of relu: a z within rounding of zero may take the other side of
  relu's kink in the two frameworks and change its gradient by a step.
- An xDeepFM ``DeepModel`` bridged from JAX: one train step's gradients and
  a short ``fit`` (float32 rtol 1e-4; bfloat16 rtol 1e-2 with 1e-2 of the
  largest gradient), and ``Predictor`` output (atol 1e-5).
"""

import logging
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.ops import interactions as jax_interactions
from deeptables_tpu.ops import losses as jax_losses
from deeptables_tpu.ops.kernels.cin_bwd import (cin_bwd_oracle,
                                                cin_bwd_pallas,
                                                cin_fwd_pallas)
from deeptables_tpu import serving as jax_serving
from deeptables_torch import bridge, serving
from deeptables_torch.ops import cin_grad, initializers, losses
from deeptables_torch.ops.interactions import CIN
from deeptables_torch.ops.kernels.cin import (bwd_design, bwd_g_tile,
                                              bwd_plan, cin_bwd,
                                              cin_bwd_reference, cin_fwd,
                                              cin_fwd_reference, dpair_w,
                                              dx_rs_smem_bytes, fwd_design,
                                              padded_w, split_bf16x3,
                                              wgmma_bwd_plan)
from torch_parity import Case

torch.set_num_threads(1)  # the suite runs several xdist workers

F32, BF16 = 'float32', 'bfloat16'
BF16_TOL = 2.0 ** -6


def _bm(a):
    """(B, R, D) → the JAX batch-minor (R, D·B)."""
    return jnp.asarray(a.transpose(1, 2, 0).reshape(a.shape[1], -1))


def _from_bm(a, B, D):
    a = np.asarray(a)
    return a.reshape(a.shape[0], D, B).transpose(2, 0, 1)


def _operands(B, F, G, L, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, F, D), (B, G, D), (L, F, G), (B, L, D))]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------- kernels

KERNEL_SHAPES = [(16, 5, 5, 8, 16), (32, 5, 7, 16, 8), (32, 4, 7, 12, 16),
                 (64, 3, 9, 5, 4)]


@pytest.mark.parametrize('B,F,G,L,D', KERNEL_SHAPES)
def test_fwd_reference_matches_pallas_forward(B, F, G, L, D):
    x0, h, w, _ = _operands(B, F, G, L, D)
    expected = cin_fwd_pallas(_bm(x0), _bm(h),
                              jnp.asarray(w.reshape(L, F * G)),
                              interpret=True, block_lanes=128)
    z = cin_fwd_reference(*_torch(x0, h, w))
    assert z.dtype == torch.float32 and z.shape == (B, L, D)
    np.testing.assert_allclose(z.numpy(), _from_bm(expected, B, D),
                               rtol=1e-4, atol=1e-4)
    # the wrapper takes the plain version for CPU tensors, and counts
    # no launch
    before = cin_fwd.launches
    torch.testing.assert_close(cin_fwd(*_torch(x0, h, w)), z)
    assert cin_fwd.launches == before


@pytest.mark.parametrize('B,F,G,L,D', KERNEL_SHAPES)
def test_bwd_reference_matches_pallas_backward_and_oracle(B, F, G, L, D):
    x0, h, w, dz = _operands(B, F, G, L, D, seed=1)
    args = (_bm(x0), _bm(h), jnp.asarray(w.reshape(L, F * G)), _bm(dz))
    pallas = cin_bwd_pallas(*args, interpret=True, block_lanes=128)
    oracle = cin_bwd_oracle(*args)
    before = cin_bwd.launches
    got = cin_bwd(*_torch(x0, h, w, dz))
    assert cin_bwd.launches == before
    reference = cin_bwd_reference(*_torch(x0, h, w, dz))
    for a, b in zip(got, reference):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dx0, dh, dw = (t.numpy() for t in reference)
    assert dw.shape == (L, F, G)
    for expected in (pallas, oracle):
        np.testing.assert_allclose(dx0, _from_bm(expected[0], B, D),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(dh, _from_bm(expected[1], B, D),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(dw, np.asarray(expected[2]).reshape(
            L, F, G), rtol=1e-4, atol=1e-3)


def test_bwd_reference_rounds_once_to_each_input_type():
    x0, h, w, dz = _operands(8, 3, 4, 6, 16, seed=2)
    tx0, th, tw, tdz = _torch(x0, h, w, dz)
    dx0, dh, dw = cin_bwd_reference(tx0.bfloat16(), th, tw, tdz)
    assert (dx0.dtype, dh.dtype, dw.dtype) == (torch.bfloat16, torch.float32,
                                               torch.float32)
    exact = cin_bwd_reference(tx0.bfloat16().float(), th, tw, tdz)
    torch.testing.assert_close(dx0, exact[0].bfloat16(), rtol=0, atol=0)


def test_bwd_plan_covers_every_column():
    for N, F, G, L in ((131072, 26, 64, 128), (131072, 26, 26, 128),
                       (16, 5, 7, 12), (65536, 26, 130, 9)):
        splits, g_tiles = bwd_plan(N, F, G, L)
        assert 1 <= splits <= max(1, -(-N // 512))
        assert g_tiles == -(-G // (32 if G <= 32 else 64))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_pair_splits_exactly_into_two_bfloat16_halves(seed):
    """The premise of the tensor-core K4: for bfloat16 x0 and h, the float32
    product p is exact, and hi = bf16(p), lo = bf16(p - hi) give
    hi + lo == p exactly, so two bfloat16 products against W sum to the
    float32 pair's. Magnitudes 1e-8 to 1e8, both signs."""
    rng = np.random.default_rng(seed)

    def values(n):
        mags = 10.0 ** rng.uniform(-8, 8, n)
        signs = rng.choice([-1.0, 1.0], n)
        return torch.from_numpy(mags * signs).bfloat16()
    x0, h = values(100_000), values(100_000)
    p = x0.float() * h.float()
    assert torch.equal(p.double(), x0.double() * h.double())  # exact
    hi = p.bfloat16()
    lo = (p - hi.float()).bfloat16()
    assert torch.equal(hi.float() + lo.float(), p)
    assert torch.equal(hi.double() + lo.double(), p.double())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_split_bf16x3_reconstructs_every_float32_exactly(seed):
    """The premise of the float32 kernels: three bfloat16 planes, each
    rounded to nearest, sum to the float32 exactly, in float64 and in
    float32. Magnitudes over the normal range whose
    low planes stay normal (2⁻¹¹⁰ to the largest finite value), both signs,
    zero, and the float32 values within half a bfloat16 step of the largest
    finite one, where a plain first rounding would give infinity."""
    rng = np.random.default_rng(seed)
    mags = np.ldexp(rng.uniform(1, 2, 200_000),
                    rng.integers(-110, 128, 200_000))
    top = np.nextafter(np.float32(3.4028235e38), np.float32(0),
                       dtype=np.float32)
    edges = np.array([0.0, -0.0, 3.4028235e38, -3.4028235e38, top,
                      3.3961e38, 3.3895314e38, 2.0 ** -110, 1.0, -1.0],
                     np.float64)
    v = torch.from_numpy(np.concatenate([
        mags * rng.choice([-1.0, 1.0], mags.size), edges]).astype(np.float32))
    assert bool(v.isfinite().all())
    planes = split_bf16x3(v)
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, v.numel())
    assert bool(planes.isfinite().all())
    assert torch.equal(planes.double().sum(dim=0), v.double())
    # in float32 from the low planes up (the residuals are exact float32)
    assert torch.equal(planes[0].float() + (planes[1].float()
                                            + planes[2].float()), v)
    # each plane is the nearest bfloat16 to what the planes before it leave
    rest = v - planes[0].float()
    assert torch.equal(planes[1], rest.bfloat16())
    assert torch.equal(planes[2], (rest - planes[1].float()).bfloat16())
    # the six plane products the kernels take miss a float32 product by at
    # most ~2·2⁻²⁴ of it, float32's own rounding of the product
    a, b = v[:1000].double(), v.flip(0)[:1000].double()
    pa, pb = split_bf16x3(v[:1000]).double(), \
        split_bf16x3(v.flip(0)[:1000]).double()
    six = sum(pa[i] * pb[j] for i in range(3) for j in range(3) if i + j <= 2)
    keep = (a * b).abs() < 1e300
    assert bool(((six - a * b).abs()[keep]
                 <= 2.0 ** -22 * (a * b).abs()[keep]).all())


def _six(a, b, contract):
    """The float32 kernels' product of float32 operands a and b: the
    contraction of their planes (split_bf16x3) over the six pairs i + j ≤ 2,
    summed in float64 (the tensor cores sum float32 products of bfloat16
    planes, exact, into float32)."""
    pa, pb = split_bf16x3(a).double(), split_bf16x3(b).double()
    return sum(contract(pa[i], pb[j]) for i in range(3) for j in range(3)
               if i + j <= 2)


def _limit(scale, tol=1e-5):
    return tol * np.asarray(scale, np.float64)


@pytest.mark.parametrize('B,F,G,L,D', KERNEL_SHAPES)
def test_three_plane_forward_matches_float64_and_pallas(B, F, G, L, D):
    """K4 in float32 as the tensor-core kernel computes it: the float32
    pair p = x0·h split into three planes against W's three, six products
    summed; within 1e-5 of the sum of its terms' magnitudes of the float64
    contraction and of the Pallas forward in float32 (interpret mode)."""
    x0, h, w, _ = _operands(B, F, G, L, D, seed=4)
    tx0, th, tw = _torch(x0, h, w)
    pair = (tx0[:, :, None, :] * th[:, None, :, :]).reshape(B, F * G, D)
    z = _six(pair, tw.reshape(L, F * G),
             lambda p, q: torch.einsum('bkd,lk->bld', p, q)).numpy()
    exact = np.einsum('bfd,bgd,lfg->bld', x0.astype(np.float64),
                      h.astype(np.float64), w.astype(np.float64))
    scale = np.einsum('bfd,bgd,lfg->bld', np.abs(x0).astype(np.float64),
                      np.abs(h).astype(np.float64),
                      np.abs(w).astype(np.float64))
    pallas = _from_bm(cin_fwd_pallas(_bm(x0), _bm(h),
                                     jnp.asarray(w.reshape(L, F * G)),
                                     interpret=True, block_lanes=128), B, D)
    for expected in (exact, pallas):
        assert (np.abs(z - expected) <= _limit(scale)).all()


@pytest.mark.parametrize('B,F,G,L,D', KERNEL_SHAPES)
def test_three_plane_backward_matches_float64_and_oracle(B, F, G, L, D):
    """K3 in float32 as the tensor-core passes compute it: dpair from the
    planes of dz and W, folded into dx0 and dh with float32 h and x0; dW
    from the planes of the float32 pair and dz. Within 1e-5 of the sum of
    each output's terms' magnitudes of the float64 gradient and of
    ``cin_bwd_oracle`` in float32."""
    x0, h, w, dz = _operands(B, F, G, L, D, seed=5)
    tx0, th, tw, tdz = _torch(x0, h, w, dz)
    dpair = _six(tw, tdz, lambda p, q: torch.einsum('lfg,bld->bfgd', p, q))
    dx0 = torch.einsum('bfgd,bgd->bfd', dpair, th.double()).numpy()
    dh = torch.einsum('bfgd,bfd->bgd', dpair, tx0.double()).numpy()
    pair = tx0[:, :, None, :] * th[:, None, :, :]
    dw = _six(pair, tdz,
              lambda p, q: torch.einsum('bfgd,bld->lfg', p, q)).numpy()
    exact = [t.numpy() for t in cin_bwd_reference(
        *_torch(*(a.astype(np.float64) for a in (x0, h, w, dz))))]
    scales = [t.numpy() for t in cin_bwd_reference(
        *_torch(*(np.abs(a).astype(np.float64) for a in (x0, h, w, dz))))]
    oracle = cin_bwd_oracle(_bm(x0), _bm(h), jnp.asarray(w.reshape(L, F * G)),
                            _bm(dz))
    oracle = [_from_bm(oracle[0], B, D), _from_bm(oracle[1], B, D),
              np.asarray(oracle[2]).reshape(L, F, G)]
    for got, ref, orc, scale in zip((dx0, dh, dw), exact, oracle, scales):
        for expected in (ref, orc):
            assert (np.abs(got - expected) <= _limit(scale)).all()


@pytest.mark.parametrize('F,G,L', [(26, 26, 128), (26, 64, 128), (5, 7, 3)])
def test_padded_w_is_k_major_with_zeros_past_k(F, G, L):
    w = torch.randn(L, F, G, generator=torch.Generator().manual_seed(F + G))
    w = w.bfloat16()
    out = padded_w(w)
    K = F * G
    assert out.dtype == w.dtype and out.shape[0] == L
    assert out.shape[1] % 64 == 0 and K <= out.shape[1] < K + 64
    assert torch.equal(out[:, :K], w.reshape(L, K))
    assert not out[:, K:].any()


def test_fwd_design_takes_the_tensor_cores_for_bfloat16_only():
    """Each type's tensor-core K4 where its tiles fit a block's shared
    memory, the CUDA cores just past: bfloat16 F + G ≤ 602; float32 (the
    three-plane split, not TF32) F + G ≤ 252, xDeepFM's and fgcnn_cin's
    layers included."""
    assert fwd_design(torch.bfloat16, 26, 64) == 'wgmma'
    assert fwd_design(torch.bfloat16, 26, 576) == 'wgmma'  # F + G = 602
    assert fwd_design(torch.bfloat16, 26, 577) == 'simt'   # past the tiles
    for F, G in ((26, 26), (26, 64), (104, 104), (104, 64), (1, 1)):
        assert fwd_design(torch.float32, F, G) == 'wgmma_f32'
    assert fwd_design(torch.float32, 26, 226) == 'wgmma_f32'  # F + G = 252
    assert fwd_design(torch.float32, 26, 227) == 'simt'
    assert fwd_design(torch.float32, 126, 127) == 'simt'


def test_bwd_design_takes_the_tensor_cores_for_bfloat16_only():
    """Each type's tensor-core K3 where both passes' tiles fit, the CUDA
    cores just past, at the exact boundaries: bfloat16 L ≤ 704 (the dx0/dh
    pass's dz tile) and G ≤ 686 at F = 3 (the dW pass's h rows); float32
    with three planes of dz in the dx0/dh pass (a ring of at least two
    stages) L ≤ 192, or L ≤ 256 for G ≤ 32; past that, dz kept once in
    float32 and split in registers (``'wgmma_f32_rs'``) to L ≤ 336, or
    L ≤ 384 for G ≤ 32; and G ≤ 228 at F = 3."""
    for F, G, L in ((26, 26, 128), (26, 64, 128), (26, 128, 128),
                    (104, 104, 128), (104, 64, 128), (1, 1, 1)):
        assert bwd_design(torch.bfloat16, F, G, L) == 'wgmma'
        assert bwd_design(torch.float32, F, G, L) == 'wgmma_f32'
    assert bwd_design(torch.bfloat16, 5, 7, 300) == 'wgmma'
    assert bwd_design(torch.float32, 5, 7, 300) == 'wgmma_f32_rs'
    # xDeepFM at the paper's 200 maps: layer 0's dz planes fit (G tile
    # 32), layers 1 and 2 split dz in registers
    assert bwd_design(torch.float32, 26, 26, 200) == 'wgmma_f32'
    assert bwd_design(torch.float32, 26, 200, 200) == 'wgmma_f32_rs'
    assert bwd_design(torch.bfloat16, 26, 200, 200) == 'wgmma'
    # the dx0/dh pass's dz tile: 128 columns of L padded to 64
    assert bwd_design(torch.bfloat16, 26, 64, 704) == 'wgmma'
    assert bwd_design(torch.bfloat16, 26, 64, 705) == 'simt'
    assert bwd_design(torch.bfloat16, 5, 4, 900) == 'simt'
    assert bwd_design(torch.float32, 26, 64, 192) == 'wgmma_f32'
    assert bwd_design(torch.float32, 26, 64, 193) == 'wgmma_f32_rs'
    assert bwd_design(torch.float32, 26, 32, 256) == 'wgmma_f32'
    assert bwd_design(torch.float32, 26, 32, 257) == 'wgmma_f32_rs'
    # ... and in float32 past the planes: L padded to 16, G tiles of 64
    # and 32
    assert bwd_design(torch.float32, 26, 64, 336) == 'wgmma_f32_rs'
    assert bwd_design(torch.float32, 26, 64, 337) == 'simt'
    assert bwd_design(torch.float32, 26, 200, 337) == 'simt'
    assert bwd_design(torch.float32, 26, 32, 384) == 'wgmma_f32_rs'
    assert bwd_design(torch.float32, 26, 32, 385) == 'simt'
    # the dW pass's two buffers of h rows
    assert bwd_design(torch.bfloat16, 3, 686, 5) == 'wgmma'
    assert bwd_design(torch.bfloat16, 3, 687, 5) == 'simt'
    assert bwd_design(torch.bfloat16, 3, 700, 5) == 'simt'
    assert bwd_design(torch.float32, 3, 228, 5) == 'wgmma_f32'
    assert bwd_design(torch.float32, 3, 229, 5) == 'simt'
    assert bwd_design(torch.float32, 3, 229, 300) == 'simt'


def _cin_cu_function(src, name, constants):
    """``csrc/cin.cu``'s ``wg::<name>``, a lone ``return`` of integer
    arithmetic, as a Python function of its parameters: the C expression
    with its casts dropped, ``Split<float>::kOp`` as 3 and ``/`` as floor
    division (every operand is positive)."""
    m = re.search(rf'\b{name}\(([^)]*)\)\s*\{{\s*return (.*?);\s*\}}',
                  src, re.S)
    params = [p.split()[-1] for p in m.group(1).split(',')]
    expr = re.sub(r'static_cast<\w+>', '', m.group(2))
    expr = expr.replace('Split<float>::kOp', '3').replace('/', '//')
    return eval(f"lambda {', '.join(params)}: ({expr})", constants)


def test_dx_rs_smem_bytes_is_cin_cu_s_reckoning():
    """The wrapper's shared memory of the float32 dx0/dh pass that splits
    dz in registers equals ``csrc/cin.cu``'s ``wg::dx_rs_smem_bytes`` (read
    from the source, with its constants) at every L to 400 and both G
    tiles, so ``bwd_design`` sends it only the shapes whose launch the C
    side takes: the first L in and the first L out at each tile."""
    src = (Path(__file__).resolve().parents[1] / 'deeptables_torch' / 'csrc'
           / 'cin.cu').read_text()
    constants = {}
    for name, value in re.findall(r'constexpr int (k\w+) = ([\w\s*+]+);',
                                  src):
        try:
            constants[name] = eval(value, dict(constants))
        except NameError:  # a constant of Split<T>'s, not of these
            pass
    constants['bwd_g_tile'] = bwd_g_tile
    constants['dx_rs_ld'] = _cin_cu_function(src, 'dx_rs_ld', constants)
    c_bytes = _cin_cu_function(src, 'dx_rs_smem_bytes', constants)
    limit = constants['kMaxSmemBytes']
    assert limit == 232448
    for G in (26, 64, 200):
        for L in range(1, 401):
            for stages in (2, 3, 4):
                assert dx_rs_smem_bytes(G, L, stages) == \
                    c_bytes(G, L, stages), (G, L, stages)
    # the limits: first in, first out, at G tiles 32 and 64
    for G, last in ((26, 384), (64, 336), (200, 336)):
        assert c_bytes(G, last, 2) <= limit < c_bytes(G, last + 1, 2)
        assert bwd_design(torch.float32, 26, G, last) == 'wgmma_f32_rs'
        assert bwd_design(torch.float32, 26, G, last + 1) == 'simt'
    # xDeepFM's layers 1-2: four stages of the ring fit
    assert c_bytes(200, 200, 4) == 209984 <= limit


@pytest.mark.parametrize('F,G,L', [(26, 26, 128), (26, 64, 128),
                                   (26, 128, 128), (4, 130, 9), (5, 7, 300),
                                   (1, 1, 1)])
def test_dpair_w_is_f_g_l_with_zeros_past_g_and_l(F, G, L):
    w = torch.randn(L, F, G, generator=torch.Generator().manual_seed(F * G))
    w = w.bfloat16()
    out = dpair_w(w)
    g_tile = bwd_g_tile(G)
    assert g_tile == (32 if G <= 32 else 64)
    _, g_pad, l_pad = out.shape
    assert out.dtype == w.dtype and out.shape[0] == F and out.is_contiguous()
    assert g_pad % g_tile == 0 and G <= g_pad < G + g_tile
    assert l_pad % 64 == 0 and L <= l_pad < L + 64
    assert torch.equal(out[:, :G, :L], w.permute(1, 2, 0))
    assert not out[:, G:].any() and not out[:, :, L:].any()
    # where the kernel reads it: the TMA view (F * G_pad, L_pad), row
    # f * G_pad + g0 + g of G tile g0, column l
    view = out.reshape(F * g_pad, l_pad)
    f, g, l = torch.meshgrid(torch.arange(F), torch.arange(G),
                             torch.arange(L), indexing='ij')
    for g0 in range(0, g_pad, g_tile):
        rows = f * g_pad + g0 + (g - g0)
        keep = (g >= g0) & (g < g0 + g_tile)
        assert torch.equal(view[rows[keep], l[keep]], w[l[keep], f[keep],
                                                         g[keep]])


@pytest.mark.parametrize('N,F,G,L', [(131072, 26, 64, 128),
                                     (131072, 26, 26, 128),
                                     (65504, 26, 26, 128), (16, 5, 7, 12),
                                     (65536, 4, 130, 9), (4096, 26, 64, 256),
                                     (592, 26, 26, 128), (1, 1, 1, 1)])
def test_wgmma_bwd_plan_covers_every_column_once(N, F, G, L):
    splits, cols, g_tiles = wgmma_bwd_plan(N, F, G, L)
    assert cols % 64 == 0 and 1 <= splits <= 65535
    # every range holds a column, and the ranges [s * cols, (s + 1) * cols)
    # cover 0 .. N - 1 once
    assert (splits - 1) * cols < N <= splits * cols
    covered = np.zeros(N, np.int64)
    for s in range(splits):
        covered[s * cols:min((s + 1) * cols, N)] += 1
    assert (covered == 1).all()
    assert g_tiles == -(-G // bwd_g_tile(G))
    # one wave of two blocks an SM at most: 128 pair rows x 128 l a block
    tiles = -(-F * G // 128) * -(-L // 128)
    assert splits == 1 or tiles * splits <= 2 * 132


@pytest.mark.parametrize('F,G,L', [(26, 26, 128), (26, 64, 128),
                                   (104, 104, 128), (5, 7, 130), (1, 1, 1)])
def test_float32_w_comes_in_three_planes(F, G, L):
    """The float32 kernels' W: :func:`padded_w` the three planes in K4's
    (L, K_pad) layout with L padded to 128-row tiles, (3, L_pad, K_pad);
    :func:`dpair_w` in K3's (F, G_pad, L_pad) layout, (3, F, G_pad, L_pad);
    zeros in every pad, planes that sum to w exactly."""
    w = torch.randn(L, F, G, generator=torch.Generator().manual_seed(L + G))
    planes = split_bf16x3(w)
    K = F * G
    fwd = padded_w(w)
    assert fwd.dtype == torch.bfloat16 and fwd.shape[0] == 3
    assert fwd.shape[1] % 128 == 0 and L <= fwd.shape[1] < L + 128
    assert fwd.shape[2] % 64 == 0 and K <= fwd.shape[2] < K + 64
    assert torch.equal(fwd[:, :L, :K], planes.reshape(3, L, K))
    assert not fwd[:, L:].any() and not fwd[:, :, K:].any()
    assert torch.equal(fwd[:, :L, :K].double().sum(0),
                       w.reshape(L, K).double())
    bwd = dpair_w(w)
    g_tile = bwd_g_tile(G)
    assert bwd.dtype == torch.bfloat16 and bwd.is_contiguous()
    _, _, g_pad, l_pad = bwd.shape
    assert bwd.shape[:2] == (3, F)
    assert g_pad % g_tile == 0 and G <= g_pad < G + g_tile
    assert l_pad % 64 == 0 and L <= l_pad < L + 64
    assert torch.equal(bwd[:, :, :G, :L], planes.permute(0, 2, 3, 1))
    assert not bwd[:, :, G:].any() and not bwd[:, :, :, L:].any()


@pytest.mark.parametrize('N,F,G,L', [(131072, 26, 26, 128),
                                     (131072, 26, 64, 128),
                                     (131072, 104, 104, 128),
                                     (131072, 104, 64, 128),
                                     (65488, 26, 26, 128), (16, 5, 7, 12),
                                     (65536, 3, 228, 5), (1, 1, 1, 1)])
def test_wgmma_f32_bwd_plan_fills_whole_waves(N, F, G, L):
    """The float32 dW pass (one block an SM): every column in one range,
    and the fewest ranges whose blocks fill their last wave of 132 SMs to
    90% where 512-column ranges allow it."""
    splits, cols, g_tiles = wgmma_bwd_plan(N, F, G, L, 'wgmma_f32')
    assert cols % 64 == 0 and 1 <= splits <= 64
    assert (splits - 1) * cols < N <= splits * cols
    assert g_tiles == -(-G // bwd_g_tile(G))
    tiles = -(-F * G // 128) * -(-L // 128)

    def fill(s):
        return tiles * s / (-(-tiles * s // 132) * 132)
    if fill(splits) < 0.9:  # no count of ranges fills 90%
        assert all(fill(s) <= fill(splits)
                   for s in range(1, min(64, -(-N // 512)) + 1))
    # xDeepFM's and fgcnn_cin's layers at B = 8192
    expected = {(131072, 26, 26, 128): 20, (131072, 26, 64, 128): 10,
                (131072, 104, 104, 128): 3, (131072, 104, 64, 128): 5}
    assert splits == expected.get((N, F, G, L), splits)


@pytest.mark.parametrize('N,F,G,L', [(81920, 26, 200, 200),
                                     (65488, 26, 200, 200),
                                     (4093 * 16, 26, 64, 193),
                                     (8192, 5, 7, 300), (16, 5, 7, 300),
                                     (1, 1, 1, 1)])
def test_wgmma_f32_rs_bwd_plan_keeps_each_range_short(N, F, G, L):
    """The float32 design that splits dz in registers runs the same dW pass
    with at least the ranges of ``'wgmma_f32'``, and as many more as keep
    every range within 2048 columns (the accumulator's run); every column
    in one range."""
    splits, cols, g_tiles = wgmma_bwd_plan(N, F, G, L, 'wgmma_f32_rs')
    base, base_cols, _ = wgmma_bwd_plan(N, F, G, L, 'wgmma_f32')
    assert cols % 64 == 0 and cols <= 2048
    assert (splits - 1) * cols < N <= splits * cols
    assert splits >= base and cols <= base_cols
    assert g_tiles == -(-G // bwd_g_tile(G))
    # xDeepFM's layers 1-2 at B = 8192, D = 10: 40 ranges, not 3
    if (N, G) == (81920, 200):
        assert (splits, cols, base) == (40, 2048, 3)


def test_wrappers_reject_bad_shapes():
    x0, h, w, dz = _torch(*_operands(4, 3, 5, 6, 8))
    with pytest.raises(ValueError):
        cin_fwd(x0, h, w[:, :, :4])
    with pytest.raises(ValueError):
        cin_fwd(x0[0], h, w)
    with pytest.raises(ValueError):
        cin_bwd(x0, h, w, dz[:, :5])


# ---------------------------------------------------------------- knobs

def test_formulations_and_settings(monkeypatch):
    assert cin_grad.FORMULATIONS == ('auto', 'assoc', 'bm', 'pallas')
    x0, h, w, _ = _torch(*_operands(4, 3, 5, 6, 8, seed=3))
    expected = cin_fwd_reference(x0, h, w)
    for name in cin_grad.FORMULATIONS:
        torch.testing.assert_close(cin_grad.cin_contract(x0, h, w, name),
                                   expected)
    with pytest.raises(ValueError, match='unknown CIN backward'):
        cin_grad.cin_contract(x0, h, w, 'fused')
    monkeypatch.setenv('DT_CIN_BWD', 'bm')
    assert cin_grad.default_formulation() == 'bm'
    monkeypatch.setenv('DT_CIN_BWD', 'nope')
    with pytest.raises(ValueError, match='unknown CIN backward'):
        cin_grad.cin_contract(x0, h, w)
    monkeypatch.delenv('DT_CIN_BWD')
    assert cin_grad.default_formulation() == 'pallas'


def test_chunk_f_setting_warns_and_reads_zero(monkeypatch):
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    cin_grad.logger.addHandler(handler)
    try:
        for value, expected in (('16', 16), ('auto', 'auto'), ('0', 0),
                                ('sixteen', 0)):
            monkeypatch.setenv('DT_CIN_BWD_CHUNK_F', value)
            assert cin_grad.chunk_f_setting() == expected
        # the backward reads it and runs all the same
        x0, h, w, dz = _torch(*_operands(4, 3, 5, 6, 8, seed=4))
        x0.requires_grad_(True)
        cin_grad.cin_contract(x0, h, w).backward(dz)
        torch.testing.assert_close(x0.grad,
                                   cin_bwd_reference(x0, h, w, dz)[0])
    finally:
        cin_grad.logger.removeHandler(handler)
    warnings = [r for r in records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and 'sixteen' in warnings[0].getMessage()


def test_use_pallas_flag_warns_and_changes_nothing():
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger('deeptables_torch.ops.interactions')
    logger.addHandler(handler)
    try:
        params = {'cross_layer_size': (4, 2), 'use_pallas': True}
        flagged = CIN(3, 8, params, generator=torch.Generator().manual_seed(0))
    finally:
        logger.removeHandler(handler)
    assert any('use_pallas' in r.getMessage() for r in records)
    plain = CIN(3, 8, {'cross_layer_size': (4, 2)})
    plain.load_state_dict(flagged.state_dict())
    x = torch.randn(5, 3, 8, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(flagged(x), plain(x))


def test_he_uniform_fans_match_flax_for_a_3d_shape():
    from flax import linen as jnn
    shape = (64, 26, 32)
    flax_draw = np.asarray(jnn.initializers.he_uniform()(
        jax.random.PRNGKey(0), shape))
    port_draw = initializers.get_initializer('he_uniform')(
        torch.Generator().manual_seed(0), shape).numpy()
    # both are uniform on [-limit, limit], limit = sqrt(6 / (26 * 64)):
    # the receptive field is the leading axis
    limit = np.sqrt(6.0 / (26 * 64))
    for draw in (flax_draw, port_draw):
        assert np.abs(draw).max() <= limit
        np.testing.assert_allclose(np.abs(draw).max(), limit, rtol=1e-3)
    assert initializers._fans(shape) == (26 * 64, 32 * 64)


def test_split_half_needs_even_sizes():
    with pytest.raises(ValueError, match='even'):
        CIN(3, 8, {'cross_layer_size': (5, 4)})
    CIN(3, 8, {'cross_layer_size': (5, 4), 'direct': True})


# ---------------------------------------------------------------- the module

CIN_OPTIONS = [{}, {'use_bias': True}, {'direct': True},
               {'use_residual': True}, {'reduce_D': True},
               {'layout': 'batch_minor'},
               {'reduce_D': True, 'use_residual': True, 'use_bias': True,
                'layout': 'batch_minor'}]


def _port_cin(F, D, params, jax_params):
    module = CIN(F, D, params)
    state = {}
    for key, value in jax_params.items():
        if isinstance(value, dict):
            state[f'{key}.weight'] = torch.from_numpy(
                np.asarray(value['kernel'], np.float32).T.copy())
            state[f'{key}.bias'] = torch.tensor(
                np.asarray(value['bias'], np.float32))
        else:
            state[key] = torch.tensor(np.asarray(value, np.float32))
    module.load_state_dict(state, strict=True)
    return module


def _close_to_max(actual, expected, dtype, name):
    actual = np.asarray(actual, np.float32)
    expected = np.asarray(expected, np.float32)
    assert actual.shape == expected.shape, name
    scale = float(np.abs(expected).max())
    if dtype == F32:
        np.testing.assert_allclose(actual, expected, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    else:
        np.testing.assert_allclose(actual, expected, rtol=0,
                                   atol=BF16_TOL * scale, err_msg=name)


@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('extra', CIN_OPTIONS,
                         ids=lambda e: '-'.join(sorted(e)) or 'default')
def test_cin_matches_jax_values_and_gradients(extra, dtype):
    B, F, D = 24, 5, 8
    params = dict({'cross_layer_size': (8, 4),
                   'activation': 'relu' if dtype == F32 else 'tanh'}, **extra)
    x = np.random.default_rng(5).normal(size=(B, F, D)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jax_module = jax_interactions.CIN(params=params)
    variables = jax_module.init(jax.random.PRNGKey(3), jx)

    # a fixed cotangent: both backwards start from the same dout
    g = np.random.default_rng(6).normal(size=(B, 1)).astype(np.float32)

    def loss(p, xv):
        out = jax_module.apply({'params': p}, xv)
        return jnp.sum(out * g), out

    (_, out), (grads, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables['params'], jx)

    module = _port_cin(F, D, params, jax.device_get(variables['params']))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    port_out = module(tx)
    port_out.backward(torch.from_numpy(g))
    assert port_out.dtype == torch.float32
    assert tx.grad.dtype == tx.dtype
    _close_to_max(port_out.detach(), out, dtype, 'out')
    _close_to_max(tx.grad.float(), np.asarray(dx, np.float32), dtype, 'dx')
    flat = {}
    for key, value in jax.device_get(grads).items():
        if isinstance(value, dict):
            flat[f'{key}.weight'] = np.asarray(value['kernel']).T
            flat[f'{key}.bias'] = np.asarray(value['bias'])
        else:
            flat[key] = np.asarray(value)
    named = dict(module.named_parameters())
    assert set(named) == set(flat)
    for name, p in named.items():
        _close_to_max(p.grad, flat[name], dtype, name)


def test_serving_forward_takes_no_autograd_path():
    module = CIN(4, 8, {'cross_layer_size': (6, 4)},
                 generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 4, 8)
    with torch.no_grad():
        out = module(x)
    assert out.grad_fn is None and out.shape == (3, 1)


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('cin_params', [None, {'reduce_D': True,
                                               'use_residual': True,
                                               'use_bias': True}],
                         ids=['default', 'reduce_D-residual-bias'])
def test_xdeepfm_one_train_step_matches_jax(cin_params, dtype):
    case = Case('xdeepfm_nonascending_d8', dtype, cin_params=cin_params)
    batch = case.batch(48, seed=8)
    rng = np.random.default_rng(9)
    y = rng.integers(0, 2, 48).astype(np.float32)
    module = case.jax_model.module
    batch_stats = case.variables['batch_stats']

    def train_loss(p):
        (logits, _), _ = module.apply(
            {'params': p, 'batch_stats': batch_stats}, batch, training=True,
            rngs={'dropout': jax.random.PRNGKey(0)}, mutable=['batch_stats'])
        return jax_losses.binary_crossentropy(logits, jnp.asarray(y), None)

    loss, grads = jax.value_and_grad(train_loss)(case.variables['params'])
    expected = bridge.state_dict_from_flax(
        {'params': jax.device_get(grads)}, case.port_cats, case.port_conts,
        case.port_config)
    port = case.port_model()
    logits, _ = port.module(port.to_device(batch), training=True)
    port_loss = losses.binary_crossentropy(logits, torch.from_numpy(y), None)
    port_loss.backward()
    rtol = 1e-4 if dtype == F32 else 1e-2
    np.testing.assert_allclose(float(port_loss.detach()), float(loss),
                               rtol=rtol)
    named = dict(port.module.named_parameters())
    assert set(named) == set(expected)
    assert any(k.startswith('cin_layer.') for k in named)
    for name, param in named.items():
        ref = expected[name].numpy()
        np.testing.assert_allclose(param.grad.numpy(), ref, rtol=rtol,
                                   atol=rtol * float(np.abs(ref).max()),
                                   err_msg=name)


def test_xdeepfm_fit_trajectory_matches_jax():
    pd = pytest.importorskip('pandas')
    case = Case('xdeepfm_nonascending_d16')
    batch = case.batch(80, seed=10)
    columns = {c.name: batch['cat'][:, i]
               for i, c in enumerate(case.port_cats)}
    dense = case.port_conts[0]
    columns.update({name: batch[dense.name][:, i]
                    for i, name in enumerate(dense.column_names)})
    X = pd.DataFrame(columns)
    y = (np.random.default_rng(10).uniform(size=80)
         < 0.3 + 0.4 * (batch['cat'][:, 0] % 2)).astype(np.int64)
    kwargs = dict(batch_size=16, epochs=3, verbose=0)
    jax_history = case.jax_model.fit(X, y, **kwargs)
    port = case.port_model()
    port_history = port.fit(X, y, **kwargs)
    for key in ('loss', 'val_loss', 'val_auc'):
        assert len(port_history.history[key]) == 3
        np.testing.assert_allclose(port_history.history[key],
                                   jax_history.history[key], rtol=1e-4,
                                   err_msg=key)
    expected = bridge.state_dict_from_flax(
        jax.device_get(case.jax_model.variables), case.port_cats,
        case.port_conts, case.port_config)
    for key, value in port.module.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   rtol=0, atol=2e-4, err_msg=key)


@pytest.mark.parametrize('layout', ['auto', 'batch_minor'])
def test_xdeepfm_predictor_matches_jax(layout):
    import types
    case = Case('xdeepfm_nonascending_d8', cin_params={'layout': layout})

    def holder(model):
        return types.SimpleNamespace(task='binary', preprocessor=None,
                                     get_model=lambda selector: model)
    buckets = (1, 8, 64)
    jax_predictor = jax_serving.Predictor(holder(case.jax_model),
                                          batch_buckets=buckets)
    predictor = serving.Predictor(holder(case.port_model()),
                                  batch_buckets=buckets)
    for n in (1, 37, 70):
        arrays = case.batch(n, seed=n)
        np.testing.assert_allclose(
            predictor.predict_proba_arrays(arrays),
            jax_predictor.predict_proba_arrays(arrays), atol=1e-5)
