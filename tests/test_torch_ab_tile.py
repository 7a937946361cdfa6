# -*- coding:utf-8 -*-
"""K6's tile design (``csrc/field_attention.cu``, "K6, the tile design") on
the CPU: which design a shape runs, the tile's plan, and the tile kernels'
order of arithmetic, emulated in PyTorch and held against the Pallas
kernels of the JAX package in interpret mode.

The emulation follows the kernels step by step:
- the projection: bfloat16 x and w_aug as exact float32 products summed in
  float32 (mma.sync); float32 as 3xTF32, ``x·y ≈ lo_x·hi_y + hi_x·lo_y +
  hi_x·hi_y`` with ``hi = tf32(x)`` (to nearest, ties away from zero, as the
  card's ``cvt.rna``) and ``lo = tf32(x − hi)``, summed in that order; the
  bias added in float32, then relu;
- the forward softmax in two passes with no F×F buffer: ``m = max_g s_g``,
  then ``ctx = (Σ_g e_g·v_g)·(1/z)`` with ``e_g = exp(s_g − m)``,
  ``z = Σ_g e_g``;
- the backward's context as the forward's, its weights ``w_g = e_g·(1/z)``
  (a product where the Pallas kernel divides), and ``Σ_g w_g·dw_g`` of the
  score gradient taken as ``dctx·ctx`` (the same sum, one dot product in
  place of a pass over g); then the Pallas kernel's formulas.

Tolerance: the kernels' own, on the card against their plain versions:
every output within 1e-5 of its largest value, bfloat16 outputs also rtol
1e-2 (their one rounding). K6's backward leaves out the examples with a
projection within 1e-5 of 0 (``ab_mask_margin``), as the card tests do.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deeptables_tpu.ops.kernels import field_attention as jfa
from deeptables_torch.ops.kernels import field_attention as fa

torch.set_num_threads(1)  # the suite runs several xdist workers

B_K, F_K = 128, 7
SHAPES = [(1, 4), (2, 8), (3, 5)]  # (H, dh)
MARGIN = 1e-5


def _tf32(t):
    """float32 → the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(t):
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _project(x, w_aug):
    """(B, F, 4U) float32 pre-activations as the tile kernels form them."""
    U = x.shape[-1]
    w = w_aug.to(x.dtype).float()
    xf = x.float()
    if x.dtype == torch.bfloat16:
        acc = xf @ w[:U]
    else:
        (xh, xl), (wh, wl) = _split(xf), _split(w[:U])
        acc = xl @ wh
        acc = acc + xh @ wl
        acc = acc + xh @ wh
    return acc + w[U]


def _heads(t, H):
    B, F, U = t.shape
    return t.reshape(B, F, H, U // H).transpose(1, 2)


def _merge(t):
    B, H, F, dh = t.shape
    return t.transpose(1, 2).reshape(B, F, H * dh)


def _softmax_parts(q, k, scale):
    s = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e, 1.0 / e.sum(dim=-1, keepdim=True)


def tile_fwd_emulation(x, w_aug, H):
    U = x.shape[-1]
    post = torch.relu(_project(x, w_aug))
    q, k, v, r = (_heads(post[..., i * U:(i + 1) * U], H) for i in range(4))
    e, rz = _softmax_parts(q, k, fa.scale_for(U // H))
    ctx = (e @ v) * rz
    return _merge(torch.relu(ctx + r)).to(x.dtype)


def tile_bwd_emulation(x, w_aug, do, H):
    U = x.shape[-1]
    scale = fa.scale_for(U // H)
    pre = _project(x, w_aug)
    post = torch.relu(pre)
    q, k, v, r = (_heads(post[..., i * U:(i + 1) * U], H) for i in range(4))
    e, rz = _softmax_parts(q, k, scale)
    w = e * rz
    ctx = (e @ v) * rz
    zero = torch.zeros(())
    dctx = torch.where(ctx + r > 0, _heads(do.float(), H), zero)
    dw = dctx @ v.transpose(-1, -2)
    ds = w * (dw - (dctx * ctx).sum(dim=-1, keepdim=True)) * scale
    dpost = torch.cat([_merge(t) for t in (ds @ k, ds.transpose(-1, -2) @ q,
                                           w.transpose(-1, -2) @ dctx,
                                           dctx)], dim=-1)
    return torch.where(pre > 0, dpost, zero).to(x.dtype)


def _operands(H, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    U = H * dh
    x = rng.normal(size=(B_K, F_K, U)).astype(np.float32)
    w = rng.normal(0., 0.6, size=(U + 1, 4 * U)).astype(np.float32)
    do = rng.normal(size=(B_K, F_K, U)).astype(np.float32)
    t = getattr(torch, dtype)
    return (torch.from_numpy(x).to(t), torch.from_numpy(w).to(t),
            torch.from_numpy(do).to(t))


def _jax(t):
    """(B, F, U) torch → the JAX block's (U, F, B)."""
    dtype = getattr(jnp, str(t.dtype).split('.')[1])
    return jnp.asarray(t.float().numpy().transpose(2, 1, 0), dtype)


def _from_jax(a):
    a = np.array(a, np.float32).transpose(2, 1, 0)
    return torch.from_numpy(a.copy())


def _assert_close(actual, expected, keep=None):
    if keep is not None:
        actual, expected = actual[keep], expected[keep]
    rtol = 1e-2 if actual.dtype == torch.bfloat16 else 0.
    actual, expected = actual.float(), expected.float()
    limit = 1e-5 * float(expected.abs().max()) + rtol * expected.abs()
    err = (actual - expected).abs()
    assert bool((err <= limit).all()), float((err - limit).max())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_3xtf32_split_gives_float32_products(seed):
    """The float32 projection's premise: hi + lo keeps x to 2⁻²² of
    itself, and the three TF32 products give x·y to 2⁻²⁰ of itself (the
    dropped lo·lo is ~2⁻²²), magnitudes 1e-6 to 1e6, both signs."""
    rng = np.random.default_rng(seed)

    def values(n):
        mags = 10.0 ** rng.uniform(-6, 6, n)
        return torch.from_numpy(mags * rng.choice([-1.0, 1.0], n)).float()
    x, y = values(100_000), values(100_000)
    (xh, xl), (yh, yl) = _split(x), _split(y)
    assert not (xh.view(torch.int32) & 0x1FFF).any()  # TF32: 10 bits
    assert not (xl.view(torch.int32) & 0x1FFF).any()
    rel = ((xh.double() + xl.double()) - x.double()).abs() / x.double().abs()
    assert float(rel.max()) <= 2.0 ** -22
    three = xl.double() * yh.double() + xh.double() * yl.double() \
        + xh.double() * yh.double()
    exact = x.double() * y.double()
    assert float(((three - exact).abs() / exact.abs()).max()) <= 2.0 ** -20


def test_tf32_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0])
    ulp = 2.0 ** -10  # TF32's step at 1
    cases = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23,
                          -(1 + ulp / 2), 1 + 3 * ulp / 2])
    assert torch.equal(_tf32(cases), torch.tensor(
        [1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp]))
    assert torch.equal(_tf32(one), one)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('H,dh', SHAPES)
def test_tile_forward_order_matches_pallas(H, dh, dtype):
    x, w, _ = _operands(H, dh, dtype, seed=10 * H + dh)
    expected = jfa.attention_block(_jax(x), jnp.asarray(w.float().numpy()),
                                   1.0 / np.sqrt(dh), H, dh, True)
    out = tile_fwd_emulation(x, w, H)
    assert out.dtype == x.dtype
    _assert_close(out, _from_jax(expected).to(x.dtype))
    _assert_close(out, fa.ab_fwd_reference(x, w, H))


def _pallas_dpre(x, w, do, H, dh):
    """dpre of the Pallas backward kernel in interpret mode, one block."""
    U = H * dh
    jx = _jax(x)
    kernel = functools.partial(jfa._ab_bwd_kernel, scale=1.0 / np.sqrt(dh),
                               H=H, dh=dh)
    dpre = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((4 * U,) + jx.shape[1:],
                                               jx.dtype),
        interpret=True)(jx, jnp.asarray(w.float().numpy(), jx.dtype),
                        _jax(do))
    return _from_jax(dpre).to(x.dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('H,dh', SHAPES)
def test_tile_backward_order_matches_pallas(H, dh, dtype):
    x, w, do = _operands(H, dh, dtype, seed=10 * H + dh + 1)
    dpre = tile_bwd_emulation(x, w, do, H)
    assert dpre.shape == (B_K, F_K, 4 * H * dh) and dpre.dtype == x.dtype
    keep = fa.ab_mask_margin(x, w, H) >= MARGIN
    assert int(keep.sum()) >= B_K / 2
    _assert_close(dpre, _pallas_dpre(x, w, do, H, dh), keep)
    _assert_close(dpre, fa.ab_bwd_reference(x, w, do, H), keep)


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_autoint_runs_the_tile_design(dtype):
    """AutoInt's blocks (F=22, 2 heads of 8) at any batch."""
    for B in (1, 7, 4096, 8192, 10 ** 6):
        assert fa.ab_design(dtype, B, 22, 2, 8) == 'tile'


@pytest.mark.parametrize('dtype,F,H,dh,design', [
    # U past 64 runs the one-warp kernels
    (torch.bfloat16, 22, 1, 64, 'tile'), (torch.bfloat16, 22, 1, 72, 'warp'),
    (torch.float32, 22, 1, 64, 'tile'), (torch.float32, 22, 2, 64, 'warp'),
    (torch.float32, 7, 1, 128, 'warp'),
    # the backward's tile (its F x F weights) outgrows shared memory
    (torch.bfloat16, 104, 2, 8, 'tile'), (torch.bfloat16, 105, 2, 8, 'warp'),
    (torch.float32, 97, 2, 8, 'tile'), (torch.float32, 98, 2, 8, 'warp'),
    (torch.float32, 38, 4, 16, 'tile'), (torch.float32, 39, 4, 16, 'warp'),
    (torch.bfloat16, 39, 4, 16, 'tile'),
    # odd heads and fields
    (torch.float32, 7, 3, 5, 'tile'), (torch.bfloat16, 3, 1, 1, 'tile'),
    (torch.float16, 22, 2, 8, 'warp'),
])
def test_design_by_shape(dtype, F, H, dh, design):
    assert fa.ab_design(dtype, 8192, F, H, dh) == design


@pytest.mark.parametrize('kind', ['ab_fwd', 'ab_bwd'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('F,H,dh', [(22, 2, 8), (3, 2, 8), (7, 3, 5),
                                    (39, 1, 16), (22, 1, 64), (38, 4, 16)])
def test_tile_plan_fills_a_block_within_shared_memory(kind, dtype, F, H, dh):
    """E examples a tile: E·H·F rows within the block's threads (512 up to
    dh = 16, else 256), as many as fill them while two blocks fit an SM,
    and one example at least, within a block's 227 KB."""
    E = fa.ab_tile_examples(kind, dtype, F, H, dh)
    most = 512 if dh <= 16 else 256
    assert E >= 1 and E * H * F <= most
    smem = functools.partial(fa.ab_tile_smem, kind, dtype, F=F, H=H,
                             d_head=dh)
    assert smem(E) <= 232448
    assert E == 1 or smem(E) <= 113 * 1024
    assert (E + 1) * H * F > most or smem(E + 1) > 113 * 1024


def test_tile_plan_at_autoint():
    plans = {(kind, dtype): fa.ab_tile_examples(kind, dtype, 22, 2, 8)
             for kind in ('ab_fwd', 'ab_bwd')
             for dtype in (torch.float32, torch.bfloat16)}
    assert plans == {('ab_fwd', torch.float32): 11,
                     ('ab_fwd', torch.bfloat16): 11,
                     ('ab_bwd', torch.float32): 4,
                     ('ab_bwd', torch.bfloat16): 5}
    # bytes: w_aug and its 64 columns' offsets, two input stages, q/k/v/r,
    # weights and ds, the output
    assert fa.ab_tile_smem('ab_fwd', torch.bfloat16, 11, 22, 2, 8) == (
        2304 + 256 + 2 * 7760 + 61952 + 7760)
    assert fa.ab_tile_smem('ab_bwd', torch.bfloat16, 5, 22, 2, 8) == (
        2304 + 256 + 4 * 3536 + 28160 + 2 * 20240 + 14096)
