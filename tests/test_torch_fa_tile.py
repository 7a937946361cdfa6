# -*- coding:utf-8 -*-
"""K5's tile design (``csrc/field_attention.cu``, "K5, the tile design") on
the CPU: which design a shape runs, the tile's plan, and the tile kernels'
order of arithmetic, emulated in PyTorch and held against the Pallas
``field_attention`` of the JAX package and its VJP in interpret mode.

The emulation follows the kernels step by step, in float32 from the
inputs' values:
- the forward in two passes over g: ``m = max_g s_g`` with
  ``s_g = (q·k_g)·scale``, then ``ctx = (Σ_g e_g·v_g)·(1/z)`` with
  ``e_g = exp(s_g − m)``, ``z = Σ_g e_g``, rounded once to the output's
  type;
- the backward's context as the forward's, its weights ``w_g = e_g·(1/z)``
  (a product where the Pallas kernel divides), ``dctx = do``, and
  ``Σ_g w_g·dw_g`` of the score gradient taken as ``do·ctx`` (the same sum,
  one dot product in place of a pass over g); then the Pallas kernel's
  formulas, each gradient rounded once to q's type.

The three type pairs of the kernels: float32; bfloat16; bfloat16 q, k, v
with a float32 output or do (the batch-major layout). The Pallas kernel
takes one type, so the last pair is held against it in float32 on
bfloat16 values, its gradients rounded to bfloat16.

Tolerance: the kernels' own, on the card against their plain versions:
every output within 1e-5 of its largest value, bfloat16 outputs also rtol
1e-2 (their one rounding).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.ops.kernels.field_attention import field_attention
from deeptables_torch.ops.kernels import field_attention as fa

torch.set_num_threads(1)  # the suite runs several xdist workers

B_K, F_K = 128, 7
SHAPES = [(1, 4), (2, 8), (3, 5)]  # (H, dh)
F32, BF16 = torch.float32, torch.bfloat16
PAIRS = [(F32, F32), (BF16, BF16), (BF16, F32)]
PAIR_IDS = ['f32', 'bf16', 'bf16-f32out']


def _heads(t, H):
    B, F, U = t.shape
    return t.float().reshape(B, F, H, U // H).transpose(1, 2)


def _merge(t):
    B, H, F, dh = t.shape
    return t.transpose(1, 2).reshape(B, F, H * dh)


def _softmax_parts(q, k, scale):
    """e_g = exp(s_g − m) and 1/z, the two passes of the tile kernels."""
    s = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e, 1.0 / e.sum(dim=-1, keepdim=True)


def tile_fwd_emulation(q, k, v, H, out_dtype):
    qh, kh, vh = (_heads(t, H) for t in (q, k, v))
    e, rz = _softmax_parts(qh, kh, fa.scale_for(qh.shape[-1]))
    return _merge((e @ vh) * rz).to(out_dtype)


def tile_bwd_emulation(q, k, v, do, H):
    qh, kh, vh, doh = (_heads(t, H) for t in (q, k, v, do))
    scale = fa.scale_for(qh.shape[-1])
    e, rz = _softmax_parts(qh, kh, scale)
    w = e * rz
    ctx = (e @ vh) * rz
    dw = doh @ vh.transpose(-1, -2)
    ds = w * (dw - (doh * ctx).sum(dim=-1, keepdim=True)) * scale
    grads = (ds @ kh, ds.transpose(-1, -2) @ qh, w.transpose(-1, -2) @ doh)
    return tuple(_merge(g).to(q.dtype) for g in grads)


def _operands(H, dh, dtype, out_dtype, seed):
    """q, k, v in dtype, do in out_dtype, from a seeded numpy draw."""
    rng = np.random.default_rng(seed)
    draws = [torch.from_numpy(rng.normal(size=(B_K, F_K, H * dh))
                              .astype(np.float32)) for _ in range(4)]
    return [t.to(dtype) for t in draws[:3]] + [draws[3].to(out_dtype)]


def _jax(t, H, dtype):
    """(B, F, H·dh) torch → the Pallas kernel's (H, F, dh, B) in dtype."""
    B, F, U = t.shape
    a = t.float().numpy().reshape(B, F, H, U // H).transpose(2, 1, 3, 0)
    return jnp.asarray(a, getattr(jnp, str(dtype).split('.')[1]))


def _from_jax(a):
    a = np.array(a, np.float32)
    H, F, dh, B = a.shape
    return torch.from_numpy(a.transpose(3, 1, 0, 2).reshape(B, F, H * dh)
                            .copy())


def _assert_close(actual, expected):
    assert actual.shape == expected.shape and actual.dtype == expected.dtype
    rtol = 1e-2 if actual.dtype == torch.bfloat16 else 0.
    actual, expected = actual.float(), expected.float()
    limit = 1e-5 * float(expected.abs().max()) + rtol * expected.abs()
    err = (actual - expected).abs()
    assert bool((err <= limit).all()), float((err - limit).max())


@pytest.mark.parametrize('dtype,out_dtype', PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize('H,dh', SHAPES)
def test_tile_forward_order_matches_pallas(H, dh, dtype, out_dtype):
    q, k, v, _ = _operands(H, dh, dtype, out_dtype, seed=10 * H + dh)
    # the Pallas kernel's output is in its inputs' type: float32 on the
    # bfloat16 values for a float32 output
    expected = field_attention(*(_jax(t, H, out_dtype) for t in (q, k, v)),
                               1.0 / np.sqrt(dh), True)
    out = tile_fwd_emulation(q, k, v, H, out_dtype)
    assert out.dtype == out_dtype and out.shape == q.shape
    _assert_close(out, _from_jax(expected).to(out_dtype))
    _assert_close(out, fa.fa_fwd_reference(q, k, v, H, out_dtype))


@pytest.mark.parametrize('dtype,out_dtype', PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize('H,dh', SHAPES)
def test_tile_backward_order_matches_pallas_vjp(H, dh, dtype, out_dtype):
    q, k, v, do = _operands(H, dh, dtype, out_dtype, seed=10 * H + dh + 1)
    scale = 1.0 / np.sqrt(dh)
    _, vjp = jax.vjp(lambda a, b, c: field_attention(a, b, c, scale, True),
                     *(_jax(t, H, out_dtype) for t in (q, k, v)))
    expected = vjp(_jax(do, H, out_dtype))
    grads = tile_bwd_emulation(q, k, v, do, H)
    for g, e, ref in zip(grads, expected,
                         fa.fa_bwd_reference(q, k, v, do, H)):
        assert g.dtype == dtype and g.shape == q.shape
        _assert_close(g, _from_jax(e).to(dtype))
        _assert_close(g, ref)


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize('dtype,out_dtype', PAIRS, ids=PAIR_IDS)
def test_autoint_runs_the_tile_design(dtype, out_dtype):
    """AutoInt's blocks (F=22, 2 heads of 8) at any batch."""
    for B in (1, 7, 4096, 8192, 10 ** 6):
        assert fa.fa_design(dtype, out_dtype, B, 22, 2, 8) == 'tile'


@pytest.mark.parametrize('dtype,out_dtype,F,H,dh,design', [
    # heads past the attention's register width run the one-warp kernels
    (F32, F32, 7, 1, 64, 'tile'), (F32, F32, 7, 1, 65, 'warp'),
    (BF16, BF16, 22, 2, 64, 'tile'), (BF16, BF16, 7, 2, 128, 'warp'),
    # the backward's tile (its F x F weights) outgrows shared memory
    (F32, F32, 98, 2, 8, 'tile'), (F32, F32, 99, 2, 8, 'warp'),
    (BF16, F32, 103, 2, 8, 'tile'), (BF16, F32, 104, 2, 8, 'warp'),
    (BF16, BF16, 105, 2, 8, 'tile'), (BF16, BF16, 106, 2, 8, 'warp'),
    # more (head, field) rows than a block's threads
    (BF16, BF16, 200, 3, 8, 'warp'),
    # where K6's tile does not fit, K5's (no projection, no dpre) may
    (F32, F32, 39, 4, 16, 'tile'), (BF16, BF16, 80, 1, 64, 'tile'),
    (F32, F32, 80, 1, 64, 'warp'),
    # odd heads and fields; types the kernels do not take
    (F32, F32, 7, 3, 5, 'tile'), (BF16, BF16, 3, 1, 1, 'tile'),
    (torch.float16, torch.float16, 22, 2, 8, 'warp'),
    (F32, BF16, 22, 2, 8, 'warp'),
])
def test_design_by_shape(dtype, out_dtype, F, H, dh, design):
    assert fa.fa_design(dtype, out_dtype, 8192, F, H, dh) == design


@pytest.mark.parametrize('kind', ['fa_fwd', 'fa_bwd'])
@pytest.mark.parametrize('dtype,out_dtype', PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize('F,H,dh', [(22, 2, 8), (3, 2, 8), (7, 3, 5),
                                    (39, 4, 16), (22, 2, 64), (98, 2, 8)])
def test_tile_plan_fills_a_block_within_shared_memory(kind, dtype, out_dtype,
                                                      F, H, dh):
    """E examples a tile: E·H·F rows within the block's threads (512 up to
    dh = 16, else 256), as many as fill them while two blocks fit an SM,
    and one example at least, within a block's 227 KB."""
    E = fa.fa_tile_examples(kind, dtype, out_dtype, F, H, dh)
    most = 512 if dh <= 16 else 256
    assert E >= 1 and E * H * F <= most
    smem = functools.partial(fa.fa_tile_smem, kind, dtype, out_dtype, F=F,
                             H=H, d_head=dh)
    assert smem(E) <= 232448
    assert E == 1 or smem(E) <= 113 * 1024
    assert (E + 1) * H * F > most or smem(E + 1) > 113 * 1024


def test_tile_plan_at_autoint():
    """AutoInt's plans fill a block within 113 KB in every type pair."""
    plans = {(kind, pair): fa.fa_tile_examples(kind, *pair, 22, 2, 8)
             for kind in ('fa_fwd', 'fa_bwd') for pair in PAIRS}
    assert plans == {('fa_fwd', (F32, F32)): 6, ('fa_fwd', (BF16, BF16)): 9,
                     ('fa_fwd', (BF16, F32)): 9, ('fa_bwd', (F32, F32)): 4,
                     ('fa_bwd', (BF16, BF16)): 5, ('fa_bwd', (BF16, F32)): 5}
    for (kind, pair), E in plans.items():
        assert fa.fa_tile_smem(kind, *pair, E, 22, 2, 8) <= 113 * 1024
    # bytes: two stages of the q, k, v spans, q/k/v in float32 rows of 8,
    # the scores
    assert fa.fa_tile_smem('fa_fwd', BF16, BF16, 9, 22, 2, 8) == (
        2 * 3 * 6352 + 38016 + 36432)
    # ... backward: the stages also hold do, post also dctx, then w and ds
    assert fa.fa_tile_smem('fa_bwd', BF16, BF16, 5, 22, 2, 8) == (
        2 * 4 * 3536 + 28160 + 2 * 20240)
    assert fa.fa_tile_smem('fa_bwd', BF16, F32, 5, 22, 2, 8) == (
        2 * (3 * 3536 + 7056) + 28160 + 2 * 20240)
