# -*- coding:utf-8 -*-
"""K1's and K2-fwd's designs (``csrc/emb_grad.cu``, ``csrc/fm.cu``) on the
CPU: which design a shape and an alignment run, and the vec16 kernel's
order of arithmetic, emulated in PyTorch and held against the JAX package.
(K1's v4 design only widens each reduction: the float32 adds into a row
are those of the scalar design, in an order that varies from run to run
in both, so it has no order of its own to emulate.)

vec16: thread (slice, chunk) of an example sums its 16-byte chunk of the
fields slice, slice + slices, ... (Σx for each d, one Σx² over the chunk's
d, float32); the slices' partial sums are combined by a butterfly before
squaring; each chunk forms Σ_d (Σx)² − Σx²; the chunks are combined by a
butterfly; the result is halved and rounded once. Held against
``fm_pallas`` in interpret mode: float32 rtol 1e-5; bfloat16 rtol 1e-2
against the Pallas kernel in float32 on the same bfloat16 values (the JAX
kernel sums in its input's type), both with an absolute term of the same
size times the largest ``Σ_f,d x²`` of a row, as the card tests hold the
kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.ops.kernels.fm import fm_pallas
from deeptables_torch.ops.kernels.emb_grad import emb_grad_design
from deeptables_torch.ops.kernels.fm import (fm, fm_design, fm_vec16_plan,
                                             pointer_alignment)

torch.set_num_threads(1)  # the suite runs several xdist workers

F32, BF16 = torch.float32, torch.bfloat16
# the serving buckets, a ragged batch and the training batch of the main path
MAIN_BATCHES = (1, 37, 4093, 4096, 8192, 10000, 12288)


@pytest.mark.parametrize('dtype,plan', [(F32, (4, 8)), (BF16, (2, 8))])
@pytest.mark.parametrize('B', MAIN_BATCHES)
def test_fm_main_path_runs_vec16(B, dtype, plan):
    """F=26, D=16 at every batch: 16 (bfloat16) or 32 (float32) threads an
    example, three or four fields a thread."""
    assert fm_design(dtype, B, 26, 16, 256) == 'vec16'
    assert fm_design(dtype, B, 26, 16, 16) == 'vec16'
    assert fm_vec16_plan(dtype, 26, 16) == plan


@pytest.mark.parametrize('dtype,F,D,alignment', [
    (BF16, 26, 4, 256),   # a row of 8 bytes
    (F32, 26, 12, 256),   # 3 chunks
    (BF16, 26, 12, 256),  # 24 bytes
    (BF16, 26, 24, 256),  # 3 chunks
    (F32, 26, 33, 256), (BF16, 26, 33, 256),
    (F32, 5, 256, 256),   # 64 chunks, past a warp
    (F32, 26, 16, 4), (BF16, 26, 16, 2), (BF16, 26, 16, 8),
    (torch.float16, 26, 16, 256)])
def test_fm_falls_to_scalar(dtype, F, D, alignment):
    assert fm_design(dtype, 4096, F, D, alignment) == 'scalar'


@pytest.mark.parametrize('dtype,F,D,plan', [
    (BF16, 1, 16, (2, 1)), (BF16, 3, 16, (2, 1)), (F32, 4, 16, (4, 2)),
    (F32, 3, 4, (1, 1)), (BF16, 200, 8, (1, 32)), (F32, 200, 8, (2, 16)),
    (BF16, 5, 256, (32, 1)), (BF16, 2, 64, (8, 1)), (F32, 0, 16, (4, 1)),
    (F32, 22, 16, (4, 8)), (F32, 26, 4, (1, 8))])
def test_fm_vec16_plan(dtype, F, D, plan):
    assert fm_vec16_plan(dtype, F, D) == plan
    chunks, slices = plan
    assert chunks * slices <= 32


# K1's main-path shapes: (N, V) of the criteo schema (DeepFM, xDeepFM: 26
# columns, 324,489 rows) and of AutoInt's avazu schema (22 columns, 725,696
# rows) at their batches
K1_MAIN = [(B * 26, 324489) for B in (1, 37, 64, 512, 4093, 8192)] + [
    (8192 * 22, 725696)]


@pytest.mark.parametrize('N,V', K1_MAIN)
@pytest.mark.parametrize('alignment', [16, 256])
def test_emb_grad_main_path_runs_v4(N, V, alignment):
    assert emb_grad_design(N, 16, V, alignment) == 'v4'


@pytest.mark.parametrize('D', [4, 8, 12, 32, 36, 256])
def test_emb_grad_v4_takes_every_width_of_whole_float4s(D):
    assert emb_grad_design(8192 * 26, D, 324489, 256) == 'v4'


@pytest.mark.parametrize('D,alignment', [
    (1, 256), (2, 256), (6, 256), (33, 256), (13, 16),  # D % 4 != 0
    (16, 4), (16, 8), (4, 4), (32, 8)])                 # g not 16-byte aligned
def test_emb_grad_falls_to_scalar(D, alignment):
    assert emb_grad_design(8192 * 26, D, 324489, alignment) == 'scalar'


def test_pointer_alignment_of_views():
    flat = torch.zeros(1024)
    assert pointer_alignment(flat) >= 16
    assert pointer_alignment(flat[1:]) == 4
    assert pointer_alignment(flat[2:]) == 8
    assert pointer_alignment(flat.bfloat16()[1:]) == 2
    assert pointer_alignment(torch.zeros(0)) >= 16


def _butterfly(t, dim):
    """The xor-shuffle sums over ``dim`` (a power of two): each index ends
    with the sum of all, added pairwise as the kernel's lanes add them."""
    n = t.shape[dim]
    idx = torch.arange(n)
    off = 1
    while off < n:
        t = t + t.index_select(dim, idx ^ off)
        off *= 2
    return t


def fm_vec16_emulated(x: torch.Tensor) -> torch.Tensor:
    """K2-fwd's vec16 order of arithmetic on a (B, F, D) tensor, in float32
    from x's values, rounded once to x's type."""
    B, F, D = x.shape
    chunks, slices = fm_vec16_plan(x.dtype, F, D)
    per = D // chunks
    xf = x.float().reshape(B, F, chunks, per)
    s = torch.zeros(B, slices, chunks, per)
    q = torch.zeros(B, slices, chunks)
    for f in range(F):  # a thread's fields in order, one at a time
        v = xf[:, f]
        s[:, f % slices] += v
        for e in range(per):
            q[:, f % slices] += v[..., e] * v[..., e]
    s, q = _butterfly(s, 1)[:, 0], _butterfly(q, 1)[:, 0]
    sq = torch.zeros(B, chunks)
    for e in range(per):
        sq += s[..., e] * s[..., e]
    partial = _butterfly(sq - q, 1)[:, :1]
    return (0.5 * partial).to(x.dtype)


@pytest.mark.parametrize('dtype,rtol', [(F32, 1e-5), (BF16, 1e-2)])
@pytest.mark.parametrize('B,F,D', [(5, 26, 16), (3, 1, 16), (4, 7, 16),
                                   (2, 200, 8), (3, 5, 128), (4, 4, 64),
                                   (2, 22, 32)])
def test_vec16_order_matches_pallas(B, F, D, dtype, rtol):
    x = np.random.default_rng(B * F + D).normal(size=(B, F, D))
    tx = torch.from_numpy(x.astype(np.float32)).to(dtype)
    values = tx.float().numpy()  # the kernel's input values, exact in f32
    expected = np.asarray(fm_pallas(jnp.asarray(values), None, True))
    out = fm_vec16_emulated(tx)
    assert out.shape == (B, 1) and out.dtype == dtype
    scale = float((values ** 2).sum(axis=(1, 2)).max())
    np.testing.assert_allclose(out.float().numpy(), expected, rtol=rtol,
                               atol=rtol * scale)
    # the wrapper's plain version agrees too (CPU: no launch)
    np.testing.assert_allclose(fm(tx).float().numpy(), expected, rtol=rtol,
                               atol=rtol * scale)
