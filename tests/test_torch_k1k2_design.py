# -*- coding:utf-8 -*-
"""K1's and K2-fwd's designs (``csrc/emb_grad.cu``, ``csrc/fm.cu``) on the
CPU: which design a shape and an alignment run, and the kernels' order of
arithmetic, emulated and held against the plain twin or the JAX package.

K1 (the sorted segment sum): the kernel's control flow, thread group by
thread group (runs inside a chunk of sorted entries, the two slots a chunk
hands a cut segment's pieces to, the merge by the chunk where the segment
starts), emulated in numpy float32 and held bit for bit against
``emb_grad_sorted_reference``: both add the same float32 values in the
same order. Its two variants (16-byte or 4-byte loads) add the same values
in the same order, so one emulation stands for both.

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
from deeptables_torch.ops.kernels.emb_grad import (CHUNK, emb_grad_design,
                                                   emb_grad_sorted_reference)
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
    assert emb_grad_design(N, 16, V, alignment) == 'segment_v4'


@pytest.mark.parametrize('D', [4, 8, 12, 32, 36, 256])
def test_emb_grad_v4_takes_every_width_of_whole_float4s(D):
    assert emb_grad_design(8192 * 26, D, 324489, 256) == 'segment_v4'


@pytest.mark.parametrize('D,alignment', [
    (1, 256), (2, 256), (6, 256), (33, 256), (13, 16),  # D % 4 != 0
    (16, 4), (16, 8), (4, 4), (32, 8)])                 # g not 16-byte aligned
def test_emb_grad_falls_to_scalar(D, alignment):
    assert emb_grad_design(8192 * 26, D, 324489, alignment) == \
        'segment_scalar'


def _emulate_segment_kernel(ids, g, V, chunk=CHUNK):
    """csrc/emb_grad.cu's segment_kernel and merge_kernel, one thread group
    (a chunk of the sorted entries) after another, in numpy float32."""
    N, D = g.shape
    out = np.zeros((V, D), np.float32)
    if N == 0:
        return out
    s, p = (t.numpy() for t in torch.sort(torch.from_numpy(ids),
                                          stable=True))
    n_chunks = -(-N // chunk)
    partial = np.full((n_chunks, 2, D), np.nan, np.float32)

    def flush(row, acc, from_before, into_after, c):
        if not 0 <= row < V:
            return
        if from_before:
            partial[c, 0] = acc
        elif into_after:
            partial[c, 1] = acc
        else:
            out[row] = acc

    for c in range(n_chunks):
        begin, end = c * chunk, min(c * chunk + chunk, N)
        from_before = begin > 0 and s[begin - 1] == s[begin]
        into_after = end < N and s[end] == s[end - 1]
        row, first, acc = s[begin], True, np.zeros(D, np.float32)
        for i in range(begin, end):
            if s[i] != row:
                flush(row, acc, first and from_before, False, c)
                row, first, acc = s[i], False, np.zeros(D, np.float32)
            acc = acc + g[p[i]]
        flush(row, acc, first and from_before, into_after, c)
    for c in range(n_chunks):
        begin, end = c * chunk, c * chunk + chunk
        if end >= N:
            continue
        row = s[end - 1]
        if s[end] != row or not 0 <= row < V or (begin > 0
                                                 and s[begin - 1] == row):
            continue
        acc, k = partial[c, 1], c + 1
        while k < n_chunks and s[k * chunk] == row:
            acc, k = acc + partial[k, 0], k + 1
        out[row] = acc
    return out


@pytest.mark.parametrize('N,V,D,ids', [
    (1, 5, 4, 'uniform'), (31, 5, 3, 'uniform'), (32, 5, 3, 'uniform'),
    (33, 5, 3, 'uniform'), (64, 1, 4, 'uniform'), (1000, 50, 4, 'zipf'),
    (2000, 300, 16, 'zipf'), (4093, 3, 2, 'uniform'),
    (4000, 1, 16, 'uniform'), (777, 40, 5, 'bad')])
def test_emb_grad_segment_kernel_order_matches_the_twin(N, V, D, ids):
    """Bit for bit: the kernel's runs, slots and merge add the twin's
    float32 values in the twin's order (segments cut by chunks, one row
    over many chunks, a ragged last chunk, ids outside [0, V) skipped)."""
    rng = np.random.default_rng(N + V + D)
    if ids == 'zipf':
        flat = (rng.zipf(1.2, N) - 1) % V
    else:
        flat = rng.integers(0, V, N)
    if ids == 'bad':
        flat[::7], flat[::11] = -3, V + 2
    flat = flat.astype(np.int32)
    g = rng.normal(size=(N, D)).astype(np.float32)
    expected = emb_grad_sorted_reference(torch.from_numpy(flat),
                                         torch.from_numpy(g), V)
    np.testing.assert_array_equal(_emulate_segment_kernel(flat, g, V),
                                  expected.numpy())


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
