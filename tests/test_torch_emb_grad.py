# -*- coding:utf-8 -*-
"""The port's embedding gradient (K1's plain version ``emb_grad_reference``,
the plain twin of the kernel's order ``emb_grad_sorted_reference``, the
wrapper on CPU tensors, and the ``EmbeddingLookup`` autograd Function
behind ``MultiColumnEmbedding``) against the JAX package, on the CPU.

- Against the Pallas kernel ``emb_grad_matmul`` in interpret mode, on its
  lane-packed, TILE_P-aligned layout, unpacked: rtol/atol 2e-2, because the
  TPU kernel multiplies in bfloat16 (as its own test allows).
- The twin against ``emb_grad_reference``: rtol 1e-5 and atol 1e-5 times
  the largest sum of ``|g|`` that meets in one row, as the card tests hold
  the kernel: a segment cut by the kernel's chunks is added as a sum of
  pieces, in another association than ``index_add_``'s single chain. A
  segment that lies in one chunk is summed as ``index_add_`` sums it, so
  where no segment is cut the two agree bit for bit. The twin against
  itself: bit for bit.
- Against ``jax.grad`` of the JAX ``MultiColumnEmbedding`` (on the CPU its
  backward is the XLA scatter), with the JAX table mapped onto the port's
  by the weight bridge: atol 1e-5 (float32 sums in another order), for the
  aligned plan (vocab-ascending fields) and the compact one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.ops.embedding import MultiColumnEmbedding as JaxEmbedding
from deeptables_tpu.ops.embedding import plan_groups
from deeptables_tpu.ops.kernels.emb_grad import TILE_P, emb_grad_matmul
from deeptables_torch import bridge
from deeptables_torch.ops.embedding import MultiColumnEmbedding
from deeptables_torch.ops.kernels.emb_grad import (CHUNK, emb_grad,
                                                   emb_grad_reference,
                                                   emb_grad_sorted_reference)

torch.set_num_threads(1)  # the suite runs several xdist workers

VOCABS = {'aligned': (7, 300, 2500),
          'compact': (7,) * 12 + (300, 2500)}


def _aligned_case(vocabs, dim, b, seed=0):
    """ids/g on the TPU kernel's layout: each column's region starts at a
    multiple of TILE_P packed rows."""
    rng = np.random.default_rng(seed)
    k = 128 // dim
    align = k * TILE_P
    offsets, col_steps, p = [], [], 0
    for j, v in enumerate(vocabs):
        offsets.append(p * k)
        tiles = -(-v // align)
        col_steps.extend((j, p // TILE_P + t) for t in range(tiles))
        p += tiles * TILE_P
    ids = np.stack([rng.integers(0, v, b) for v in vocabs], 1).astype(
        np.int32) + np.asarray(offsets, np.int32)
    g = rng.normal(size=(b, len(vocabs), dim)).astype(np.float32)
    return ids, g, col_steps, p, k


@pytest.mark.parametrize('dim,vocabs,b', [(16, (7, 300, 2500), 64),
                                          (4, (11, 9000), 32),
                                          (32, (5, 1200), 16)])
def test_reference_matches_pallas_kernel(dim, vocabs, b):
    ids, g, col_steps, p, k = _aligned_case(vocabs, dim, b)
    packed = emb_grad_matmul(jnp.asarray(ids), jnp.asarray(g),
                             tuple(col_steps), p, k, dim, interpret=True)
    logical = np.asarray(packed).reshape(p * k, dim)
    flat_ids = torch.from_numpy(ids.reshape(-1))
    flat_g = torch.from_numpy(g.reshape(-1, dim))
    out = emb_grad_reference(flat_ids, flat_g, p * k)
    np.testing.assert_allclose(out.numpy(), logical, rtol=2e-2, atol=2e-2)
    # the wrapper takes the plain version for CPU tensors, and counts no
    # launch
    before = emb_grad.launches
    torch.testing.assert_close(emb_grad(flat_ids, flat_g, p * k), out)
    assert emb_grad.launches == before


@pytest.mark.parametrize('dim,vocabs,b', [(16, (7, 300, 2500), 64),
                                          (4, (11, 9000), 32),
                                          (32, (5, 1200), 16)])
def test_sorted_reference_matches_pallas_kernel(dim, vocabs, b):
    ids, g, col_steps, p, k = _aligned_case(vocabs, dim, b)
    packed = emb_grad_matmul(jnp.asarray(ids), jnp.asarray(g),
                             tuple(col_steps), p, k, dim, interpret=True)
    logical = np.asarray(packed).reshape(p * k, dim)
    out = emb_grad_sorted_reference(torch.from_numpy(ids.reshape(-1)),
                                    torch.from_numpy(g.reshape(-1, dim)),
                                    p * k)
    np.testing.assert_allclose(out.numpy(), logical, rtol=2e-2, atol=2e-2)


def _zipf_case(B, vocabs, D, seed):
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(vocabs)[:-1]])
    ids = np.stack([(rng.zipf(1.2, B) - 1) % v for v in vocabs], axis=1)
    flat = torch.from_numpy((ids + offsets).astype(np.int32).reshape(-1))
    g = torch.from_numpy(rng.normal(size=(len(flat), D)).astype(np.float32))
    return flat, g, int(sum(vocabs))


@pytest.mark.parametrize('B,vocabs,D', [
    (1, (7, 300), 16), (37, (7, 300, 2500), 16), (512, (7, 300, 2500), 16),
    (4093, (7, 300, 2500, 100000), 16), (600, (3,), 33), (257, (1,), 4)])
def test_sorted_reference_matches_reference(B, vocabs, D):
    """Zipf ids, whose top rows take segments of hundreds of entries that
    the chunks cut; one row of one column; a width of 33."""
    ids, g, V = _zipf_case(B, vocabs, D, B + D)
    out = emb_grad_sorted_reference(ids, g, V)
    expected = emb_grad_reference(ids, g, V)
    row_abs = emb_grad_reference(ids, g.abs(), V)
    np.testing.assert_allclose(out.numpy(), expected.numpy(), rtol=1e-5,
                               atol=1e-5 * float(row_abs.max()))
    # every segment that no chunk cuts is summed as index_add_ sums it
    sorted_ids = torch.sort(ids.long(), stable=True).values
    cut = {int(sorted_ids[i]) for i in range(CHUNK, len(ids), CHUNK)
           if sorted_ids[i] == sorted_ids[i - 1]}
    whole = torch.ones(V, dtype=torch.bool)
    whole[sorted(cut)] = False
    assert torch.equal(out[whole], expected[whole])


@pytest.mark.parametrize('B,vocabs,D', [
    (8192, (7, 300, 2500, 100000), 16), (64, (1,), 8)])
def test_sorted_reference_is_bitwise_repeatable(B, vocabs, D):
    ids, g, V = _zipf_case(B, vocabs, D, 5)
    first = emb_grad_sorted_reference(ids, g, V)
    assert torch.equal(first, emb_grad_sorted_reference(ids.clone(),
                                                        g.clone(), V))


def test_sorted_reference_skips_ids_out_of_range():
    ids = torch.tensor([2, -1, 2, 5, 0, 9, 2], dtype=torch.int32)
    g = torch.arange(14, dtype=torch.float32).reshape(7, 2)
    keep = (ids >= 0) & (ids < 5)
    expected = emb_grad_reference(ids[keep], g[keep], 5)
    assert torch.equal(emb_grad_sorted_reference(ids, g, 5, chunk=2),
                       expected)


@pytest.mark.parametrize('plan', sorted(VOCABS))
@pytest.mark.parametrize('dim', [4, 16, 32])
def test_embedding_backward_matches_jax_grad(plan, dim):
    vocabs = VOCABS[plan]
    dims = (dim,) * len(vocabs)
    assert plan_groups(list(vocabs), list(dims))[0][4] == (plan == 'aligned')
    rng = np.random.default_rng(dim)
    B = 48
    ids = np.stack([rng.integers(0, v, B) for v in vocabs],
                   axis=1).astype(np.int32)
    g = rng.normal(size=(B, len(vocabs), dim)).astype(np.float32)

    jax_emb = JaxEmbedding(input_dims=vocabs, output_dims=dims,
                           dropout_rate=0.)
    params = jax_emb.init(jax.random.PRNGKey(0), ids)['params']
    # the JAX stacked fields follow the plan's order
    order = bridge.flax_field_order(vocabs, dims)
    g_plan = g[:, order]

    def loss(p):
        out = jax_emb.apply({'params': p}, ids, training=True)
        return jnp.sum(out.stacked * g_plan)

    grads = jax.grad(loss)(params)
    key = f'embeddings_d{dim}'
    expected = bridge._embedding_tables(jax.device_get(grads), vocabs,
                                        dims)[f'emb_categorical_vars_all.{key}']
    weights = bridge._embedding_tables(jax.device_get(params), vocabs, dims)

    emb = MultiColumnEmbedding(vocabs, dims)
    getattr(emb, key).data.copy_(
        torch.from_numpy(weights[f'emb_categorical_vars_all.{key}']))
    out = emb(torch.from_numpy(ids), training=True)
    np.testing.assert_allclose(
        out.stacked.detach().numpy(),
        np.asarray(jax_emb.apply({'params': params}, ids).stacked)[
            :, np.argsort(order)], atol=1e-6)
    (out.stacked * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(getattr(emb, key).grad.numpy(), expected,
                               rtol=0, atol=1e-5)


def test_function_backward_is_emb_grad_on_two_width_groups():
    vocabs, dims = [50, 7, 300, 20], [8, 16, 8, 16]
    emb = MultiColumnEmbedding(vocabs, dims)
    rng = np.random.default_rng(3)
    ids = np.stack([rng.integers(0, v, 21) for v in vocabs], axis=1)
    out = emb(torch.from_numpy(ids.astype(np.int64)), training=True)
    weights = [rng.normal(size=(21, 1, d)).astype(np.float32) for d in dims]
    sum((e * torch.from_numpy(w)).sum()
        for e, w in zip(out, weights)).backward()
    for dim, cols in ((8, [0, 2]), (16, [1, 3])):
        offsets = np.concatenate([[0], np.cumsum([vocabs[c] for c in cols])])
        flat_ids = np.stack([ids[:, c] + offsets[k]
                             for k, c in enumerate(cols)], axis=1)
        flat_g = np.stack([weights[c][:, 0] for c in cols], axis=1)
        expected = emb_grad_reference(
            torch.from_numpy(flat_ids.reshape(-1)),
            torch.from_numpy(flat_g.reshape(-1, dim)), int(offsets[-1]))
        torch.testing.assert_close(getattr(emb, f'embeddings_d{dim}').grad,
                                   expected, rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_bad_shapes():
    ids = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError):
        emb_grad(ids, torch.zeros(5, 4), 10)
    with pytest.raises(ValueError):
        emb_grad(ids.reshape(2, 3), torch.zeros(6, 4), 10)
    with pytest.raises(ValueError):
        emb_grad(ids, torch.zeros(6, 4), 0)
