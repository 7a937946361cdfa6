# -*- coding:utf-8 -*-
"""FM pooling in the PyTorch port against the JAX package.

The port's plain version and its wrapper (on CPU tensors) are held against
the Pallas kernel ``fm_pallas`` run in interpret mode and against the XLA
``interactions.FM``. Tolerances: float32 rtol 1e-5; bfloat16 rtol 2e-2,
the rounding of a bfloat16 output (the JAX bfloat16 path also rounds its
intermediate sums). Both carry an absolute term of the same relative size
times the largest output, for outputs that cancel to near zero.

The backward (``fm_backward_reference``, and the gradient through
``FMFunction``) is held against ``jax.vjp`` of ``fm_pallas`` (its custom VJP,
the ``_fm_bwd`` kernel in interpret mode) and of the XLA FM: float32 rtol
1e-5, bfloat16 rtol 1e-2 (the JAX kernel sums and multiplies in bfloat16,
the port in float32 with one rounding), each with the same absolute term
times the largest gradient.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.ops.interactions import FM as JaxFM
from deeptables_tpu.ops.kernels.fm import fm_pallas
from deeptables_torch.ops.interactions import FM
from deeptables_torch.ops.kernels.fm import (fm, fm_backward,
                                             fm_backward_reference,
                                             fm_reference)

torch.set_num_threads(1)  # the suite runs several xdist workers

RTOL = {'float32': 1e-5, 'bfloat16': 2e-2}
GRAD_RTOL = {'float32': 1e-5, 'bfloat16': 1e-2}
SHAPES = list(itertools.product((1, 5, 64), (2, 3, 26), (4, 16)))


def _inputs(B, F, D, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=(B, F, D)).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


def _close(actual, expected, dtype, rtols=RTOL):
    actual = np.asarray(actual, dtype=np.float32)
    expected = np.asarray(expected, dtype=np.float32)
    rtol = rtols[dtype]
    np.testing.assert_allclose(actual, expected, rtol=rtol,
                               atol=rtol * float(np.abs(expected).max()))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B,F,D', SHAPES)
def test_wrapper_matches_pallas_kernel(B, F, D, dtype):
    jx, tx = _inputs(B, F, D, dtype)
    expected = fm_pallas(jx, None, True)
    out = fm(tx)
    assert out.shape == (B, 1) and out.dtype == tx.dtype
    _close(out.float().numpy(), expected.astype(jnp.float32), dtype)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B,F,D', [(1, 2, 4), (5, 3, 16), (64, 26, 16)])
def test_module_matches_interactions_fm(B, F, D, dtype):
    jx, tx = _inputs(B, F, D, dtype, seed=1)
    expected = JaxFM().apply({}, jx)
    _close(FM()(tx).float().numpy(), expected.astype(jnp.float32), dtype)
    _close(fm_reference(tx).float().numpy(), expected.astype(jnp.float32),
           dtype)


def test_module_accepts_embedding_list():
    _, tx = _inputs(4, 3, 8, 'float32')
    fields = [tx[:, i:i + 1] for i in range(3)]
    torch.testing.assert_close(FM()(fields), fm(tx))


def test_wrapper_rejects_bad_rank():
    with pytest.raises(ValueError):
        fm(torch.zeros(4, 8))


def test_wrapper_counts_no_launch_on_cpu():
    before = fm.launches
    fm(torch.ones(3, 2, 4))
    assert fm.launches == before


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B,F,D', [(1, 2, 4), (5, 3, 16), (64, 26, 16),
                                   (7, 26, 8)])
def test_backward_matches_jax_grad(B, F, D, dtype):
    jx, tx = _inputs(B, F, D, dtype, seed=2)
    g = np.random.default_rng(3).normal(size=(B, 1)).astype(np.float32)
    jg = jnp.asarray(g, dtype=getattr(jnp, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    _, vjp_pallas = jax.vjp(lambda x: fm_pallas(x, None, True), jx)
    _, vjp_xla = jax.vjp(lambda x: JaxFM().apply({}, x), jx)
    expected = [np.asarray(vjp(jg)[0].astype(jnp.float32))
                for vjp in (vjp_pallas, vjp_xla)]

    xr = tx.clone().requires_grad_(True)
    before = fm.launches, fm_backward.launches
    out = FM()(xr)
    assert out.grad_fn is not None
    out.backward(tg)
    assert (fm.launches, fm_backward.launches) == before  # CPU: no launch
    assert xr.grad.dtype == tx.dtype
    for want in expected:
        _close(xr.grad.float().numpy(), want, dtype, GRAD_RTOL)
        _close(fm_backward_reference(tx, tg).float().numpy(), want, dtype,
               GRAD_RTOL)
        _close(fm_backward(tx, tg).float().numpy(), want, dtype, GRAD_RTOL)


def test_backward_rejects_a_gradient_per_element():
    with pytest.raises(ValueError):
        fm_backward(torch.ones(3, 2, 4), torch.ones(3, 2))
