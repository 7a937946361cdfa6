# -*- coding:utf-8 -*-
"""The port's deterministic backward of the zoo (ROADMAP Queue 3 item 8):
the pair gather whose backward sums each field's slots by one matrix
product (``interactions.GatherFields``), and FGCNN's convolution as an
im2col product (``layers.Conv2d``), held against what they replace.

Tolerances (float32 throughout):
- the pair gather's gradient against autograd's ``index_select`` gradient:
  rtol 1e-6, atol 1e-6 (the same float32 terms, summed in another order);
  the forward is ``index_select`` itself, bit for bit;
- the im2col convolution against ``F.conv2d`` and against flax's
  ``nn.Conv(padding='SAME')``, outputs and gradients: rtol 1e-5, atol 1e-5
  (the same products summed in another order).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeptables_torch.ops import interactions, layers


def _x(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
        .to(dtype)


@pytest.mark.parametrize('n_fields', [2, 5, 26])
@pytest.mark.parametrize('which', ['row', 'col'])
def test_pair_gather_gradient_equals_index_select_gradient(n_fields, which):
    pairs = interactions._Pairs(n_fields)
    x = _x((7, n_fields, 4), n_fields).requires_grad_(True)
    g = _x((7, pairs.n_pairs, 4), 100 + n_fields)
    out = pairs.gather(x, which)
    index = getattr(pairs, which)
    assert torch.equal(out, x.index_select(1, index))
    (dx,) = torch.autograd.grad(out, x, g)
    x_ref = x.detach().clone().requires_grad_(True)
    (dx_ref,) = torch.autograd.grad(x_ref.index_select(1, index), x_ref, g)
    np.testing.assert_allclose(dx.numpy(), dx_ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_pair_gather_of_fewer_fields_than_its_incidence():
    """FiBiNet's ``field_each`` reads the row fields of an (B, F − 1, D)
    tensor with the pairs of F fields."""
    n_fields = 6
    pairs = interactions._Pairs(n_fields)
    x = _x((3, n_fields - 1, 4), 7).requires_grad_(True)
    g = _x((3, pairs.n_pairs, 4), 8)
    (dx,) = torch.autograd.grad(pairs.gather(x, 'row'), x, g)
    x_ref = x.detach().clone().requires_grad_(True)
    (dx_ref,) = torch.autograd.grad(x_ref.index_select(1, pairs.row), x_ref,
                                    g)
    assert dx.shape == x.shape
    np.testing.assert_allclose(dx.numpy(), dx_ref.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_pair_gather_keeps_the_input_type():
    pairs = interactions._Pairs(5)
    x = _x((3, 5, 4), 9, torch.bfloat16).requires_grad_(True)
    p, q = pairs.pair(x)
    (p * q).sum().backward()
    assert p.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize('kernel', [(7, 1), (3, 1), (2, 3)])
@pytest.mark.parametrize('in_ch', [1, 3])
def test_im2col_conv_equals_conv2d_and_flax(kernel, in_ch):
    B, H, W, out_ch = 4, 9, 5, 6
    gen = torch.Generator().manual_seed(3)
    conv = layers.Conv2d(in_ch, out_ch, kernel, kernel_init='glorot_uniform',
                         generator=gen)
    with torch.no_grad():
        conv.bias.copy_(_x((out_ch,), 4))
    x = _x((B, H, W, in_ch), 5).requires_grad_(True)
    dy = _x((B, H, W, out_ch), 6)
    y = conv(x)
    dx, dw, db = torch.autograd.grad(y, (x, conv.weight, conv.bias), dy)

    # F.conv2d on NCHW with XLA's SAME pads
    kh, kw = kernel
    top, bottom = layers.same_pads(H, kh)
    left, right = layers.same_pads(W, kw)
    x_ref = x.detach().clone().requires_grad_(True)
    w_ref = conv.weight.detach().clone().requires_grad_(True)
    b_ref = conv.bias.detach().clone().requires_grad_(True)
    y_ref = F.conv2d(F.pad(x_ref.permute(0, 3, 1, 2),
                           (left, right, top, bottom)), w_ref, b_ref)
    y_ref = y_ref.permute(0, 2, 3, 1)
    ref = torch.autograd.grad(y_ref, (x_ref, w_ref, b_ref), dy)
    for got, want in zip((y, dx, dw, db), (y_ref,) + ref):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)

    # flax's nn.Conv with the same kernel, (kh, kw, in, out)
    module = fnn.Conv(out_ch, kernel, padding='SAME')
    params = {'kernel': jnp.asarray(
        conv.weight.detach().permute(2, 3, 1, 0).numpy()),
        'bias': jnp.asarray(conv.bias.detach().numpy())}

    def apply(p, xx):
        return module.apply({'params': p}, xx)

    xj = jnp.asarray(x.detach().numpy())
    yj, vjp = jax.vjp(apply, params, xj)
    gp, gx = vjp(jnp.asarray(dy.numpy()))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(),
                               np.asarray(gp['kernel']), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(db.numpy(), np.asarray(gp['bias']),
                               rtol=1e-5, atol=1e-5)
