# -*- coding:utf-8 -*-
"""The port's interaction blocks (``deeptables_torch/ops/interactions.py``)
against the JAX package's flax layers, on the CPU: ``Cross``,
``InnerProduct``, ``OuterProduct`` (mat, vec, num), ``AFM``, ``SENET``
(mean, max), ``BilinearInteraction`` (field_all, field_each,
field_interaction) and ``FGCNN``, each with the flax layer's parameters
copied in, on inputs from a numpy seed: the output, and the gradients of
``Σ output·g`` (g from the seed) with respect to the input and every
parameter.

Tolerances: float32 outputs rtol 1e-5 with an absolute term of 1e-6 times
the largest output; gradients rtol 1e-4 with 1e-5 times the largest
gradient of the tensor (only the order of float32 sums differs, over longer
chains in the backward). bfloat16 inputs (where the block keeps their type
in part): rtol 1e-2 and 1e-2 of the largest value, as the two frameworks
round bfloat16 products at other places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.ops import interactions as jax_layers
from deeptables_torch.ops import interactions, layers

F32, BF16 = 'float32', 'bfloat16'


def _close(actual, expected, rtol, atol_of_max, what):
    actual = np.asarray(torch.as_tensor(actual).float(), np.float32)
    expected = np.asarray(jnp.asarray(expected, jnp.float32))
    assert actual.shape == expected.shape, what
    scale = float(np.abs(expected).max()) if expected.size else 0.
    np.testing.assert_allclose(actual, expected, rtol=rtol,
                               atol=atol_of_max * scale, err_msg=what)


def _flat(tree, prefix=''):
    out = {}
    for key, value in tree.items():
        path = f'{prefix}{key}'
        if isinstance(value, dict):
            out.update(_flat(value, path + '/'))
        else:
            out[path] = value
    return out


def run_both(flax_layer, port_layer, to_port, x, dtype=F32, seed=1,
             flax_kwargs=None, port_kwargs=None, outputs=lambda o: o):
    """Init the flax layer on x, copy its parameters into the port layer
    (``to_port``: flax path → (port parameter name, transform)), and compare
    outputs and gradients."""
    jx = jnp.asarray(x, getattr(jnp, dtype))
    params = jax.jit(lambda inp: flax_layer.init(
        jax.random.PRNGKey(0), inp, **(flax_kwargs or {})))(jx).get(
            'params', {})
    params = jax.tree_util.tree_map(np.array, params)
    flat = _flat(params)
    state = {}
    for path, value in flat.items():
        name, transform = to_port[path]
        state[name] = torch.from_numpy(np.ascontiguousarray(
            transform(value)))
    missing = port_layer.load_state_dict(state, strict=False)
    assert not missing.unexpected_keys, missing
    assert set(dict(port_layer.named_parameters())) == set(state)

    def f(p, inp):
        return outputs(flax_layer.apply({'params': p}, inp,
                                        **(flax_kwargs or {})))
    expected, vjp = jax.vjp(jax.jit(f), params, jx)
    rng = np.random.default_rng(seed)
    gs = jax.tree_util.tree_map(
        lambda e: rng.normal(size=e.shape).astype(np.float32), expected)
    dparams, dx = vjp(jax.tree_util.tree_map(
        lambda g, e: jnp.asarray(g, e.dtype), gs, expected))

    tx = torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, dtype)).requires_grad_(True)
    got = outputs(port_layer(tx, **(port_kwargs or {})))
    got_list = list(got) if isinstance(got, tuple) else [got]
    exp_list = list(expected) if isinstance(expected, tuple) else [expected]
    g_list = list(gs) if isinstance(gs, tuple) else [gs]
    out_tol = (1e-5, 1e-6) if dtype == F32 else (1e-2, 1e-2)
    grad_tol = (1e-4, 1e-5) if dtype == F32 else (1e-2, 1e-2)
    for i, (a, e) in enumerate(zip(got_list, exp_list)):
        assert a.dtype == getattr(torch, str(e.dtype)), (a.dtype, e.dtype)
        _close(a.detach(), e, *out_tol, f'output {i}')
    torch.autograd.backward(got_list, [torch.from_numpy(g).to(a.dtype)
                                       for g, a in zip(g_list, got_list)])
    _close(tx.grad, dx, *grad_tol, 'dx')
    named = dict(port_layer.named_parameters())
    for path, value in _flat(dparams).items():
        name, transform = to_port[path]
        _close(named[name].grad, transform(np.asarray(value)), *grad_tol,
               path)


def _same(name):
    return name, lambda v: v


def _dense(scope, prefix=''):
    """flax Dense ``scope/kernel`` (in, out), ``scope/bias`` → the port's
    ``weight`` (out, in) and ``bias``."""
    return {f'{prefix}{scope}/kernel': (f'{scope}.weight', lambda v: v.T),
            f'{prefix}{scope}/bias': (f'{scope}.bias', lambda v: v)}


def _fields(B, F, D, seed=0, scale=1.0):
    return np.random.default_rng(seed).normal(
        0, scale, (B, F, D)).astype(np.float32)


@pytest.mark.parametrize('n,layers_', [(7, 2), (40, 4)])
def test_cross_matches_flax(n, layers_):
    params = {'num_cross_layer': layers_}
    to_port = {}
    for i in range(layers_):
        to_port[f'kernels_{i}'] = _same(f'kernels_{i}')
        to_port[f'bias_{i}'] = _same(f'bias_{i}')
    x = np.random.default_rng(2).normal(size=(16, n)).astype(np.float32)
    flax_layer = jax_layers.Cross(params=params)
    run_both(flax_layer, interactions.Cross(n, params), to_port, x)


def test_cross_default_has_two_layers_and_promotes_bfloat16():
    cross = interactions.Cross(5, {})
    assert [n for n, _ in cross.named_parameters()] == [
        'kernels_0', 'bias_0', 'kernels_1', 'bias_1']
    out = cross(torch.ones(3, 5, dtype=torch.bfloat16))
    assert out.dtype == torch.float32


@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('F', [2, 5])
def test_inner_product_matches_flax(F, dtype):
    run_both(jax_layers.InnerProduct(), interactions.InnerProduct(F), {},
             _fields(12, F, 4), dtype)


def test_pair_indices_match_jax():
    for F in (0, 1, 2, 6, 13):
        for a, b in zip(interactions._pair_indices(F),
                        jax_layers._pair_indices(F)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('kernel_type', ['mat', 'vec', 'num'])
@pytest.mark.parametrize('dtype', [F32, BF16])
def test_outer_product_matches_flax(kernel_type, dtype):
    params = {'outer_product_kernel_type': kernel_type}
    F, D = 5, 4
    run_both(jax_layers.OuterProduct(params=params),
             interactions.OuterProduct(F, D, params),
             {'kernel': _same('kernel')}, _fields(12, F, D), dtype)


def test_outer_product_rejects_unknown_kernel_type():
    with pytest.raises(ValueError, match='mat,vec or num'):
        interactions.OuterProduct(3, 4, {'outer_product_kernel_type': 'x'})


@pytest.mark.parametrize('params', [
    {'attention_factor': 4, 'dropout_rate': 0},
    # hidden_factor wins over attention_factor, as in the JAX package
    {'hidden_factor': 6, 'attention_factor': 3, 'activation': 'tanh'}],
    ids=['attention_factor', 'hidden_factor'])
@pytest.mark.parametrize('dtype', [F32, BF16])
def test_afm_matches_flax(params, dtype):
    F, D = 5, 4
    to_port = {**_dense('dense_afm_attention'), **_dense('dense_out'),
               'projection_h': _same('projection_h')}
    to_port.pop('dense_out/bias')
    port = interactions.AFM(F, D, params)
    hidden = params.get('hidden_factor', params.get('attention_factor'))
    assert port.projection_h.shape == (hidden, 1)
    run_both(jax_layers.AFM(params=params), port, to_port,
             _fields(12, F, D), dtype)


def test_afm_dropout_drops_the_pooled_vector_in_training_only():
    port = interactions.AFM(4, 8, {'attention_factor': 4,
                                   'dropout_rate': 0.5})
    x = torch.from_numpy(_fields(64, 4, 8))
    eval_out = port(x)
    assert torch.equal(eval_out, port(x, training=False))
    gen = torch.Generator().manual_seed(0)
    train_out = port(x, training=True, generator=gen)
    assert not torch.allclose(train_out, eval_out)


@pytest.mark.parametrize('pooling', ['mean', 'max'])
@pytest.mark.parametrize('dtype', [F32, BF16])
def test_senet_matches_flax(pooling, dtype):
    F, D = 7, 4
    to_port = {**_dense('dense_att1'), **_dense('dense_att2')}
    run_both(jax_layers.SENET(pooling_op=pooling, reduction_ratio=3),
             interactions.SENET(F, pooling, 3), to_port,
             _fields(12, F, D, scale=2.0), dtype)


@pytest.mark.parametrize('bilinear_type', ['field_all', 'field_each',
                                           'field_interaction'])
@pytest.mark.parametrize('dtype', [F32, BF16])
def test_bilinear_interaction_matches_flax(bilinear_type, dtype):
    F, D = 5, 4
    run_both(jax_layers.BilinearInteraction(bilinear_type=bilinear_type),
             interactions.BilinearInteraction(F, D, bilinear_type),
             {'bilinear_weight': _same('bilinear_weight')},
             _fields(12, F, D), dtype)


def _fgcnn_to_port():
    return {'conv2d/kernel': ('conv2d.weight',
                              lambda v: v.transpose(3, 2, 0, 1)),
            'conv2d/bias': _same('conv2d.bias'),
            **_dense('dense_output')}


# (F, E, C, filters, kernel height, new filters, pool): odd and even
# kernel heights, pools over field counts they do not divide (SAME pads
# the end), a kernel taller than the fields, and the criteo stage 0
@pytest.mark.parametrize('F,E,C,filters,height,new,pool', [
    (5, 4, 1, 3, 3, 2, 2), (6, 3, 2, 4, 2, 1, 4), (4, 2, 3, 2, 7, 2, 3),
    (26, 16, 1, 14, 7, 2, 2)])
def test_fgcnn_stage_matches_flax(F, E, C, filters, height, new, pool):
    x = np.random.default_rng(3).normal(size=(6, F, E, C)).astype(np.float32)
    flax_layer = jax_layers.FGCNN(filters=filters, kernel_height=height,
                                  new_filters=new, pool_height=pool)
    port = interactions.FGCNN(F, E, C, filters, height, new, pool)
    run_both(flax_layer, port, _fgcnn_to_port(), x)
    pooled, feats = port(torch.from_numpy(x))
    assert pooled.shape == (6, -(-F // pool), E, filters)
    assert feats.shape == (6, F * new, E)


def test_fgcnn_stage_promotes_bfloat16_fields():
    port = interactions.FGCNN(5, 4, 1, 3, 3, 2, 2)
    pooled, new = port(torch.ones(2, 5, 4, 1, dtype=torch.bfloat16))
    assert pooled.dtype == new.dtype == torch.float32


@pytest.mark.parametrize('size,window,stride', [(13, 2, 2), (13, 3, 3),
                                                (7, 7, 1), (6, 2, 1),
                                                (4, 7, 1)])
def test_same_pads_give_ceil_outputs(size, window, stride):
    low, high = layers.same_pads(size, window, stride)
    total = low + high
    assert high - low in (0, 1)
    assert (size + total - window) // stride + 1 == -(-size // stride)
    from jax import lax
    assert [(low, high)] == lax.padtype_to_pads((size,), (window,),
                                                (stride,), 'SAME')
