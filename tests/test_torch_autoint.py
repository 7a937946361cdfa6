# -*- coding:utf-8 -*-
"""The port's AutoInt (``deeptables_torch.ops.kernels.field_attention``,
``ops/attention_grad.py``, ``ops/interactions.MultiheadAttention``,
``autoint_nets``) against the JAX package, on the CPU.

- The plain versions of K5 and K6 against the Pallas kernels in interpret
  mode (``field_attention``, ``attention_block`` and their custom VJPs) at
  F=7, B=128, (H, dh) = (1, 4) and (2, 8). float32: rtol 1e-4 with 1e-4 of
  the tensor's largest value (float32 sums in another order). bfloat16:
  2⁻⁶ of the tensor's largest value and rtol 2⁻⁷: both sides compute in
  float32 from the same bfloat16 inputs and round each output once, so two
  roundings of neighbouring values may land one bfloat16 step apart, and
  the K6 weight gradient sums such steps over B·F rows.
- ``MultiheadAttention`` against the flax module with the same weights, in
  both layouts and on the fused path, BatchNorm in training and in eval:
  output, running statistics and the gradients of x and every weight under
  one fixed cotangent. On the CPU the JAX module never runs its kernels (it
  gates them on a TPU backend) and takes its XLA formulation, whose math
  and rounding points are those of K5. float32 rtol 1e-4 with 1e-4 of the
  largest value. bfloat16 (a block fed bfloat16 x, as the first block of a
  bfloat16 model): 2⁻⁶ of the largest value, 2⁻⁴ for the weights'
  gradients; the XLA formulation rounds each q·k product, and in its
  backward the score gradient, to bfloat16, where the kernels' plain
  versions keep them in float32, and a weight's gradient sums B·F such
  rows. The fused path keeps q, k, v, r in float32 where the
  flax module rounds them to bfloat16, so at bfloat16 it is held to
  ``attention_block_oracle`` plus flax's BatchNorm at 2⁻⁶ of the largest
  value, and to the flax module in float32.
- A bridged AutoInt ``DeepModel`` (non-ascending vocabularies, 2 blocks, 2
  heads, no dense columns, as the avazu schema): taps and logits, one train
  step's gradients, a short ``fit`` and ``Predictor`` output, under both
  policies (float32 rtol 1e-4 with 1e-4 of the largest gradient; bfloat16
  rtol 1e-2, and for gradients 2⁻⁴ of the largest, since the first
  block's weights see the bfloat16 roundings of the module test).
"""

import hashlib
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu import serving as jax_serving
from deeptables_tpu.ops import interactions as jax_interactions
from deeptables_tpu.ops import losses as jax_losses
from deeptables_tpu.ops.kernels.field_attention import (
    attention_block, attention_block_oracle, field_attention)
from deeptables_torch import bridge, serving
from deeptables_torch.models.config import ModelConfig
from deeptables_torch.models.deepmodel import DeepModel
from deeptables_torch.models.metainfo import CategoricalColumn
from deeptables_torch.ops import attention_grad, losses
from deeptables_torch.ops.interactions import MultiheadAttention
from deeptables_torch.ops.kernels.field_attention import (
    ab_bwd, ab_bwd_reference, ab_fwd, ab_fwd_reference, fa_bwd,
    fa_bwd_reference, fa_fwd, fa_fwd_reference)
from perfbench.harness import inputs, port, spec as spec_lib, weights
from perfbench.reference import model as bench_ref
from torch_parity import Case

torch.set_num_threads(1)  # the suite runs several xdist workers

F32, BF16 = 'float32', 'bfloat16'
BF16_TOL = 2.0 ** -6
# a weight's gradient in a bfloat16 block sums B·F rows that each went
# through bfloat16 roundings at other places in the two frameworks
BF16_PARAM_GRAD_TOL = 2.0 ** -4


def _close(actual, expected, dtype, name='', bf16_tol=BF16_TOL):
    actual = np.asarray(actual, np.float32)
    expected = np.asarray(expected, np.float32)
    assert actual.shape == expected.shape, name
    scale = float(np.abs(expected).max())
    if dtype == F32:
        np.testing.assert_allclose(actual, expected, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    else:
        np.testing.assert_allclose(actual, expected, rtol=2.0 ** -7,
                                   atol=bf16_tol * scale, err_msg=name)


# ---------------------------------------------------------------- kernels

KERNEL_SHAPES = [(1, 4), (2, 8)]  # (H, dh)
B_K, F_K = 128, 7


def _jax_heads(t, H):
    """(B, F, H·dh) numpy → the JAX kernels' (H, F, dh, B)."""
    B, F, U = t.shape
    return t.reshape(B, F, H, U // H).transpose(2, 1, 3, 0)


def _from_jax_heads(a):
    a = np.asarray(a, np.float32)
    H, F, dh, B = a.shape
    return a.transpose(3, 1, 0, 2).reshape(B, F, H * dh)


def _bf16(a):
    """numpy float32 values that are exact in bfloat16."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _qkv(H, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=(B_K, F_K, H * dh)).astype(np.float32)
              for _ in range(4)]
    return [_bf16(a) if dtype == BF16 else a for a in arrays]


@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('H,dh', KERNEL_SHAPES)
def test_fa_fwd_reference_matches_pallas(H, dh, dtype):
    q, k, v, _ = _qkv(H, dh, dtype, seed=H * 10 + dh)
    jt = getattr(jnp, dtype)
    expected = field_attention(*(jnp.asarray(_jax_heads(t, H), jt)
                                 for t in (q, k, v)),
                               1.0 / np.sqrt(dh), True)
    tq, tk, tv = (torch.from_numpy(t).to(getattr(torch, dtype))
                  for t in (q, k, v))
    out = fa_fwd_reference(tq, tk, tv, H)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out.float(), _from_jax_heads(expected), dtype)
    # the wrapper takes the plain version for CPU tensors and counts no
    # launch; float32 out beside bfloat16 inputs is the unrounded context
    before = fa_fwd.launches
    torch.testing.assert_close(fa_fwd(tq, tk, tv, H), out, rtol=0, atol=0)
    wide = fa_fwd(tq, tk, tv, H, torch.float32)
    assert fa_fwd.launches == before and wide.dtype == torch.float32
    torch.testing.assert_close(wide.to(tq.dtype), out, rtol=0, atol=0)


@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('H,dh', KERNEL_SHAPES)
def test_fa_bwd_reference_matches_pallas_vjp(H, dh, dtype):
    q, k, v, do = _qkv(H, dh, dtype, seed=H * 10 + dh + 1)
    jt = getattr(jnp, dtype)
    scale = 1.0 / np.sqrt(dh)
    _, vjp = jax.vjp(lambda a, b, c: field_attention(a, b, c, scale, True),
                     *(jnp.asarray(_jax_heads(t, H), jt) for t in (q, k, v)))
    expected = vjp(jnp.asarray(_jax_heads(do, H), jt))
    tensors = [torch.from_numpy(t).to(getattr(torch, dtype))
               for t in (q, k, v, do)]
    before = fa_bwd.launches
    got = fa_bwd(*tensors, H)
    assert fa_bwd.launches == before
    for name, g, ref, e in zip('qkv', got,
                               fa_bwd_reference(*tensors, H), expected):
        assert g.dtype == tensors[0].dtype
        torch.testing.assert_close(g, ref, rtol=0, atol=0)
        _close(g.float(), _from_jax_heads(e), dtype, f'd{name}')


def _block_operands(H, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    U = H * dh
    x = rng.normal(size=(B_K, F_K, U)).astype(np.float32)
    w = rng.normal(0., 0.6, size=(U + 1, 4 * U)).astype(np.float32)
    do = rng.normal(size=(B_K, F_K, U)).astype(np.float32)
    if dtype == BF16:
        x, do = _bf16(x), _bf16(do)
    return x, w, do


def _jax_block(x):
    """(B, F, U) → the JAX block's (U, F, B)."""
    return np.ascontiguousarray(x.transpose(2, 1, 0))


@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('H,dh', KERNEL_SHAPES)
def test_ab_fwd_reference_matches_pallas(H, dh, dtype):
    x, w, _ = _block_operands(H, dh, dtype, seed=H + dh)
    jt = getattr(jnp, dtype)
    expected = attention_block(jnp.asarray(_jax_block(x), jt),
                               jnp.asarray(w), 1.0 / np.sqrt(dh), H, dh,
                               True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = ab_fwd_reference(tx, torch.from_numpy(w), H)
    assert out.dtype == tx.dtype
    _close(out.float(), np.asarray(expected, np.float32).transpose(2, 1, 0),
           dtype)
    before = ab_fwd.launches
    torch.testing.assert_close(ab_fwd(tx, torch.from_numpy(w), H), out)
    assert ab_fwd.launches == before


@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('H,dh', KERNEL_SHAPES)
def test_attention_block_gradient_matches_pallas_vjp(H, dh, dtype):
    """K6-bwd's plain version with the products of the Function against the
    custom VJP of the Pallas block: dx in x's type, dW float32."""
    x, w, do = _block_operands(H, dh, dtype, seed=H + dh + 1)
    jt = getattr(jnp, dtype)
    scale = 1.0 / np.sqrt(dh)
    _, vjp = jax.vjp(
        lambda a, b: attention_block(a, b, scale, H, dh, True),
        jnp.asarray(_jax_block(x), jt), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(_jax_block(do), jt))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    before = ab_bwd.launches
    out = attention_grad.attention_block(tx, tw, H)
    out.backward(torch.from_numpy(do).to(tx.dtype))
    assert ab_bwd.launches == before
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == torch.float32
    _close(tx.grad.float(), np.asarray(jdx, np.float32).transpose(2, 1, 0),
           dtype, 'dx')
    _close(tw.grad, jdw, dtype, 'dw')
    # the kernel's output is dpre in x's type, masked where pre <= 0
    dpre = ab_bwd(tx.detach(), tw.detach().to(tx.dtype),
                  torch.from_numpy(do).to(tx.dtype), H)
    assert dpre.shape == (B_K, F_K, 4 * H * dh) and dpre.dtype == tx.dtype
    torch.testing.assert_close(
        dpre, ab_bwd_reference(tx.detach(), tw.detach(),
                               torch.from_numpy(do).to(tx.dtype), H))


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(4, 3, 8)
    with pytest.raises(ValueError, match='multiple of num_heads'):
        fa_fwd(q, q, q, 3)
    with pytest.raises(ValueError, match='shapes differ'):
        fa_fwd(q, q, q[:, :2], 2)
    with pytest.raises(ValueError, match='w_aug'):
        ab_fwd(q, torch.zeros(8, 32), 2)
    with pytest.raises(ValueError, match='shapes differ'):
        ab_bwd(q, torch.zeros(9, 32), q[:2], 2)


# ---------------------------------------------------------------- the module

MHA_OPTIONS = {'batch_minor': {}, 'batch_major': {'layout': 'batch_major'},
               'fused': {'fuse_projections': True},
               'no_residual': {'use_residual': False},
               # the JAX package fuses on its batch-minor kernel path only:
               # these two run the unfused block, in JAX and in the port
               'fused_batch_major': {'fuse_projections': True,
                                     'layout': 'batch_major'},
               'fused_no_kernel': {'fuse_projections': True,
                                   'use_fused_kernel': False}}


def _port_mha(U, params, jax_params, jax_stats):
    module = MultiheadAttention(U, params)
    state = {}
    for key, node in jax_params.items():
        if 'kernel' in node:
            state[f'{key}.weight'] = torch.from_numpy(
                np.asarray(node['kernel'], np.float32).T.copy())
            state[f'{key}.bias'] = torch.tensor(np.asarray(node['bias']))
        else:
            stats = jax_stats[key]
            for port_key, value in (('weight', node['scale']),
                                    ('bias', node['bias']),
                                    ('running_mean', stats['mean']),
                                    ('running_var', stats['var'])):
                state[f'{key}.{port_key}'] = torch.tensor(
                    np.asarray(value, np.float32))
    module.load_state_dict(state, strict=True)
    return module


def _flat_grads(grads):
    flat = {}
    for key, node in jax.device_get(grads).items():
        if 'kernel' in node:
            flat[f'{key}.weight'] = np.asarray(node['kernel']).T
            flat[f'{key}.bias'] = np.asarray(node['bias'])
        else:
            flat[f'{key}.weight'] = np.asarray(node['scale'])
            flat[f'{key}.bias'] = np.asarray(node['bias'])
    return flat


@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('option', list(MHA_OPTIONS))
def test_multihead_attention_matches_flax(option, dtype, training):
    _check_mha_against_flax(MHA_OPTIONS[option], dtype, training, 24, 5, 8,
                            2, fused=option == 'fused')


# the kernels take every shape the JAX package runs: a head wider than 64
# and many fields, here through the plain path on the CPU
@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('B,F,U,H', [(4, 5, 96, 1), (3, 160, 8, 2)],
                         ids=['dh96', 'F160'])
def test_multihead_attention_matches_flax_at_wide_shapes(B, F, U, H, dtype):
    _check_mha_against_flax({}, dtype, True, B, F, U, H, fused=False)


@pytest.mark.parametrize('option,fused', [
    ('fused', True), ('fused_batch_major', False), ('fused_no_kernel', False),
    ('batch_minor', False)])
def test_fused_block_runs_where_jax_fuses(option, fused):
    params = dict({'num_heads': 2}, **MHA_OPTIONS[option])
    module = MultiheadAttention(8, params)
    assert module.fused is fused
    x = torch.randn(3, 4, 8, generator=torch.Generator().manual_seed(2))
    before = (ab_fwd.launches, fa_fwd.launches)
    with torch.no_grad():
        module(x)
    assert (ab_fwd.launches, fa_fwd.launches) == before  # CPU: no launch


def _check_mha_against_flax(extra, dtype, training, B, F, U, H, fused):
    params = dict({'num_heads': H, 'dropout_rate': 0, 'use_residual': True},
                  **extra)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, F, U)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jax_module = jax_interactions.MultiheadAttention(params=params)
    variables = jax.device_get(jax_module.init(jax.random.PRNGKey(4), jx))
    stats = {'batch_normalize': {
        'mean': rng.normal(0., 0.3, U).astype(np.float32),
        'var': rng.uniform(0.5, 2.0, U).astype(np.float32)}}
    g = rng.normal(size=(B, F, U)).astype(np.float32)

    def loss(p, xv):
        out, mutated = jax_module.apply(
            {'params': p, 'batch_stats': stats}, xv, training=training,
            mutable=['batch_stats'])
        return jnp.sum(out * g), (out, mutated['batch_stats'])

    (_, (out, new_stats)), (grads, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables['params'], jx)

    module = _port_mha(U, params, variables['params'], stats)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    port_out = module(tx, training=training)
    port_out.backward(torch.from_numpy(g))
    assert port_out.dtype == torch.float32 and tx.grad.dtype == tx.dtype
    assert module.fused is fused
    if fused and dtype == BF16:
        # the fused block keeps q, k, v, r in float32: its reference is
        # the oracle of the Pallas block, and flax's BatchNorm
        return _check_fused_bf16(module, x, variables, stats, port_out,
                                 training, H)
    _close(port_out.detach(), out, dtype, 'out')
    _close(tx.grad.float(), np.asarray(dx, np.float32), dtype, 'dx')
    flat = _flat_grads(grads)
    named = dict(module.named_parameters())
    assert set(named) == set(flat)
    for name, p in named.items():
        _close(p.grad, flat[name], dtype, name, BF16_PARAM_GRAD_TOL)
    if training:
        for key in ('mean', 'var'):
            _close(getattr(module.batch_normalize, f'running_{key}'),
                   new_stats['batch_normalize'][key], dtype, key)


def _check_fused_bf16(module, x, variables, stats, port_out, training, H):
    p = variables['params']
    U = x.shape[-1]
    w_aug = np.concatenate(
        [np.concatenate([p[n]['kernel'] for n in
                         ('dense_Q', 'dense_K', 'dense_V', 'dense_residual')],
                        axis=1),
         np.concatenate([p[n]['bias'] for n in
                         ('dense_Q', 'dense_K', 'dense_V',
                          'dense_residual')])[None]])
    np.testing.assert_array_equal(module.w_aug().detach().numpy(), w_aug)
    block = attention_block_oracle(
        jnp.asarray(x.transpose(2, 1, 0), jnp.bfloat16), jnp.asarray(w_aug),
        1.0 / np.sqrt(U // H), H, U // H)
    bn = jax_interactions.nn.BatchNorm(use_running_average=not training,
                                       momentum=0.9, epsilon=1e-3)
    out, _ = bn.apply({'params': p['batch_normalize'],
                       'batch_stats': stats['batch_normalize']},
                      jnp.asarray(block).transpose(2, 1, 0),
                      mutable=['batch_stats'])
    _close(port_out.detach(), out, BF16, 'out')


def test_block_promotion_after_batch_norm():
    """Under bfloat16 only the first block's projections and attention run
    in bfloat16: its BatchNorm returns float32 (flax's promotion), so the
    next block runs in float32, in JAX and in the port alike."""
    case = Case('autoint_nonascending_d8', BF16,
                autoint_params={'num_attention': 3})
    batch = case.batch(16, seed=2)
    _, state = case.jax_model.module.apply(
        case.jax_model.variables, batch, training=False,
        capture_intermediates=True, mutable=['intermediates'])
    inter = state['intermediates']
    jax_types = [str(inter[f'autoint_attention_{i}']['dense_Q']
                     ['__call__'][0].dtype) for i in range(3)]
    assert jax_types == ['bfloat16', 'float32', 'float32']

    port = case.port_model()
    seen = {}

    def hook(name):
        def record(module, args, kwargs, output):
            seen[name] = (args[0].dtype, output.dtype)
        return record
    for i in range(3):
        block = getattr(port.module, f'autoint_attention_{i}')
        block.dense_Q.register_forward_hook(hook(f'q{i}'), with_kwargs=True)
        block.register_forward_hook(hook(f'block{i}'), with_kwargs=True)
    port.forward_batch(batch)
    assert [str(seen[f'q{i}'][1]).split('.')[1] for i in range(3)] == \
        jax_types
    assert [seen[f'block{i}'][0] for i in range(3)] == \
        [torch.bfloat16, torch.float32, torch.float32]
    assert all(seen[f'block{i}'][1] == torch.float32 for i in range(3))


def test_dropout_path_runs_no_kernel_and_draws_from_the_generator():
    params = {'num_heads': 2, 'dropout_rate': 0.5, 'use_residual': True}
    module = MultiheadAttention(8, params,
                                generator=torch.Generator().manual_seed(0))
    x = torch.randn(6, 4, 8, generator=torch.Generator().manual_seed(1))
    before = (fa_fwd.launches, fa_bwd.launches)
    runs = [module(x, training=True,
                   generator=torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    torch.testing.assert_close(runs[0], runs[1])
    assert not torch.allclose(runs[0], runs[2])
    # in eval the weights are kept: the plain attention of the kernels
    plain = MultiheadAttention(8, dict(params, dropout_rate=0))
    plain.load_state_dict(module.state_dict())
    torch.testing.assert_close(module(x), plain(x))
    assert (fa_fwd.launches, fa_bwd.launches) == before
    with pytest.raises(ValueError, match='Generator'):
        module(x, training=True)


def test_use_fused_kernel_false_warns_and_changes_nothing():
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger('deeptables_torch.ops.interactions')
    logger.addHandler(handler)
    try:
        flagged = MultiheadAttention(8, {'num_heads': 2,
                                         'use_fused_kernel': False},
                                     generator=torch.Generator().manual_seed(0))
    finally:
        logger.removeHandler(handler)
    assert any('use_fused_kernel' in r.getMessage() for r in records)
    plain = MultiheadAttention(8, {'num_heads': 2})
    plain.load_state_dict(flagged.state_dict())
    x = torch.randn(5, 3, 8, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(flagged(x), plain(x))


def test_serving_forward_takes_no_autograd_path():
    for params in ({'num_heads': 2}, {'num_heads': 2,
                                      'fuse_projections': True}):
        module = MultiheadAttention(8, params)
        with torch.no_grad():
            out = module(torch.randn(3, 4, 8))
        assert out.grad_fn is None and out.shape == (3, 4, 8)


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('schema', ['autoint_nonascending_d8',
                                    'autoint_dnn_d8'])
def test_autoint_taps_and_logits_match_jax(schema, dtype):
    case = Case(schema, dtype)
    assert case.field_order() != sorted(case.field_order())
    batch = case.batch(40, seed=3)
    logits, taps = case.jax_model.module.apply(case.jax_model.variables,
                                               batch, training=False)
    port_logits, port_taps = case.port_model().forward_batch(batch)
    order = case.field_order()
    D = case.dims[0]
    # the AutoInt output follows the JAX stacked field order
    expected = np.asarray(taps['autoint_nets_out'], np.float32).reshape(
        40, len(order), D)
    column = np.empty_like(expected)
    column[:, order] = expected
    _close(port_taps['autoint_nets_out'].float().reshape(40, -1, D), column,
           dtype, 'autoint_nets_out')
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(logits),
                               rtol=1e-4 if dtype == F32 else 1e-2,
                               atol=1e-5 if dtype == F32 else 2e-3)


# the fused path keeps q, k, v, r in float32 where the flax module rounds
# them to bfloat16: it is held to JAX in float32 here, and in bfloat16 to
# attention_block_oracle above
@pytest.mark.parametrize('autoint_params,dtype', [
    (None, F32), (None, BF16), ({'layout': 'batch_major'}, F32),
    ({'layout': 'batch_major'}, BF16), ({'fuse_projections': True}, F32)],
    ids=['batch_minor-f32', 'batch_minor-bf16', 'batch_major-f32',
         'batch_major-bf16', 'fused-f32'])
def test_autoint_one_train_step_matches_jax(autoint_params, dtype):
    case = Case('autoint_nonascending_d8', dtype,
                autoint_params=autoint_params)
    batch = case.batch(48, seed=8)
    y = np.random.default_rng(9).integers(0, 2, 48).astype(np.float32)
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
    atol = 1e-4 if dtype == F32 else BF16_PARAM_GRAD_TOL
    np.testing.assert_allclose(float(port_loss.detach()), float(loss),
                               rtol=rtol)
    named = dict(port.module.named_parameters())
    assert set(named) == set(expected)
    assert any(k.startswith('autoint_attention_1.') for k in named)
    for name, param in named.items():
        ref = expected[name].numpy()
        # bn_concat_emb_dense feeds no net of an AutoInt-only model: JAX
        # gives it zero gradients, torch none
        grad = param.grad if param.grad is not None \
            else torch.zeros_like(param)
        np.testing.assert_allclose(grad.numpy(), ref, rtol=rtol,
                                   atol=atol * float(np.abs(ref).max()),
                                   err_msg=name)


@pytest.mark.parametrize('dtype', [F32, BF16])
def test_autoint_fit_trajectory_matches_jax(dtype):
    pd = pytest.importorskip('pandas')
    case = Case('autoint_nonascending_d16', dtype)
    batch = case.batch(80, seed=10)
    X = pd.DataFrame({c.name: batch['cat'][:, i]
                      for i, c in enumerate(case.port_cats)})
    y = (np.random.default_rng(10).uniform(size=80)
         < 0.3 + 0.4 * (batch['cat'][:, 0] % 2)).astype(np.int64)
    kwargs = dict(batch_size=16, epochs=3, verbose=0)
    jax_history = case.jax_model.fit(X, y, **kwargs)
    port = case.port_model()
    port_history = port.fit(X, y, **kwargs)
    rtol, atol = (1e-4, 2e-4) if dtype == F32 else (1e-2, 2e-2)
    for key in ('loss', 'val_loss', 'val_auc'):
        assert len(port_history.history[key]) == 3
        np.testing.assert_allclose(port_history.history[key],
                                   jax_history.history[key], rtol=rtol,
                                   err_msg=key)
    expected = bridge.state_dict_from_flax(
        jax.device_get(case.jax_model.variables), case.port_cats,
        case.port_conts, case.port_config)
    for key, value in port.module.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize('dtype', [F32, BF16])
@pytest.mark.parametrize('autoint_params', [None, {'fuse_projections': True}],
                         ids=['batch_minor', 'fused'])
def test_autoint_predictor_matches_jax(autoint_params, dtype):
    case = Case('autoint_nonascending_d8', dtype,
                autoint_params=autoint_params)

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
            jax_predictor.predict_proba_arrays(arrays),
            atol=1e-5 if dtype == F32 else 1e-3)


# ------------------------------------------- num_units: the paper's widths

# the benchmark's AutoInt configuration cut to five columns at its own
# widths: D = 16 into 3 layers of 2 heads of 32 (16 → 64 → 64 → 64)
NUM_UNITS_VOCAB = [7, 11, 13, 50, 3]
NUM_UNITS_ROWS = 16
# the state of ``_default_autoint()`` as the port built it before
# ``num_units`` existed (names, shapes and seeded values): the default and
# an explicit None or input width draw the same weights in the same order
DEFAULT_AUTOINT_STATE_SHA256 = \
    '5c1e5b1cb00738cfbfe0f9146ea663003c1c1df9072242a95b4e40cb1eb67dee'


def _bench_config(**changes):
    cfg = spec_lib.load_json(spec_lib.BENCH_DIR / 'configs'
                             / 'autoint_avazu.json')
    cfg.update(vocabulary=NUM_UNITS_VOCAB, **changes)
    return cfg


def _num_units_model(cfg, seed):
    """The port's model of ``cfg`` through the benchmark's harness, its
    every parameter and running statistic set from ``seed``."""
    model = port.build(cfg, seed, 'cpu')
    port.load(model, weights.make(cfg, seed, 'cpu'), cfg)
    return model


def _num_units_rows(cfg, seed):
    rng = np.random.default_rng(seed)
    cat, dense = inputs.rows(rng, cfg, NUM_UNITS_ROWS, 1.2)
    return cat, dense, inputs.labels(rng, cat, dense)


@pytest.mark.parametrize('training', [False, True], ids=['eval', 'train'])
def test_num_units_autoint_matches_the_plain_reference(training):
    """The port's AutoInt at ``num_units=64`` (2 heads of 32 over D = 16)
    against ``perfbench/nets/autoint_nets.py`` in float64, on the harness's
    seeded weights: the logits (BatchNorm on the batch's statistics in
    training, on the running ones in eval) and, in training, the gradient
    of the binary cross-entropy for every leaf. float32 against float64:
    rtol 1e-4 with 1e-4 of the tensor's largest value, as the float32 cases
    above; the concatenation's BatchNorm, which no net reads, gets no
    gradient in the port and exactly 0 in the reference."""
    cfg = _bench_config()
    seed = 2 ** 31 + 5
    model = _num_units_model(cfg, seed)
    block = model.build().autoint_attention_0
    assert tuple(block.dense_Q.weight.shape) == (64, 16)
    assert (block.num_units, block.num_heads) == (64, 2)
    cat, dense, y = _num_units_rows(cfg, 3)
    params = bench_ref.cast(weights.make(cfg, seed, 'cpu'), 'fp64')
    names = [name for name, _, _ in bench_ref.param_specs(cfg)]
    for name in names:
        params[name].requires_grad_(True)
    want = bench_ref.forward(params, cfg, torch.as_tensor(cat).long(),
                       torch.as_tensor(dense).double(), training, 'fp64')
    module = model.build()
    got, _ = module(model.to_device(port.arrays(cat, dense)),
                    training=training)
    _close(got.detach().numpy(), want.detach().numpy(), F32, 'logits')
    if not training:
        return
    yt = torch.as_tensor(y)
    want_grads = torch.autograd.grad(bench_ref.bce(want, yt),
                                     [params[n] for n in names])
    leaves = port.leaves(model, cfg)
    got_grads = torch.autograd.grad(bench_ref.bce(got, yt),
                                    [leaves[n] for n in names],
                                    allow_unused=True)
    for name, g, w in zip(names, got_grads, want_grads):
        g = torch.zeros_like(leaves[name]) if g is None else g
        if name.startswith('bn_concat.'):
            assert not w.any(), name
        _close(g.numpy(), w.numpy(), F32, name)


def _default_autoint(**extra):
    cats = tuple(CategoricalColumn(f'C{i}', v, 8)
                 for i, v in enumerate(NUM_UNITS_VOCAB))
    return DeepModel('binary', 2, ModelConfig(
        nets=['autoint_nets'], task='binary', metrics=['AUC'],
        embeddings_output_dim=8, embedding_dropout=0, seed=11,
        autoint_params=dict(num_attention=2, num_heads=2, dropout_rate=0,
                            use_residual=True, **extra)), cats, (),
        device='cpu')


@pytest.mark.parametrize('extra', [
    {}, {'num_units': None}, {'num_units': 8}, {'fuse_projections': True},
    {'fuse_projections': True, 'num_units': None},
    {'fuse_projections': True, 'num_units': 8}],
    ids=['unset', 'none', 'input_width', 'fused', 'fused_none',
         'fused_input_width'])
def test_num_units_unset_is_the_model_of_before(extra):
    """Unset, None or the input width: the parameters' names, shapes and
    seeded values as before ``num_units`` (a digest of the state the port
    built then), and the same logits as the model that never names it."""
    model = _default_autoint(**extra)
    digest = hashlib.sha256()
    for key, value in model.build().state_dict().items():
        digest.update(key.encode())
        digest.update(value.numpy().tobytes())
    assert digest.hexdigest() == DEFAULT_AUTOINT_STATE_SHA256
    plain = _default_autoint(
        **{k: v for k, v in extra.items() if k != 'num_units'})
    rng = np.random.default_rng(1)
    cat = np.stack([rng.integers(0, v, 40) for v in NUM_UNITS_VOCAB], 1)
    batch = {'cat': cat.astype(np.int32)}
    with torch.no_grad():
        for training in (False, True):
            got, _ = model.build()(model.to_device(batch), training=training)
            want, _ = plain.build()(plain.to_device(batch),
                                    training=training)
            assert torch.equal(got, want), training


def test_fuse_projections_refuses_a_non_square_block():
    params = {'num_heads': 2, 'num_units': 64, 'fuse_projections': True}
    with pytest.raises(ValueError, match='fuse_projections.*square'):
        MultiheadAttention(16, params)
    with pytest.raises(ValueError, match='fuse_projections'):
        _default_autoint(fuse_projections=True, num_units=16).build()
    # square blocks fuse as before; num_units past the first block is square
    assert MultiheadAttention(64, params).fused


def test_num_units_survives_save_load_and_serves_alike(tmp_path):
    cfg = _bench_config()
    model = _num_units_model(cfg, 2 ** 31 + 9)
    path = str(tmp_path / 'autoint.pkl')
    model.save(path)
    loaded = DeepModel.load(path, device='cpu')
    assert loaded.config.autoint_params['num_units'] == 64
    assert loaded.build().autoint_attention_2.num_units == 64

    def holder(m):
        return types.SimpleNamespace(task='binary', preprocessor=None,
                                     get_model=lambda selector: m)
    for n in (1, 37):
        cat, _, _ = _num_units_rows(cfg, n)
        arrays = {'cat': cat}
        np.testing.assert_array_equal(
            serving.Predictor(holder(loaded), batch_buckets=(8, 64))
            .predict_proba_arrays(arrays),
            serving.Predictor(holder(model), batch_buckets=(8, 64))
            .predict_proba_arrays(arrays))


def test_bridge_refuses_num_units():
    model = _default_autoint(num_units=16)
    with pytest.raises(ValueError, match='num_units'):
        bridge.state_dict_from_flax({'params': {}},
                                    model.categorical_columns, (),
                                    model.config)


def test_each_interacting_layer_is_a_span():
    """Under a profiler each layer's forward is a ``autoint.block`` span
    inside the net's, with its shape as counts."""
    from deeptables_torch.utils import profiling
    cfg = _bench_config()
    model = _num_units_model(cfg, 7)
    cat, dense, _ = _num_units_rows(cfg, 1)
    batch = model.to_device(port.arrays(cat, dense))
    profiling.take_spans()
    with torch.profiler.profile(), torch.no_grad():
        model.build()(batch)
    log = profiling.take_spans()
    by_id = {e['id']: e for e in log}
    blocks = [e for e in log if e['name'] == 'deeptables.autoint.block']
    assert [e['counts'] for e in blocks] == [
        dict(block=i, fields=5, heads=2, d_head=32,
             units_in=16 if i == 0 else 64, units_out=64) for i in range(3)]
    assert all(by_id[e['parent']]['name'] ==
               'deeptables.model.net.autoint_nets' for e in blocks)
