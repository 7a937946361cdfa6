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
                                              fwd_design, padded_w,
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
    assert fwd_design(torch.bfloat16, 26, 64) == 'wgmma'
    assert fwd_design(torch.bfloat16, 26, 576) == 'wgmma'  # F + G = 602
    assert fwd_design(torch.bfloat16, 26, 577) == 'simt'   # past the tiles
    assert fwd_design(torch.float32, 26, 64) == 'simt'     # not TF32


def test_bwd_design_takes_the_tensor_cores_for_bfloat16_only():
    for F, G, L in ((26, 26, 128), (26, 64, 128), (26, 128, 128),
                    (5, 7, 300), (1, 1, 1)):
        assert bwd_design(torch.bfloat16, F, G, L) == 'wgmma'
        assert bwd_design(torch.float32, F, G, L) == 'simt'  # not TF32
    # the dx0/dh pass's dz tile: 128 columns of L padded to 64
    assert bwd_design(torch.bfloat16, 26, 64, 704) == 'wgmma'
    assert bwd_design(torch.bfloat16, 26, 64, 705) == 'simt'
    assert bwd_design(torch.bfloat16, 5, 4, 900) == 'simt'
    # the dW pass's two buffers of h rows
    assert bwd_design(torch.bfloat16, 3, 686, 5) == 'wgmma'
    assert bwd_design(torch.bfloat16, 3, 687, 5) == 'simt'
    assert bwd_design(torch.bfloat16, 3, 700, 5) == 'simt'


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
