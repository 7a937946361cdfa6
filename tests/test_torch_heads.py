# -*- coding:utf-8 -*-
"""The regression, multiclass and multilabel heads, the stateful GHMC loss
and the embedding regularizers through the port's ``DeepModel``, against
the JAX package's, on the CPU, over bridged small DeepFMs.

For each head: the inference logits, then the training loss and one step's
gradients, then a two-epoch ``fit`` (default validation split) and
``evaluate``. The regularizers: a DeepFM with an embedding weight penalty
and an activity penalty, one step's loss and gradients and one fitted
step, with the JAX tables' padding rows zeroed (the port's tables have
none; see ``torch_parity.zero_padding_rows``). GHMC: a two-epoch fit whose
loss state is carried from step to step in both packages.

Tolerances, as ``tests/test_torch_train.py`` states them: float32 rtol
1e-5 with an absolute term of 1e-5 times the largest magnitude (summation
order); bfloat16 gradients rtol 1e-2 (the frameworks round the bfloat16
sums at other places); the fit's per-epoch logs rtol 1e-4 and its final
state atol 2e-4 (Adam moves each parameter by up to lr a step whatever the
gradient's size); the GHMC state rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.ops import regularizers as jax_regularizers
from deeptables_torch import bridge
from torch_parity import Case

F32, BF16 = 'float32', 'bfloat16'
HEADS = {'multiclass': dict(task='multiclass', num_classes=4,
                            metrics=['accuracy']),
         'regression': dict(task='regression', num_classes=1,
                            metrics=['mse']),
         'multilabel': dict(task='multilabel', num_classes=3,
                            metrics=['logloss'])}


def _allclose(actual, expected, rtol, err_msg=''):
    actual = np.asarray(actual, np.float32)
    expected = np.asarray(expected, np.float32)
    assert actual.shape == expected.shape, err_msg
    scale = float(np.abs(expected).max()) if expected.size else 0.
    np.testing.assert_allclose(actual, expected, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


def _jax_step(case, batch, y):
    """The JAX package's training loss of one step (its train step's
    ``compute_loss``: the task loss, the activity penalty its module taps,
    the weight penalty over the ``emb_*`` parameters) and its gradients,
    mapped into the port's names."""
    module = case.jax_model.module
    params = case.variables['params']
    batch_stats = case.variables['batch_stats']
    loss_fn = case.jax_model._loss_fn()
    emb_reg = jax_regularizers.get_regularizer(
        case.jax_config.embeddings_regularizer)

    def compute_loss(p):
        (logits, taps), _ = module.apply(
            {'params': p, 'batch_stats': batch_stats}, batch, training=True,
            rngs={'dropout': jax.random.PRNGKey(0)}, mutable=['batch_stats'])
        loss = loss_fn(logits, jnp.asarray(y))
        loss = loss + taps.get('__embeddings_activity_reg__', 0.0)
        if emb_reg is not None:
            for name, sub in p.items():
                if name.startswith('emb_'):
                    for leaf in jax.tree_util.tree_leaves(sub):
                        loss = loss + emb_reg(leaf)
        return loss

    loss, grads = jax.value_and_grad(compute_loss)(params)
    return float(loss), bridge.state_dict_from_flax(
        {'params': jax.device_get(grads)}, case.port_cats, case.port_conts,
        case.port_config)


def _port_step(case, batch, y):
    port = case.port_model()
    loss_fn = port._loss_fn()
    loss, _, _ = port.training_loss(port.to_device(batch),
                                    torch.from_numpy(y), None, loss_fn)
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in
                                  port.module.named_parameters()}


def _check_step(case, n=48, dtype=F32):
    batch, y = case.batch(n, seed=4), case.labels(n, seed=5)
    expected_loss, expected = _jax_step(case, batch, y)
    loss, grads = _port_step(case, batch, y)
    rtol = 1e-5 if dtype == F32 else 1e-2
    np.testing.assert_allclose(loss, expected_loss, rtol=rtol)
    assert set(grads) == set(expected)
    for name, grad in grads.items():
        _allclose(grad, expected[name], rtol, name)


# ---------------------------------------------------------------- heads

@pytest.mark.parametrize('head', sorted(HEADS))
def test_head_logits_match_jax(head):
    case = Case('nonascending_d16', **HEADS[head])
    batch = case.batch(37, seed=9)
    expected, _ = case.jax_model.module.apply(case.variables, batch,
                                              training=False)
    port = case.port_model()
    logits, _ = port.forward_batch(batch)
    assert logits.shape == (37, HEADS[head]['num_classes'])
    _allclose(logits, expected, 1e-5)
    X = case.dataframe(37, seed=9)
    _allclose(port.predict(X), case.jax_model.predict(X), 1e-5)


@pytest.mark.parametrize('head,dtype', [(h, d) for h in sorted(HEADS)
                                        for d in (F32, BF16)])
def test_head_step_gradients_match_jax(head, dtype):
    _check_step(Case('nonascending_d16', dtype, **HEADS[head]), dtype=dtype)


@pytest.fixture(scope='module', params=sorted(HEADS))
def fitted(request):
    """A JAX fit and a port fit of a head from the same weights on one
    DataFrame: 75 rows, the default 20% validation split, batches of 16, 2
    epochs."""
    case = Case('nonascending_d16', **HEADS[request.param])
    X, y = case.dataframe(75, seed=11), case.labels(75, seed=12)
    jax_history = case.jax_model.fit(X, y, batch_size=16, epochs=2,
                                     verbose=0)
    port = case.port_model()
    port_history = port.fit(X, y, batch_size=16, epochs=2, verbose=0)
    return case, port, X, y, jax_history, port_history


def test_head_fit_trajectory_matches_jax(fitted):
    case, port, X, y, jax_history, port_history = fitted
    assert sorted(port_history.history.data) == \
        sorted(jax_history.history.data)
    for key in jax_history.history.data:
        np.testing.assert_allclose(port_history.history[key],
                                   jax_history.history[key], rtol=1e-4,
                                   err_msg=key)
    expected = bridge.state_dict_from_flax(
        jax.device_get(case.jax_model.variables), case.port_cats,
        case.port_conts, case.port_config)
    for key, value in port.module.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   rtol=0, atol=2e-4, err_msg=key)
    got = port.evaluate(X, y, batch_size=32)
    want = case.jax_model.evaluate(X, y, batch_size=32)
    assert sorted(got.data) == sorted(want.data)
    for key in want.data:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


# ---------------------------------------------------------------- regularizers

REGULARIZED = [('l2', 'l1'), (('l1_l2', 0.02, 0.03), None),
               (None, {'l2': 0.5})]


@pytest.mark.parametrize('weights,activity', REGULARIZED, ids=str)
def test_regularized_step_matches_jax(weights, activity):
    case = Case('nonascending_d16', embeddings_regularizer=weights,
                embeddings_activity_regularizer=activity)
    _check_step(case)


def test_activity_penalty_is_tapped_in_training_only():
    case = Case('nonascending_d16', embeddings_activity_regularizer='l1')
    port = case.port_model()
    batch = port.to_device(case.batch(8))
    _, taps = port.module(batch, training=True)
    _, jax_taps = case.jax_model.module.apply(
        case.variables, case.batch(8), training=True,
        rngs={'dropout': jax.random.PRNGKey(0)}, mutable=['batch_stats'])[0]
    np.testing.assert_allclose(
        float(taps['__embeddings_activity_reg__'].detach()),
        float(jax_taps['__embeddings_activity_reg__']), rtol=1e-5)
    _, taps = port.module(batch, training=False)
    assert '__embeddings_activity_reg__' not in taps


@pytest.mark.parametrize('weights,activity', REGULARIZED[:1], ids=str)
def test_regularized_fit_step_matches_jax(weights, activity):
    case = Case('nonascending_d16', embeddings_regularizer=weights,
                embeddings_activity_regularizer=activity)
    X, y = case.dataframe(48, seed=3), case.labels(48, seed=4)
    val = case.dataframe(16, seed=5), case.labels(16, seed=6)
    jax_history = case.jax_model.fit(X, y, batch_size=48, epochs=1,
                                     verbose=0, validation_data=val)
    port = case.port_model()
    history = port.fit(X, y, batch_size=48, epochs=1, verbose=0,
                       validation_data=val)
    np.testing.assert_allclose(history.history['loss'],
                               jax_history.history['loss'], rtol=1e-5)
    expected = bridge.state_dict_from_flax(
        jax.device_get(case.jax_model.variables), case.port_cats,
        case.port_conts, case.port_config)
    for key, value in port.module.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   rtol=0, atol=2e-5, err_msg=key)


# ---------------------------------------------------------------- GHMC, focal

@pytest.mark.parametrize('loss', ['ghmc', 'binary_focal_loss'])
def test_binary_custom_loss_fit_matches_jax(loss):
    """A two-epoch fit with GHMC (momentum 0.75, its state carried from
    step to step and kept on the model) or the focal loss."""
    case = Case('nonascending_d16', loss=loss)
    X, y = case.dataframe(75, seed=13), case.labels(75, seed=14)
    jax_history = case.jax_model.fit(X, y, batch_size=16, epochs=2,
                                     verbose=0)
    port = case.port_model()
    history = port.fit(X, y, batch_size=16, epochs=2, verbose=0)
    for key in ('loss', 'val_loss', 'val_auc'):
        np.testing.assert_allclose(history.history[key],
                                   jax_history.history[key], rtol=1e-4,
                                   err_msg=key)
    if loss == 'ghmc':
        assert port.loss_state.device == port.device
        np.testing.assert_allclose(port.loss_state.numpy(),
                                   np.asarray(case.jax_model.loss_state),
                                   rtol=1e-5)
    else:
        assert port.loss_state is None
