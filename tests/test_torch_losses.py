# -*- coding:utf-8 -*-
"""The port's losses, regularizers and metrics against the JAX package's,
on the CPU.

Every loss name the JAX package accepts resolves in the port, and each loss
gives the JAX value and the JAX gradient with respect to the logits on the
same inputs (numpy seeds), with and without ``sample_weight``. GHMC with
momentum runs five steps on carried state, state compared too. Tolerance:
float32 rtol 1e-6 (with an absolute term of 1e-6 times the largest
gradient, where gradient elements cancel to near zero): the two frameworks
evaluate the same float32 expressions, only the order of the sums differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.ops import losses as jax_losses
from deeptables_tpu.ops import metrics as jax_metrics
from deeptables_tpu.ops import regularizers as jax_regularizers
from deeptables_torch.ops import losses, metrics, regularizers

RTOL = 1e-6
B, C = 96, 5


def _labels(name, rng):
    """Labels of the shape the loss takes: class ids for the categorical
    losses, (B, C) 0/1 for multilabel, 0/1 for the binary ones, reals for
    regression."""
    if name in ('categorical_crossentropy', 'sparse_categorical_crossentropy',
                'cce', 'categorical_focal_loss'):
        return rng.integers(0, C, B).astype(np.int32), (B, C)
    if name == 'multilabel_binary_crossentropy':
        return (rng.uniform(size=(B, C)) < 0.4).astype(np.float32), (B, C)
    if name in ('mse', 'mean_squared_error', 'mae', 'mean_absolute_error',
                'huber'):
        return rng.normal(0, 2, B).astype(np.float32), (B, 1)
    return rng.integers(0, 2, B).astype(np.float32), (B, 1)


def _value_and_grad_jax(fn, logits, y, w, **kw):
    def f(lg):
        out = fn(lg, jnp.asarray(y), None if w is None else jnp.asarray(w),
                 **kw)
        return out[0] if isinstance(out, tuple) else out
    value, grad = jax.value_and_grad(f)(jnp.asarray(logits))
    return float(value), np.asarray(grad)


def _value_and_grad_port(fn, logits, y, w, **kw):
    lg = torch.from_numpy(logits).requires_grad_(True)
    out = fn(lg, torch.from_numpy(y), None if w is None
             else torch.from_numpy(w), **kw)
    loss = out[0] if isinstance(out, tuple) else out
    loss.backward()
    return float(loss.detach()), lg.grad.numpy()


def _close(actual, expected, rtol=RTOL, err_msg=''):
    expected = np.asarray(expected)
    scale = float(np.abs(expected).max()) if expected.size else 0.
    np.testing.assert_allclose(actual, expected, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


def test_every_jax_loss_name_resolves():
    assert set(losses._LOSSES) == set(jax_losses._LOSSES)
    for name in jax_losses._LOSSES:
        assert callable(losses.get_loss(name.upper()))
    with pytest.raises(ValueError):
        losses.get_loss('no_such_loss')
    for task, classes in (('binary', 2), ('multiclass', 3),
                          ('regression', 1), ('multilabel', 3)):
        assert losses.auto_loss_name(task, classes) == \
            jax_losses.auto_loss_name(task, classes)


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('name', sorted(jax_losses._LOSSES))
def test_loss_matches_jax(name, weighted):
    rng = np.random.default_rng(len(name) + 7 * weighted)
    y, shape = _labels(name, rng)
    logits = rng.normal(0, 3, shape).astype(np.float32)
    w = rng.uniform(0, 2, B).astype(np.float32) if weighted else None
    expected, expected_grad = _value_and_grad_jax(
        jax_losses.get_loss(name), logits, y, w)
    got, grad = _value_and_grad_port(losses.get_loss(name), logits, y, w)
    np.testing.assert_allclose(got, expected, rtol=RTOL)
    _close(grad, expected_grad, err_msg=name)


@pytest.mark.parametrize('labels', ['index', 'index_column', 'one_hot'])
def test_categorical_losses_take_index_and_one_hot_labels(labels):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (B, C)).astype(np.float32)
    idx = rng.integers(0, C, B)
    y = {'index': idx.astype(np.int32),
         'index_column': idx.reshape(-1, 1).astype(np.int32),
         'one_hot': np.eye(C, dtype=np.float32)[idx]}[labels]
    for jax_fn, port_fn in (
            (jax_losses.categorical_crossentropy,
             losses.categorical_crossentropy),
            (jax_losses.categorical_focal_loss(gamma=1.5, alpha=0.4),
             losses.categorical_focal_loss(gamma=1.5, alpha=0.4))):
        expected, expected_grad = _value_and_grad_jax(jax_fn, logits, y, None)
        got, grad = _value_and_grad_port(port_fn, logits, y, None)
        np.testing.assert_allclose(got, expected, rtol=RTOL)
        _close(grad, expected_grad)


@pytest.mark.parametrize('gamma,alpha', [(2., .25), (0.5, 0.75), (3., .5)])
def test_binary_focal_loss_factory_matches_jax(gamma, alpha):
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 4, (B, 1)).astype(np.float32)
    y = rng.integers(0, 2, B).astype(np.float32)
    w = rng.uniform(0, 2, B).astype(np.float32)
    for weights in (None, w):
        expected, expected_grad = _value_and_grad_jax(
            jax_losses.binary_focal_loss(gamma, alpha), logits, y, weights)
        got, grad = _value_and_grad_port(
            losses.binary_focal_loss(gamma, alpha), logits, y, weights)
        np.testing.assert_allclose(got, expected, rtol=RTOL)
        _close(grad, expected_grad)


@pytest.mark.parametrize('delta', [0.5, 1.0, 2.5])
def test_huber_delta_matches_jax(delta):
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 3, B).astype(np.float32)
    y = rng.normal(0, 3, B).astype(np.float32)
    expected, expected_grad = _value_and_grad_jax(jax_losses.huber, logits,
                                                  y, None, delta=delta)
    got, grad = _value_and_grad_port(losses.huber, logits, y, None,
                                     delta=delta)
    np.testing.assert_allclose(got, expected, rtol=RTOL)
    _close(grad, expected_grad)


@pytest.mark.parametrize('columns,momentum', [(1, 0.75), (4, 0.75),
                                              (1, 0.3), (3, 0.0)])
def test_ghmc_carries_its_state_like_jax(columns, momentum):
    """Five steps on carried state: the loss, its gradient and the state
    after each step; then a stateless call (validation) on the same
    batch."""
    jax_loss = jax_losses.GHMCLoss(bins=10, momentum=momentum)
    port_loss = losses.GHMCLoss(bins=10, momentum=momentum)
    assert port_loss.stateful == jax_loss.stateful
    np.testing.assert_array_equal(port_loss._edges_right.numpy(),
                                  np.asarray(jax_loss._edges_right))
    jax_state = jax_loss.init_state()
    state = port_loss.init_state()
    assert state.dtype == torch.float32 and state.shape == (10,)
    rng = np.random.default_rng(columns)
    for step in range(5):
        logits = rng.normal(0, 1 + step, (B, columns)).astype(np.float32)
        y = (rng.uniform(size=(B, columns)) < 0.3).astype(np.float32)

        def jax_f(lg):
            return jax_loss(lg, jnp.asarray(y), state=jax_state)
        (expected, new_jax_state), expected_grad = jax.value_and_grad(
            jax_f, has_aux=True)(jnp.asarray(logits))
        lg = torch.from_numpy(logits).requires_grad_(True)
        got, new_state = port_loss(lg, torch.from_numpy(y), state=state)
        got.backward()
        assert not new_state.requires_grad
        np.testing.assert_allclose(float(got.detach()), float(expected),
                                   rtol=RTOL)
        _close(lg.grad.numpy(), np.asarray(expected_grad))
        np.testing.assert_allclose(new_state.numpy(),
                                   np.asarray(new_jax_state), rtol=RTOL)
        jax_state, state = new_jax_state, new_state
    stateless = port_loss(torch.from_numpy(logits), torch.from_numpy(y))
    np.testing.assert_allclose(
        float(stateless),
        float(jax_loss(jnp.asarray(logits), jnp.asarray(y))), rtol=RTOL)


def test_ghmc_factory_is_stateless_by_default():
    assert not losses.ghmc_loss().stateful
    assert losses.get_loss('GHMC').stateful
    assert losses.get_loss('ghmc_loss') is losses.get_loss('ghmc')


# ---------------------------------------------------------------- regularizers

REGULARIZERS = ['l1', 'l2', 'l1_l2', 'L1L2', ('l1', 0.3), ('l2', 0.05),
                ('l1_l2', 0.2, 0.1), {'l1': 0.5}, {'l2': 0.25},
                {'l1': 0.1, 'l2': 0.2}]


@pytest.mark.parametrize('identifier', REGULARIZERS, ids=str)
def test_regularizer_matches_jax(identifier):
    rng = np.random.default_rng(17)
    w = rng.normal(0, 1, (37, 8)).astype(np.float32)
    expected = float(jax_regularizers.get_regularizer(identifier)(
        jnp.asarray(w)))
    reg = regularizers.get_regularizer(identifier)
    got = float(reg(torch.from_numpy(w)))
    np.testing.assert_allclose(got, expected, rtol=RTOL)
    # bfloat16 inputs are penalised in float32, as in the JAX package
    wb = torch.from_numpy(w).to(torch.bfloat16)
    expected_b = float(jax_regularizers.get_regularizer(identifier)(
        jnp.asarray(w, jnp.bfloat16)))
    np.testing.assert_allclose(float(reg(wb)), expected_b, rtol=RTOL)


def test_regularizer_identifiers():
    assert regularizers.get_regularizer(None) is None
    fn = lambda w: w.sum()  # noqa: E731
    assert regularizers.get_regularizer(fn) is fn
    # the Keras default coefficient
    w = torch.ones(4)
    assert float(regularizers.get_regularizer('l1')(w)) == \
        pytest.approx(0.04)
    for bad in ('l3', {'l3': 1.0}, ('l1',), ('l2', 1, 2), 3.0):
        with pytest.raises(ValueError):
            regularizers.get_regularizer(bad)
        with pytest.raises(ValueError):
            jax_regularizers.get_regularizer(bad)


# ---------------------------------------------------------------- metrics

def test_multilabel_accuracy_is_repaired_where_jax_raises():
    """Multilabel probabilities (B, C) with labels of the same shape: the
    port thresholds each label at 0.5 and averages over the labels; the
    JAX package argmaxes the rows and then fails on the shapes (a defect
    of the reference the port does not copy)."""
    y = np.array([[1, 0, 1], [0, 0, 1], [1, 1, 0], [0, 1, 0]], np.float32)
    proba = np.array([[0.9, 0.2, 0.4], [0.1, 0.6, 0.7],
                      [0.8, 0.7, 0.1], [0.3, 0.2, 0.6]], np.float32)
    assert metrics.accuracy(y, proba) == pytest.approx(8 / 12)
    assert metrics.get_metric('acc')[1](y, proba) == pytest.approx(8 / 12)
    with pytest.raises(ValueError):
        jax_metrics.accuracy(y, proba)
    # precision over every (example, label) element: 6 predicted, 4 right
    assert metrics.precision(y, proba) == pytest.approx(4 / 6)
    # multiclass probabilities with index labels still argmax
    yi = np.array([0, 2, 1, 2])
    assert metrics.accuracy(yi, proba) == jax_metrics.accuracy(yi, proba)


@pytest.mark.parametrize('task,labels', [
    ('binary', 'int'), ('binary', 'str'), ('multiclass', 'int'),
    ('multiclass', 'str'), ('regression', 'float')])
def test_calc_score_matches_jax(task, labels):
    rng = np.random.default_rng(23)
    n = 120
    names = np.array(['no', 'yes', 'maybe'])
    if task == 'regression':
        y_true = rng.normal(size=n)
        y_pred = y_true + rng.normal(0, 0.3, n)
        y_proba = y_pred
        metric_list = ['mse', 'rmse', 'mae', 'r2']
    else:
        k = 2 if task == 'binary' else 3
        ids = rng.integers(0, k, n)
        y_proba = rng.dirichlet(np.ones(k), n)
        pred_ids = y_proba.argmax(1)
        y_true, y_pred = (names[ids], names[pred_ids]) if labels == 'str' \
            else (ids, pred_ids)
        metric_list = ['AUC', 'accuracy', 'logloss'] if task == 'binary' \
            else ['accuracy', 'logloss']
        if task == 'binary':
            metric_list += ['precision', 'recall', 'f1']
    pos = 'yes' if labels == 'str' and task == 'binary' else None
    got = metrics.calc_score(y_true, y_pred, y_proba, metric_list, task,
                             pos_label=pos)
    expected = jax_metrics.calc_score(y_true, y_pred, y_proba, metric_list,
                                      task, pos_label=pos)
    assert got == expected
