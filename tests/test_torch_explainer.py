# -*- coding:utf-8 -*-
"""The port's ``DeepTablesExplainer`` (``deeptables_torch/utils/shap.py``),
Kernel SHAP without the ``shap`` package, against the JAX package.

The JAX explainer wraps ``shap``, which the tests do not need, so it is
not run; what it would compute is known exactly where the coalition space is
enumerated (``'auto'`` does so for M <= 11 varying features): the Shapley
values of ``v(S) = mean_b f(x_S, b_S')`` over the background, with ``f``
the JAX ``DeepTable``'s ``predict(frame, encode_to_label=False)`` on the
frame shap's ``predict_fn`` builds (``pd.DataFrame(matrix)``). So:

- the background is pandas' ``sample(num_samples, random_state=9527)``;
- the port's ``predict_fn`` equals the JAX path on a coalition design, the
  JAX ``DeepTable``'s weights bridged into the port's (hard classes equal
  but on rows whose JAX probability lies within 1e-5 of 0.5, the bridged
  probabilities' tolerance);
- binary, multiclass and regression models on <= 11 columns: the port's
  values equal brute-force Shapley values over the JAX predictions (atol
  1e-9 on hard classes, 1e-4 of the target's spread on a regression);
- the sampled regime (M = 15, 2078 coalitions, the AIC lasso) keeps
  efficiency, ``sum(phi) = f(x) - E f``, to 1e-9;
- the lasso selection's support and coefficients equal scikit-learn's
  ``LassoLarsIC`` (behind ``StandardScaler(with_mean=False)``, as shap fits
  it) and ``lars_path``'s active set on the augmented designs the explainer
  builds (coefficients rtol 1e-8);
- ``nsamples = 2**M - 2`` at M = 12, where ``'auto'`` samples, gives the
  exact values (atol 1e-12 of the largest);
- the varying-feature rule (``np.isclose`` on numbers, ``==`` else) and
  shap's output shapes.
"""

import itertools
import math

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from deeptables_torch import bridge
from deeptables_torch.data import columns as cl
from deeptables_torch.data.datasets import (load_bank, load_boston,
                                            load_glass_uci)
from deeptables_torch.models import DeepTable, ModelConfig
from deeptables_torch.utils import shap

BANK8 = ['age', 'job', 'marital', 'balance', 'housing', 'loan', 'day',
         'duration']
BOSTON9 = ['CRIM', 'ZN', 'INDUS', 'CHAS', 'NOX', 'RM', 'RAD', 'TAX',
           'LSTAT']
HIDDEN = ((16, 0, False), (8, 0, False))


def _table(task, n):
    if task == 'binary':
        df = load_bank(n)
        return df[BANK8], df['y']
    if task == 'multiclass':
        df = load_glass_uci(n)
        return df.drop(columns=[10]), df[10]
    df = load_boston(n)
    return df[BOSTON9], df['target']


def _conf(task, home):
    kwargs = dict(nets=['dnn_nets'], dnn_params={'hidden_units': HIDDEN},
                  embedding_dropout=0, home_dir=str(home))
    if task == 'regression':
        kwargs.update(task='regression', metrics=['mse'])
    return kwargs


@pytest.fixture(scope='module', params=['binary', 'multiclass',
                                        'regression'])
def bridged(request, tmp_path_factory):
    """A JAX ``DeepTable`` fitted one epoch and the port's with its
    weights."""
    from deeptables_tpu.models import DeepTable as JaxDeepTable
    from deeptables_tpu.models import ModelConfig as JaxModelConfig
    task = request.param
    X, y = _table(task, 300)
    home = tmp_path_factory.mktemp('dt')
    jax_dt = JaxDeepTable(JaxModelConfig(**_conf(task, home / 'jax')))
    jax_dt.fit(X, y, epochs=1, verbose=0)
    port_dt = DeepTable(ModelConfig(**_conf(task, home / 'port')),
                        device='cpu')
    port_dt.fit(X, y, epochs=1, verbose=0)
    pre = port_dt.preprocessor
    port_dt.get_model().module.load_state_dict(bridge.state_dict_from_flax(
        jax.device_get(jax_dt.get_model().variables),
        pre.categorical_columns, pre.continuous_columns, port_dt.config))
    return task, X, y, jax_dt, port_dt


def _jax_f(jax_dt, matrix, columns):
    """The JAX package's ``predict_fn`` (``deeptables_tpu/utils/shap.py``)."""
    df = pd.DataFrame(matrix, columns=columns)
    return np.asarray(jax_dt.predict(df, encode_to_label=False)).reshape(-1)


def _all_masks(M):
    return np.array(list(itertools.product([0.0, 1.0], repeat=M)))


def brute_force(v, M):
    """Shapley values of the value function ``v`` (a dict from a mask tuple
    to a number) over M players."""
    phi = np.zeros(M)
    for mask in itertools.product([0.0, 1.0], repeat=M):
        s = int(sum(mask))
        for i in range(M):
            if mask[i] == 0.0:
                with_i = list(mask)
                with_i[i] = 1.0
                w = math.factorial(s) * math.factorial(M - s - 1) \
                    / math.factorial(M)
                phi[i] += w * (v[tuple(with_i)] - v[mask])
    return phi


def _values_by_mask(ex, f, x, varying):
    masks = _all_masks(len(varying))
    y = f(ex.synthetic_rows(x, varying, masks)).astype(np.float64)
    means = y.reshape(len(masks), -1).mean(axis=1)
    return {tuple(m): means[k] for k, m in enumerate(masks)}


# ------------------------------------------------------------- background

def test_background_is_pandas_sample():
    df = load_bank(500)
    ex = shap.DeepTablesExplainer(_Additive(), df, num_samples=100)
    ref = df.sample(100, random_state=9527)
    assert list(ex.data.index) == list(ref.index)
    np.testing.assert_array_equal(ex.background, np.asarray(ref))
    assert ex.background.dtype == np.asarray(ref).dtype == object
    small = shap.DeepTablesExplainer(_Additive(), df.head(80), 100)
    np.testing.assert_array_equal(small.background, np.asarray(df.head(80)))


# ------------------------------------------------------ against JAX's f

def test_predict_fn_on_a_coalition_design_equals_jax(bridged):
    task, X, _, jax_dt, port_dt = bridged
    ex = shap.DeepTablesExplainer(port_dt, X, num_samples=20)
    x = np.asarray(X)[250]
    varying = shap.varying_features(x, ex.background)
    M = len(varying)
    masks, _ = shap.coalitions(M, min(2 * M + 2048, 2 ** M - 2),
                               np.random.default_rng(1))
    synth = ex.synthetic_rows(x, varying, masks)
    port = ex.predict_fn(synth)
    ref = _jax_f(jax_dt, synth, X.columns)
    assert port.shape == ref.shape == (len(masks) * 20,)
    if task == 'regression':
        np.testing.assert_allclose(port, ref, atol=1e-4 * np.std(ref))
        return
    proba = np.asarray(jax_dt.predict_proba(
        pd.DataFrame(synth, columns=X.columns)))
    if task == 'binary':
        near = np.abs(proba[:, -1] - 0.5) <= 1e-5
    else:
        top2 = np.sort(proba, axis=1)[:, -2:]
        near = (top2[:, 1] - top2[:, 0]) <= 1e-5
    assert near.mean() < 1e-3
    np.testing.assert_array_equal(port[~near], ref[~near])


def test_exact_regime_equals_brute_force_over_jax(bridged):
    task, X, y, jax_dt, port_dt = bridged
    ex = shap.DeepTablesExplainer(port_dt, X, num_samples=12)
    rows = np.asarray(X)[[3, 150, 299]]
    values = ex.get_shap_values(X.iloc[[3, 150, 299]])
    assert values.shape == (3, X.shape[1])
    f = lambda m: _jax_f(jax_dt, m, X.columns)  # noqa: E731
    fnull = float(np.mean(f(ex.background)))
    atol = 1e-9 if task != 'regression' else 1e-4 * float(np.std(y))
    assert abs(ex.expected_value - fnull) <= atol
    for x, phi in zip(rows, values):
        varying = shap.varying_features(x, ex.background)
        assert len(varying) <= 11
        exact = brute_force(_values_by_mask(ex, f, x, varying),
                            len(varying))
        full = np.zeros(X.shape[1])
        full[varying] = exact
        np.testing.assert_allclose(phi, full, rtol=0, atol=atol)


# ------------------------------------------------------- on the port alone

class _Additive:
    """A stand-in ``DeepTable``: ``f`` = weights · the numeric columns +
    products of column pairs, on the frame's float values."""

    def __init__(self, pairs=()):
        self.pairs = pairs

    def predict(self, frame, encode_to_label=False):
        assert encode_to_label is False
        cols = cl.as_columns(frame, rename=False)
        num = [n for n in cols.columns if cols.kinds[n] != 'str']
        a = np.stack([cl.to_float(cols[n]) for n in num], axis=1) \
            if num else np.zeros((cols.n_rows, 1))
        out = a @ np.linspace(0.5, 1.5, a.shape[1])
        for i, j in self.pairs:
            out = out + a[:, i] * a[:, j]
        return out


@pytest.fixture(scope='module')
def bank_port(tmp_path_factory):
    """The port's DeepFM on the full bank table (16 columns), CPU."""
    df = load_bank(400)
    y = df.pop('y')
    torch.manual_seed(0)
    dt = DeepTable(ModelConfig(
        nets=['linear', 'fm_nets', 'dnn_nets'],
        dnn_params={'hidden_units': HIDDEN}, metrics=['AUC'],
        home_dir=str(tmp_path_factory.mktemp('bank'))), device='cpu')
    dt.fit(df, y, epochs=1, verbose=0)
    return dt, df


def test_sampled_regime_keeps_efficiency(bank_port):
    dt, df = bank_port
    ex = shap.DeepTablesExplainer(dt, df, num_samples=10)
    rows = np.asarray(df)[[0, 7]]
    values = ex.get_shap_values(rows)
    fx = ex.predict_fn(rows).astype(np.float64)
    for x, phi, f in zip(rows, values, fx):
        # 'default' is 'no' in all ten background rows
        assert len(shap.varying_features(x, ex.background)) == 15
        assert abs(phi.sum() - (f - ex.expected_value)) <= 1e-9
    # a real-valued f as well: the additive stand-in with interactions
    ex = shap.DeepTablesExplainer(_Additive(((0, 5), (1, 3))), df, 10)
    phi = ex.get_shap_values(rows[0])
    f = ex.predict_fn(rows[:1])[0]
    assert abs(phi.sum() - (f - ex.expected_value)) <= 1e-9


def _designs():
    """The augmented designs the explainer builds for the bank DeepFM's
    hard class and for a real-valued f, M = 15, 2078 coalitions."""
    df = load_bank(400)
    df.pop('y')
    out = []
    for model in (_Additive(((0, 5), (1, 3), (4, 6))), _Additive()):
        ex = shap.DeepTablesExplainer(model, df, num_samples=10)
        x = np.asarray(df)[5]
        varying = shap.varying_features(x, ex.background)
        M = len(varying)
        masks, weights = shap.coalitions(M, 2 * M + 2048, ex.rng)
        y = ex.predict_fn(ex.synthetic_rows(x, varying, masks))
        ey = y.reshape(len(masks), -1).mean(axis=1) - ex.expected_value
        fx = ex.predict_fn(x.reshape(1, -1))[0] - ex.expected_value
        out.append(shap.augmented_design(masks, weights, ey, fx))
    return out


@pytest.mark.parametrize('which', [0, 1])
def test_lasso_selection_equals_scikit_learn(which):
    from sklearn.linear_model import LassoLarsIC, lars_path
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler
    design, target = _designs()[which]
    for criterion in ('aic', 'bic'):
        ref = make_pipeline(StandardScaler(with_mean=False),
                            LassoLarsIC(criterion=criterion)).fit(
            design, target)[1].coef_
        port = shap.lasso_lars_ic(design, target, criterion)
        np.testing.assert_array_equal(np.nonzero(port)[0],
                                      np.nonzero(ref)[0])
        np.testing.assert_allclose(port, ref, rtol=1e-8, atol=1e-12)
    for k in (3, 10):
        assert shap.lars_path(design, target, max_iter=k)[1] == \
            [int(i) for i in lars_path(design, target, max_iter=k)[1]]


def test_full_budget_sampled_path_is_exact(bank_port):
    dt, df = bank_port
    cols = [c for c in df.columns if c not in ('pdays', 'previous',
                                               'poutcome')]
    X = df[cols]
    ex = shap.DeepTablesExplainer(_Additive(((0, 2), (1, 3))), X, 6)
    x = np.asarray(X)[11]
    varying = shap.varying_features(x, ex.background)
    M = len(varying)
    assert M == 12  # 'default' is 'no' in all six background rows
    phi = ex.get_shap_values(x, nsamples=2 ** M - 2)
    exact = brute_force(_values_by_mask(ex, ex.predict_fn, x, varying), M)
    np.testing.assert_allclose(phi[varying], exact, rtol=0,
                               atol=1e-12 * np.abs(exact).max())
    # the same budget through the enumeration of 'auto' at M <= 11
    phi_auto = ex.get_shap_values(x[None, :])[0]
    assert phi_auto.shape == phi.shape


def test_varying_features_and_shapes():
    bg = pd.DataFrame({'a': [1.0, 2.0, 3.0], 'b': [5.0, 5.0, 5.0],
                       'c': ['u', 'v', 'u'], 'd': [7, 7, 7]})
    model = _Additive()
    ex = shap.DeepTablesExplainer(model, bg, num_samples=None)
    # b equal up to np.isclose, d equal: only a and c vary
    x = np.array([4.0, 5.0 + 1e-9, 'u', 7], dtype=object)
    assert shap.varying_features(x, ex.background).tolist() == [0, 2]
    x[1] = 5.0
    phi = ex.get_shap_values(x)
    assert phi.shape == (4,)
    # c is a string f ignores, a alone carries f(x) - E f
    f_x = model.predict(cl.Columns.from_2d(x[None, :], bg.columns))[0]
    np.testing.assert_allclose(phi, [f_x - ex.expected_value, 0, 0, 0],
                               atol=1e-12)
    # one feature varies: it takes everything; none varies: all zero
    only_b = pd.DataFrame({'b': [1.0, 1.0], 'd': [2.0, 3.0]})
    ex1 = shap.DeepTablesExplainer(model, only_b, None)
    phi1 = ex1.get_shap_values(np.array([1.0, 5.0]))
    assert phi1[0] == 0.0 and phi1[1] == pytest.approx(
        model.predict(pd.DataFrame({'b': [1.0], 'd': [5.0]}))[0]
        - ex1.expected_value)
    ex0 = shap.DeepTablesExplainer(model, pd.DataFrame({'b': [1.0, 1.0]}),
                                   None)
    assert ex0.get_shap_values(np.array([1.0])).tolist() == [0.0]
    # frames, Columns and 2-D arrays give (rows, features)
    for X in (bg, cl.as_columns(bg, rename=False), np.asarray(bg)):
        assert ex.get_shap_values(X).shape == (3, 4)
    assert ex.get_shap_values(bg.head(0)).shape == (0, 4)
    with pytest.raises(ValueError, match='l1_reg'):
        ex.get_shap_values(x, l1_reg=0.01)
