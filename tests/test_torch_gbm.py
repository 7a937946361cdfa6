"""The port's gradient boosting (``deeptables_torch/models/gbm.py`` over
``csrc/gbm_tree.cpp``) against scikit-learn's on the CPU.

Every tree must equal scikit-learn's: ``children_left``/``right``,
``feature`` and ``threshold`` bit for bit, ``value`` within 1e-12
(relative), and ``apply`` exactly. The cases cover the three losses, the
parameters the port takes, both seeds (an int, and ``None`` under
``np.random.seed``), random tables and tables built to tie: duplicated,
binary and constant columns, few distinct values, the two-valued gradient
of a binary task's first stage, and wide values that round when cast to
float32. A hypothesis case draws small tables of few distinct values.
"""

import pickle

import numpy as np
import pytest
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st
from sklearn import ensemble

from deeptables_torch.models import gbm

TASKS = ('binary', 'multiclass', 'regression')
VALUE_RTOL = 1e-12
PARAMS = {
    'default': {},
    'max_leaf_nodes': {'n_estimators': 20, 'max_leaf_nodes': 5,
                       'max_depth': 4, 'random_state': 1},
    'min_samples_leaf': {'n_estimators': 20, 'min_samples_leaf': 7,
                         'random_state': 2},
    'max_features_sqrt': {'n_estimators': 20, 'max_features': 'sqrt',
                          'max_depth': 5, 'random_state': 3},
    'subsample': {'n_estimators': 20, 'subsample': 0.8, 'random_state': 4},
    'global_seed': {'n_estimators': 20, 'max_features': 0.5,
                    'random_state': None},
}


def _table(data, task, n=300, seed=0):
    rs = np.random.RandomState(seed)
    if data == 'random':
        X = rs.randn(n, 6)
        X[:, 5] = rs.exponential(size=n) * 1e3
        signal = X[:, 0] + 0.5 * X[:, 1]
    else:
        # ties: codes with few values, a copy of a column, a binary and a
        # constant column, and wide integers that round in float32
        X = rs.randint(0, 3, size=(n, 7)).astype(np.float64)
        X[:, 3] = X[:, 0]
        X[:, 4] = rs.randint(0, 2, n)
        X[:, 5] = 1.0
        X[:, 6] = 16_777_216 + rs.randint(0, 8, n)
        signal = X[:, 0] + X[:, 4] - 1
    if task == 'binary':
        y = (signal + (0.5 * rs.randn(n) if data == 'random' else 0) > 0)
        y = y.astype(np.int64)
    elif task == 'multiclass':
        y = np.digitize(signal + 0.3 * rs.randn(n), [-1, 0, 1])
    else:
        y = signal + (0.1 * rs.randn(n) if data == 'random' else 0)
    return X, y


def _assert_same_trees(ref, port):
    assert ref.estimators_.shape == port.estimators_.shape
    for (i, k), est in np.ndenumerate(ref.estimators_):
        a, b = est.tree_, port.estimators_[i, k]
        where = f'tree ({i}, {k})'
        for name in ('children_left', 'children_right', 'feature'):
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name),
                                          err_msg=f'{where} {name}')
        np.testing.assert_array_equal(b.threshold.view(np.int64),
                                      a.threshold.view(np.int64),
                                      err_msg=f'{where} threshold bits')
        np.testing.assert_allclose(b.value, a.value[:, 0, 0],
                                   rtol=VALUE_RTOL, atol=0,
                                   err_msg=f'{where} value')


def _fit_both(X, y, task, params):
    name = 'GradientBoostingRegressor' if task == 'regression' \
        else 'GradientBoostingClassifier'
    models = []
    for module in (ensemble, gbm):
        if params.get('random_state') is None:
            np.random.seed(7)
        models.append(getattr(module, name)(**params).fit(X, y))
    return models


@pytest.mark.parametrize('data', ['random', 'ties'])
@pytest.mark.parametrize('case', list(PARAMS))
@pytest.mark.parametrize('task', TASKS)
def test_trees_and_leaves_equal_sklearn(task, case, data):
    X, y = _table(data, task, seed=len(case))
    ref, port = _fit_both(X, y, task, PARAMS[case])
    _assert_same_trees(ref, port)
    held_out, _ = _table(data, task, n=97, seed=99)
    for rows in (X, held_out):
        leaves = port.apply(rows)
        expected = ref.apply(rows)
        assert leaves.dtype == expected.dtype
        np.testing.assert_array_equal(leaves, expected)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_small_tables_of_few_values_equal_sklearn(data):
    n = data.draw(st.integers(4, 40), 'n')
    d = data.draw(st.integers(1, 4), 'features')
    values = data.draw(st.lists(st.sampled_from([-1.5, 0.0, 0.5, 2.0, 1e6]),
                                min_size=n * d, max_size=n * d), 'X')
    X = np.array(values).reshape(n, d)
    task = data.draw(st.sampled_from(TASKS), 'task')
    labels = data.draw(st.lists(st.integers(0, 2), min_size=n, max_size=n),
                       'y')
    y = np.array(labels)
    if task == 'binary':
        y = y % 2
    if task != 'regression':
        assume(len(np.unique(y)) >= 2)
    params = {'n_estimators': 5, 'random_state':
              data.draw(st.integers(0, 2 ** 31 - 1), 'seed'),
              'max_depth': data.draw(st.integers(1, 4), 'depth'),
              'min_samples_leaf': data.draw(st.integers(1, 3), 'leaf')}
    if data.draw(st.booleans(), 'best_first'):
        params['max_leaf_nodes'] = data.draw(st.integers(2, 6), 'leaves')
    ref, port = _fit_both(X, y, task, params)
    _assert_same_trees(ref, port)
    np.testing.assert_array_equal(port.apply(X), ref.apply(X))


@pytest.mark.parametrize('param', [
    {'loss': 'huber'}, {'loss': 'exponential'}, {'n_iter_no_change': 5},
    {'ccp_alpha': 0.1}, {'init': 'zero'}, {'warm_start': True},
    {'min_weight_fraction_leaf': 0.1}])
def test_parameters_not_ported_raise_by_name(param):
    name = next(iter(param))
    for cls in (gbm.GradientBoostingClassifier,
                gbm.GradientBoostingRegressor):
        if param == {'loss': 'exponential'} and \
                cls is gbm.GradientBoostingRegressor:
            continue
        with pytest.raises(NotImplementedError, match=f'{name}.*16b'):
            cls(**param)
    with pytest.raises(TypeError, match='no_such_parameter'):
        gbm.GradientBoostingClassifier(no_such_parameter=1)
    with pytest.raises(NotImplementedError, match='alpha.*16b'):
        gbm.GradientBoostingRegressor(alpha=0.5)
    gbm.GradientBoostingRegressor(alpha=0.9, ccp_alpha=0.0, init=None)


def test_missing_values_are_refused_and_models_pickle():
    X, y = _table('random', 'binary')
    bad = X.copy()
    bad[3, 2] = np.nan
    with pytest.raises(ValueError, match='NaN'):
        gbm.GradientBoostingClassifier(n_estimators=2).fit(bad, y)
    model = gbm.GradientBoostingClassifier(n_estimators=3,
                                           random_state=0).fit(X, y)
    again = pickle.loads(pickle.dumps(model))
    np.testing.assert_array_equal(again.apply(X), model.apply(X))
