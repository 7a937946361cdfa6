"""The port's gradient boosting (``deeptables_torch/models/gbm.py`` over
``csrc/gbm_tree.cpp``) against scikit-learn's on the CPU.

Every tree must equal scikit-learn's: ``children_left``/``right``,
``feature`` and ``threshold`` bit for bit, ``value`` within 1e-12
(relative), and ``apply`` exactly. The cases cover every loss (log loss,
exponential; squared, absolute, Huber and quantile error), every option of
the constructors (``init``, ``min_weight_fraction_leaf``, ``ccp_alpha``,
early stopping, ``warm_start``, ``verbose``, ``criterion`` beside the tree
parameters and ``subsample``), both seeds (an int, and ``None`` under
``np.random.seed``), random tables and tables built to tie: duplicated,
binary and constant columns, few distinct values, the two-valued gradient
of a binary task's first stage, and wide values that round when cast to
float32. Hypothesis cases draw small tables of few distinct values. The
JAX package's ``GbmLeavesEncoder`` over scikit-learn gives the port's
leaves with each option.
"""

import contextlib
import io
import pickle
import re
import warnings

import numpy as np
import pandas as pd
import pytest
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st
from sklearn import ensemble, linear_model

from deeptables_torch.models import gbm
from deeptables_torch.models import transformers
from deeptables_tpu.models import transformers as jax_transformers

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
        kwargs = {k: (v() if callable(v) else v) for k, v in params.items()}
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', FutureWarning)
            models.append(getattr(module, name)(**kwargs).fit(X, y))
    return models


# every option beside the defaults, with the classes that take it (an init
# estimator is made anew for each fit)
OPTIONS = {
    'exponential': (('binary',), {'loss': 'exponential', 'n_estimators': 15,
                                  'random_state': 0}),
    'exponential_subsample': (('binary',), {
        'loss': 'exponential', 'n_estimators': 15, 'subsample': 0.7,
        'random_state': 1}),
    'absolute_error': (('regression',), {'loss': 'absolute_error',
                                         'n_estimators': 15,
                                         'random_state': 0}),
    'huber': (('regression',), {'loss': 'huber', 'n_estimators': 15,
                                'random_state': 0}),
    'huber_alpha_subsample': (('regression',), {
        'loss': 'huber', 'alpha': 0.6, 'n_estimators': 15, 'subsample': 0.8,
        'random_state': 2}),
    'quantile': (('regression',), {'loss': 'quantile', 'alpha': 0.3,
                                   'n_estimators': 15, 'random_state': 0}),
    'quantile_best_first': (('regression',), {
        'loss': 'quantile', 'alpha': 0.8, 'max_leaf_nodes': 6,
        'n_estimators': 15, 'random_state': 0}),
    'init_zero': (TASKS, {'init': 'zero', 'n_estimators': 10,
                          'random_state': 0}),
    'init_estimator': (TASKS, {'init': 'estimator', 'n_estimators': 10,
                               'random_state': 0}),
    'min_weight_fraction_leaf': (TASKS, {
        'min_weight_fraction_leaf': 0.1, 'n_estimators': 10,
        'random_state': 0}),
    'min_weight_fraction_subsample': (TASKS, {
        'min_weight_fraction_leaf': 0.05, 'subsample': 0.6,
        'n_estimators': 10, 'random_state': 0}),
    'ccp_alpha': (TASKS, {'ccp_alpha': 0.002, 'max_depth': 6,
                          'n_estimators': 6, 'random_state': 0}),
    'ccp_alpha_best_first': (TASKS, {
        'ccp_alpha': 0.01, 'max_leaf_nodes': 12, 'max_depth': None,
        'n_estimators': 5, 'random_state': 0}),
    'n_iter_no_change': (TASKS, {'n_iter_no_change': 3, 'n_estimators': 200,
                                 'learning_rate': 0.3, 'random_state': 0}),
    'n_iter_no_change_tol': (TASKS, {
        'n_iter_no_change': 2, 'validation_fraction': 0.2, 'tol': 1e-3,
        'n_estimators': 200, 'random_state': 3}),
    'n_iter_no_change_global_seed': (TASKS, {
        'n_iter_no_change': 3, 'n_estimators': 200, 'random_state': None}),
    'huber_n_iter_no_change': (('regression',), {
        'loss': 'huber', 'n_iter_no_change': 4, 'n_estimators': 300,
        'random_state': 0}),
    'exponential_n_iter_no_change': (('binary',), {
        'loss': 'exponential', 'n_iter_no_change': 3, 'n_estimators': 200,
        'random_state': 0}),
    'criterion_friedman_mse': (TASKS, {'criterion': 'friedman_mse',
                                       'n_estimators': 5, 'random_state': 0}),
    'criterion_squared_error': (TASKS, {'criterion': 'squared_error',
                                        'n_estimators': 5,
                                        'random_state': 0}),
}


def _init_estimator(task):
    """A factory of scikit-learn's init estimators for ``task``: each
    package fits its own."""
    if task == 'regression':
        return linear_model.LinearRegression
    return lambda: linear_model.LogisticRegression(max_iter=200)


def _option_params(task, option):
    params = dict(OPTIONS[option][1])
    if params.get('init') == 'estimator':
        params['init'] = _init_estimator(task)
    return params


CASES = [(task, option) for option, (tasks, _) in OPTIONS.items()
         for task in tasks]


@pytest.mark.parametrize('data', ['random', 'ties'])
@pytest.mark.parametrize('task, option', CASES)
def test_option_trees_and_leaves_equal_sklearn(task, option, data):
    """Each option for each class that takes it: the trees, ``apply`` on
    the training and held-out rows, the stages early stopping keeps and
    ``train_score_`` (and ``oob_scores_``) equal scikit-learn's."""
    X, y = _table(data, task, seed=len(option))
    ref, port = _fit_both(X, y, task, _option_params(task, option))
    _assert_same_trees(ref, port)
    held_out, _ = _table(data, task, n=97, seed=99)
    for rows in (X, held_out):
        np.testing.assert_array_equal(port.apply(rows), ref.apply(rows))
    assert port.n_estimators_ == ref.n_estimators_
    np.testing.assert_allclose(port.train_score_, ref.train_score_,
                               rtol=1e-12)
    if hasattr(ref, 'oob_scores_'):
        np.testing.assert_allclose(port.oob_scores_, ref.oob_scores_,
                                   rtol=1e-12)
        np.testing.assert_allclose(port.oob_improvement_,
                                   ref.oob_improvement_, rtol=1e-9,
                                   atol=1e-15)
    if 'n_iter_no_change' in option:
        assert ref.n_estimators_ < OPTIONS[option][1]['n_estimators']
    if 'ccp_alpha' in option and data == 'random':  # the pruning pruned
        unpruned = type(port)(**dict(_option_params(task, option),
                                     ccp_alpha=0.0)).fit(X, y)
        assert sum(t.node_count for t in port.estimators_.ravel()) < \
            sum(t.node_count for t in unpruned.estimators_.ravel())


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


WARM_STARTS = [(task, options) for task in TASKS for options in (
    {}, {'subsample': 0.7}, {'n_iter_no_change': 2, 'learning_rate': 0.5})
] + [('regression', {'loss': 'huber'}), ('binary', {'loss': 'exponential'})]


@pytest.mark.parametrize('task, options', WARM_STARTS)
def test_warm_start_adds_stages_as_sklearn(task, options):
    """Fit 5 stages, then 8 more with ``warm_start``: the same trees as
    scikit-learn's (``_resize_state``; the random stream carries on)."""
    X, y = _table('random', task, seed=11)
    name = 'GradientBoostingRegressor' if task == 'regression' \
        else 'GradientBoostingClassifier'
    models = []
    for module in (ensemble, gbm):
        model = getattr(module, name)(n_estimators=5, warm_start=True,
                                      random_state=3, **options)
        model.fit(X, y)
        first = model.estimators_.shape[0]
        model.n_estimators = first + 8
        model.fit(X, y)
        models.append((model, first))
    (ref, ref_first), (port, port_first) = models
    assert ref_first == port_first
    _assert_same_trees(ref, port)
    np.testing.assert_allclose(port.train_score_, ref.train_score_,
                               rtol=1e-12)
    np.testing.assert_array_equal(port.apply(X), ref.apply(X))
    port.n_estimators = 2
    with pytest.raises(ValueError, match='warm_start'):
        port.fit(X, y)


def _lines(fit):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fit()
    # the time column varies
    return [re.sub(r'\s+[0-9.]+[sm]$', '', line)
            for line in out.getvalue().splitlines()]


@pytest.mark.parametrize('verbose', [1, 2])
@pytest.mark.parametrize('subsample', [1.0, 0.8])
def test_verbose_lines_equal_sklearns(verbose, subsample):
    """``VerboseReporter``'s header and stage lines (iteration, train loss,
    OOB improvement), the remaining-time column aside."""
    X, y = _table('random', 'binary', seed=5)
    params = dict(n_estimators=25, verbose=verbose, subsample=subsample,
                  random_state=0)
    ref = _lines(lambda: ensemble.GradientBoostingClassifier(**params)
                 .fit(X, y))
    port = _lines(lambda: gbm.GradientBoostingClassifier(**params)
                  .fit(X, y))
    assert port == ref
    # a header, then every stage, or stages 1-10 and 20
    assert len(ref) == (26 if verbose == 2 else 12)


def test_criterion_warns_as_sklearn():
    X, y = _table('random', 'regression')
    for module in (ensemble, gbm):
        with pytest.warns(FutureWarning, match='`criterion` is deprecated'):
            module.GradientBoostingRegressor(
                criterion='friedman_mse', n_estimators=2).fit(X, y)


@pytest.mark.parametrize('case', ['unknown_keyword', 'unknown_loss',
                                  'exponential_multiclass', 'criterion',
                                  'classifier_alpha'])
def test_invalid_parameters_raise(case):
    X, y = _table('random', 'multiclass')
    if case == 'unknown_keyword':
        with pytest.raises(TypeError, match='no_such_parameter'):
            gbm.GradientBoostingClassifier(no_such_parameter=1)
    elif case == 'unknown_loss':
        with pytest.raises(ValueError, match='loss'):
            gbm.GradientBoostingRegressor(loss='log_loss')
    elif case == 'exponential_multiclass':
        for module in (ensemble, gbm):
            with pytest.raises(ValueError, match='n_classes=4'):
                module.GradientBoostingClassifier(
                    loss='exponential', n_estimators=2).fit(X, y)
    elif case == 'criterion':
        with pytest.raises(ValueError, match='criterion'):
            gbm.GradientBoostingClassifier(criterion='absolute_error')
    else:  # the classifier takes no alpha, as scikit-learn's
        with pytest.raises(TypeError, match='alpha'):
            gbm.GradientBoostingClassifier(alpha=0.5)


@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_small_tables_with_options_equal_sklearn(data):
    """A drawn option on a drawn small table of few distinct values."""
    n = data.draw(st.integers(12, 40), 'n')
    d = data.draw(st.integers(1, 3), 'features')
    values = data.draw(st.lists(st.sampled_from([-1.5, 0.0, 0.5, 2.0, 1e6]),
                                min_size=n * d, max_size=n * d), 'X')
    X = np.array(values).reshape(n, d)
    task = data.draw(st.sampled_from(TASKS), 'task')
    labels = data.draw(st.lists(st.integers(0, 2), min_size=n, max_size=n),
                       'y')
    y = np.array(labels, dtype=float)
    if task == 'binary':
        y = y % 2
    if task != 'regression':
        assume(len(np.unique(y)) >= 2)
    options = [o for o, (tasks, p) in OPTIONS.items() if task in tasks
               and 'n_iter_no_change' not in p and p.get('init') is None]
    option = data.draw(st.sampled_from(options), 'option')
    params = dict(OPTIONS[option][1], n_estimators=4,
                  random_state=data.draw(st.integers(0, 2 ** 31 - 1),
                                         'seed'))
    if task == 'regression':
        y = y + data.draw(st.sampled_from([0.0, 0.25]), 'shift') * \
            np.arange(n)
    ref, port = _fit_both(X, y, task, params)
    _assert_same_trees(ref, port)
    np.testing.assert_array_equal(port.apply(X), ref.apply(X))


ENCODER_OPTIONS = ['exponential', 'huber', 'quantile', 'absolute_error',
                   'ccp_alpha', 'n_iter_no_change', 'init_zero',
                   'min_weight_fraction_subsample']


@pytest.mark.parametrize('option', ENCODER_OPTIONS)
def test_jax_encoders_leaves_equal_the_ports(option):
    """The JAX package's ``GbmLeavesEncoder`` over scikit-learn and the
    port's over ``models/gbm.py``, with the option in ``gbm_params``: the
    same ``gbm_leaf_*`` columns."""
    tasks, params = OPTIONS[option]
    task = 'binary' if 'binary' in tasks else 'regression'
    X, y = _table('random', task, n=400, seed=21)
    frame = pd.DataFrame({f'c{j}': X[:, j] for j in range(X.shape[1])})
    params = {k: v for k, v in params.items() if k != 'n_estimators'}
    out = []
    for module in (jax_transformers, transformers):
        encoder = module.GbmLeavesEncoder([], list(frame.columns), task,
                                          **params)
        encoder.backend = 'sklearn'
        table = encoder.fit_transform(frame.copy(), y)
        out.append(np.column_stack([np.asarray(table[c])
                                    for c in encoder.new_columns]))
    assert out[0].shape == out[1].shape and out[0].shape[1] >= 1
    np.testing.assert_array_equal(out[1], out[0])


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
