# -*- coding:utf-8 -*-
"""The port's AutoML layer (``deeptables_torch.models.hyper_dt``), the twin
of ``tests/test_hyper_dt.py``: the same samples and compiled configs as
the JAX package's from one seed, field by field (both draw from numpy in
one order, so they are equal, not close); then searches, final training,
export and ``make_experiment`` through the port's ``DeepTable`` on the CPU,
checked by behaviour and by the reward's direction (trained numbers differ
from the JAX package's by initialisation)."""

import dataclasses

import numpy as np
import pytest

from deeptables_torch.data.datasets import load_boston, load_heart_disease_uci
from deeptables_torch.models import hyper_dt
from deeptables_torch.models.hyper_dt import (EvolutionSearcher, HyperDT,
                                              RandomSearcher, Trial,
                                              compile_dnn_params,
                                              make_experiment, mini_dt_space,
                                              mini_dt_space_validator,
                                              sample_to_config, tiny_dt_space)
from deeptables_tpu.models import hyper_dt as jax_hyper_dt


@pytest.fixture(scope='module')
def data():
    df = load_heart_disease_uci(400)
    y = df.pop('target')
    return df, y


def _same_config(conf, jax_conf):
    names = [f.name for f in dataclasses.fields(jax_conf)]
    assert names == [f.name for f in dataclasses.fields(conf)]
    for name in names:
        assert getattr(conf, name) == getattr(jax_conf, name), name


SPACES = {'mini': (mini_dt_space, 'mini_dt_space_validator'),
          'tiny': (tiny_dt_space, None),
          'default': (hyper_dt.default_dt_space, None)}


@pytest.mark.parametrize('space', list(SPACES))
def test_samples_and_configs_equal_the_jax_package(space):
    space_fn, validator = SPACES[space]
    jax_space_fn = getattr(jax_hyper_dt, space_fn.__name__)
    ours = RandomSearcher(space_fn, space_sample_validation_fn=validator and
                          getattr(hyper_dt, validator), seed=5)
    theirs = jax_hyper_dt.RandomSearcher(
        jax_space_fn, space_sample_validation_fn=validator and
        getattr(jax_hyper_dt, validator), seed=5)
    for _ in range(25):
        sample, jax_sample = ours.sample(), theirs.sample()
        assert sample == jax_sample
        _same_config(sample_to_config(sample, metrics=['AUC']),
                     jax_hyper_dt.sample_to_config(jax_sample,
                                                   metrics=['AUC']))


def test_evolution_samples_equal_the_jax_package():
    """Given the same trials and rewards, the evolution searchers mutate
    the same elites the same way."""
    ours = EvolutionSearcher(mini_dt_space, population_size=3, seed=2)
    theirs = jax_hyper_dt.EvolutionSearcher(jax_hyper_dt.mini_dt_space,
                                            population_size=3, seed=2)
    rewards = np.random.default_rng(0).uniform(size=12)
    for i, reward in enumerate(rewards):
        sample, jax_sample = ours.sample(), theirs.sample()
        assert sample == jax_sample
        ours.update(Trial(i, sample, reward=float(reward)))
        theirs.update(jax_hyper_dt.Trial(i, jax_sample, reward=float(reward)))
        assert [t.sample for t in ours.elites] == \
            [t.sample for t in theirs.elites]


class TestSpaces:
    def test_sampling_and_compile(self):
        searcher = RandomSearcher(mini_dt_space,
                                  space_sample_validation_fn=
                                  mini_dt_space_validator, seed=1)
        for _ in range(20):
            s = searcher.sample()
            assert s['config']['nets'] != ['fm_nets']
            conf = sample_to_config(s, metrics=['AUC'])
            assert len(conf.dnn_params['hidden_units']) == 2

    def test_dnn_geometry(self):
        dnn = {'hidden_units': 100, 'reduce_factor': 0.5, 'dnn_dropout': 0.1,
               'use_bn': True, 'dnn_layers': 3, 'activation': 'relu'}
        params = compile_dnn_params(dnn)
        assert params['hidden_units'] == ((100, 0.1, True), (50, 0.1, True),
                                          (25, 0.1, True))
        assert params == jax_hyper_dt.compile_dnn_params(dnn)


class TestSearch:
    def test_random_search(self, data, tmp_path):
        df, y = data
        hdt = HyperDT(space_fn=tiny_dt_space, reward_metric='AUC',
                      earlystopping_patience=1, device='cpu')
        best = hdt.search(df, y, max_trials=3, epochs=1, verbose=0,
                          trial_store_dir=str(tmp_path))
        assert best is not None and best.succeeded
        assert np.isfinite(best.reward)
        assert len(hdt.history) == 3
        # AUC: the best reward is the largest observed
        assert best.reward == max(t.reward for t in hdt.history
                                  if t.succeeded)
        board = hdt.leaderboard()
        assert len(board) == 3 and board['reward'].iloc[0] == best.reward
        # best-trial reload
        est = hdt.load_estimator(best.model_path)
        proba = est.predict_proba(df.head(20))
        assert proba.shape == (20, 2)
        np.testing.assert_allclose(
            proba, hdt.best_estimator.predict_proba(df.head(20)), atol=1e-6)

    def test_final_train(self, data):
        df, y = data
        hdt = HyperDT(space_fn=tiny_dt_space, reward_metric='AUC',
                      device='cpu')
        hdt.search(df, y, max_trials=2, epochs=1, verbose=0)
        est = hdt.final_train(df, y, epochs=1, verbose=0)
        assert est is hdt.best_estimator
        assert est.space_sample == hdt.best_trial.sample
        assert est.predict_proba(df.head(10)).shape == (10, 2)

    def test_final_train_needs_a_trial(self, data):
        df, y = data
        hdt = HyperDT(space_fn=tiny_dt_space, reward_metric='AUC',
                      device='cpu')
        with pytest.raises(ValueError, match='No successful trial'):
            hdt.final_train(df, y)

    def test_export_trial_configuration(self, data):
        df, y = data
        hdt = HyperDT(space_fn=tiny_dt_space, reward_metric='AUC',
                      device='cpu')
        hdt.search(df, y, max_trials=1, epochs=1, verbose=0)
        desc = hdt.export_trial_configuration(hdt.best_trial)
        assert 'ModelConfig(' in desc
        assert 'dnn_params=' in desc and 'fit params:' in desc

    def test_evolution_searcher(self, data):
        df, y = data
        searcher = EvolutionSearcher(tiny_dt_space, population_size=2)
        hdt = HyperDT(searcher=searcher, reward_metric='AUC', device='cpu')
        hdt.search(df, y, max_trials=3, epochs=1, verbose=0)
        assert hdt.best_trial is not None
        assert len(searcher.elites) == 2
        assert searcher.elites[0].reward >= searcher.elites[1].reward


class TestExperiment:
    def test_make_experiment(self, data):
        df, y = data
        train = df.copy()
        train['target'] = y
        exp = make_experiment(train, target='target', reward_metric='AUC',
                              search_space=tiny_dt_space, max_trials=2,
                              epochs=1, verbose=0, device='cpu')
        est = exp.run()
        proba = est.predict_proba(df.head(10))
        assert proba.shape == (10, 2)

    def test_make_experiment_cv(self, data):
        df, y = data
        train = df.copy()
        train['target'] = y
        exp = make_experiment(train, target='target', reward_metric='AUC',
                              search_space=tiny_dt_space, max_trials=1,
                              cv=True, num_folds=2, epochs=1, verbose=0,
                              device='cpu')
        est = exp.run()
        assert est.model.task == 'binary'
        assert 0 <= exp.hyper_model.best_trial.reward <= 1

    def test_lazy_entry_points(self, data):
        import deeptables_torch
        from deeptables_torch import models
        assert deeptables_torch.make_experiment is models.make_experiment
        df, y = data
        train = df.copy()
        train['target'] = y
        exp = models.make_experiment(train, target='target',
                                     reward_metric='AUC', max_trials=1,
                                     search_space=tiny_dt_space,
                                     device='cpu')
        assert isinstance(exp, hyper_dt.Experiment)


class TestRegressionSearch:
    """The twin of the JAX package's boston search: an RMSE reward
    (minimised), then final_train and evaluate."""

    def test_boston_rmse(self):
        from sklearn.model_selection import train_test_split

        df = load_boston(400)
        y = df.pop('target')
        X_train, X_test, y_train, y_test = train_test_split(
            df, y, test_size=0.2, random_state=42)

        hdt = HyperDT(space_fn=tiny_dt_space,
                      reward_metric='RootMeanSquaredError', device='cpu')
        assert not hdt._greater_is_better
        best = hdt.search(X_train, y_train, X_test, y_test,
                          max_trials=3, epochs=1, verbose=0)
        assert best is not None and best.succeeded
        assert np.isfinite(best.reward)
        # minimize: best reward is the smallest observed
        rewards = [t.reward for t in hdt.history if t.succeeded]
        assert best.reward == min(rewards)

        est = hdt.final_train(df, y, epochs=1, verbose=0)
        assert est.model.task == 'regression'
        pred = est.predict(X_test.head(10))
        assert pred.shape[0] == 10
        scores = est.evaluate(X_test, y_test)
        assert any(k.lower() == 'rootmeansquarederror' for k in scores)
