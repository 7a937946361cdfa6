# -*- coding:utf-8 -*-
"""AutoML layer: hyperparameter search over ModelConfig + preprocessing
(counterpart of ``deeptables_tpu/models/hyper_dt.py``).

The same search spaces (``default_dt_space``, ``mini_dt_space``,
``tiny_dt_space``, the DnnModule hidden-unit geometry of
``compile_dnn_params`` and the fm-only rejection of
``mini_dt_space_validator``), random and evolution searchers drawing from
numpy in the JAX package's order (one seed gives the same samples in both
packages), a trial store with best-trial reload, and ``make_experiment``,
over the port's ``DeepTable``, on numpy alone like ``DeepTable`` (the
split from ``data.split``, a csv or parquet path read by
``columns.read_csv`` / ``read_parquet``); ``leaderboard`` is a DataFrame
where pandas imports, else ``Columns``. Every ``DeepTable`` a
search builds runs on ``device`` (default: the current CUDA device;
``'cpu'`` runs the plain path).
"""

import copy
import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .config import ModelConfig
from .deeptable import DeepTable
from .preprocessor import DefaultPreprocessor
from ..data import columns as cl
from ..data.split import train_test_split
from ..utils import consts, dt_logging

logger = dt_logging.get_logger(__name__)


# ----------------------------------------------------------------------
# search-space primitives
# ----------------------------------------------------------------------
class ParameterSpace:
    def sample(self, rng):
        raise NotImplementedError

    def grid(self):
        raise NotImplementedError


class Choice(ParameterSpace):
    def __init__(self, options):
        self.options = list(options)

    def sample(self, rng):
        return self.options[rng.integers(0, len(self.options))]

    def grid(self):
        return list(self.options)

    def __repr__(self):
        return f'Choice({self.options})'


class Bool(Choice):
    def __init__(self):
        super().__init__([True, False])


class MultipleChoice(ParameterSpace):
    def __init__(self, options, num_chosen_most=None, num_chosen_least=1):
        self.options = list(options)
        self.num_chosen_most = num_chosen_most or len(self.options)
        self.num_chosen_least = num_chosen_least

    def sample(self, rng):
        k = int(rng.integers(self.num_chosen_least,
                             self.num_chosen_most + 1))
        idx = rng.choice(len(self.options), size=k, replace=False)
        return [self.options[i] for i in sorted(idx)]

    def grid(self):
        # grid over single choices + the full set (combinatorial otherwise)
        return [[o] for o in self.options] + [list(self.options)]

    def __repr__(self):
        return f'MultipleChoice({self.options}, most={self.num_chosen_most})'


class Int(ParameterSpace):
    def __init__(self, low, high):
        self.low, self.high = int(low), int(high)

    def sample(self, rng):
        return int(rng.integers(self.low, self.high + 1))

    def grid(self):
        return list(range(self.low, self.high + 1))


class Real(ParameterSpace):
    def __init__(self, low, high, log=False):
        self.low, self.high, self.log = float(low), float(high), log

    def sample(self, rng):
        if self.log:
            return float(np.exp(rng.uniform(np.log(self.low),
                                            np.log(self.high))))
        return float(rng.uniform(self.low, self.high))

    def grid(self):
        return list(np.linspace(self.low, self.high, 5))


def _sample_tree(spec, rng):
    if isinstance(spec, ParameterSpace):
        return spec.sample(rng)
    if isinstance(spec, dict):
        return {k: _sample_tree(v, rng) for k, v in spec.items()}
    return spec


# ----------------------------------------------------------------------
# space definitions (mirroring reference hyper_dt.py:295-380)
# ----------------------------------------------------------------------
def _dnn_module(hidden_units=None, reduce_factor=None, dnn_dropout=None,
                use_bn=None, dnn_layers=None, activation='relu'):
    return {
        'hidden_units': Choice([100, 200, 300, 500, 800, 1000])
        if hidden_units is None else _to_hp(hidden_units),
        'reduce_factor': Choice([1, 0.8, 0.5])
        if reduce_factor is None else _to_hp(reduce_factor),
        'dnn_dropout': Choice([0, 0.1, 0.3, 0.5])
        if dnn_dropout is None else _to_hp(dnn_dropout),
        'use_bn': Bool() if use_bn is None else _to_hp(use_bn),
        'dnn_layers': Choice([1, 2, 3])
        if dnn_layers is None else _to_hp(dnn_layers),
        'activation': activation,
    }


def _to_hp(v):
    if isinstance(v, ParameterSpace):
        return v
    if isinstance(v, (list, tuple)):
        return Choice(v)
    return v


def compile_dnn_params(dnn_sample: dict) -> dict:
    """DnnModule geometry (reference hyper_dt.py:99-112): layer i gets
    ``hidden_units * reduce_factor**i`` units."""
    layers = int(dnn_sample['dnn_layers'])
    units0 = dnn_sample['hidden_units']
    rf = dnn_sample['reduce_factor']
    hidden_units = []
    for i in range(layers):
        units = int(units0 if i == 0 else units0 * (rf ** i))
        hidden_units.append((units, dnn_sample['dnn_dropout'],
                             dnn_sample['use_bn']))
    return {'hidden_units': tuple(hidden_units),
            'activation': dnn_sample.get('activation', 'relu')}


def default_dt_space(**fit_hyperparams):
    return {
        'config': {
            'nets': MultipleChoice(
                ['dnn_nets', 'linear', 'cin_nets', 'fm_nets', 'afm_nets',
                 'pnn_nets', 'cross_nets', 'cross_dnn_nets', 'dcn_nets',
                 'autoint_nets', 'fgcnn_dnn_nets', 'fibi_dnn_nets'],
                num_chosen_most=3),
            'auto_categorize': Bool(),
            'cat_remain_numeric': Bool(),
            'auto_discrete': Bool(),
            'apply_gbm_features': Bool(),
            'gbm_feature_type': Choice([consts.GBM_FEATURE_TYPE_DENSE,
                                        consts.GBM_FEATURE_TYPE_EMB]),
            'embeddings_output_dim': Choice([4, 10, 20]),
            'embedding_dropout': Choice([0, 0.1, 0.2, 0.3, 0.4, 0.5]),
            'stacking_op': Choice([consts.STACKING_OP_ADD,
                                   consts.STACKING_OP_CONCAT]),
            'output_use_bias': Bool(),
            'apply_class_weight': Bool(),
            'earlystopping_patience': Choice([1, 3, 5]),
        },
        'dnn': _dnn_module(),
        'fit': {k: _to_hp(v) for k, v in fit_hyperparams.items()},
    }


def mini_dt_space(**fit_hyperparams):
    return {
        'config': {
            'nets': MultipleChoice(['dnn_nets', 'linear', 'fm_nets'],
                                   num_chosen_most=2),
            'auto_categorize': Bool(),
            'cat_remain_numeric': Bool(),
            'auto_discrete': Bool(),
            'apply_gbm_features': Bool(),
            'gbm_feature_type': Choice([consts.GBM_FEATURE_TYPE_DENSE,
                                        consts.GBM_FEATURE_TYPE_EMB]),
            'embeddings_output_dim': Choice([4, 10]),
            'embedding_dropout': Choice([0, 0.5]),
            'stacking_op': Choice([consts.STACKING_OP_ADD,
                                   consts.STACKING_OP_CONCAT]),
            'output_use_bias': Bool(),
            'apply_class_weight': Bool(),
            'earlystopping_patience': Choice([1, 3, 5]),
        },
        'dnn': _dnn_module(hidden_units=Choice([100, 200]),
                           reduce_factor=Choice([1, 0.8]),
                           dnn_dropout=Choice([0, 0.3]),
                           use_bn=Bool(), dnn_layers=2,
                           activation='relu'),
        'fit': {k: _to_hp(v) for k, v in fit_hyperparams.items()},
    }


def mini_dt_space_validator(sample: dict) -> bool:
    """Reject fm-only samples (reference hyper_dt.py:352-354)."""
    return sample['config']['nets'] != ['fm_nets']


def tiny_dt_space(**fit_hyperparams):
    fit_hyperparams.setdefault('batch_size', [64, 100])
    return {
        'config': {
            'nets': ['dnn_nets'],
            'auto_categorize': Bool(),
            'cat_remain_numeric': Bool(),
            'auto_discrete': False,
            'apply_gbm_features': False,
            'stacking_op': Choice([consts.STACKING_OP_ADD,
                                   consts.STACKING_OP_CONCAT]),
            'output_use_bias': Bool(),
            'apply_class_weight': Bool(),
            'earlystopping_patience': Choice([1, 3, 5]),
        },
        'dnn': _dnn_module(hidden_units=Choice([10, 20]), reduce_factor=1,
                           dnn_dropout=Choice([0, 0.3]), use_bn=False,
                           dnn_layers=2, activation='relu'),
        'fit': {k: _to_hp(v) for k, v in fit_hyperparams.items()},
    }


def sample_to_config(sample: dict, **config_kwargs) -> ModelConfig:
    """Compile a sampled space into a ModelConfig
    (parity: DTModuleSpace._compile + DnnModule._compile)."""
    cfg_kwargs = dict(sample['config'])
    cfg_kwargs['dnn_params'] = compile_dnn_params(sample['dnn'])
    cfg_kwargs.update(config_kwargs)
    return ModelConfig(**cfg_kwargs)


# ----------------------------------------------------------------------
# searchers
# ----------------------------------------------------------------------
class RandomSearcher:
    def __init__(self, space_fn, space_sample_validation_fn=None, seed=9527,
                 max_rejects=100):
        self.space_fn = space_fn
        self.validation_fn = space_sample_validation_fn
        self.rng = np.random.default_rng(seed)
        self.max_rejects = max_rejects

    def sample(self, history=None):
        spec = self.space_fn() if callable(self.space_fn) else self.space_fn
        for _ in range(self.max_rejects):
            s = _sample_tree(spec, self.rng)
            if self.validation_fn is None or self.validation_fn(s):
                return s
        raise RuntimeError('Could not sample a valid configuration.')

    def update(self, trial):
        pass


class EvolutionSearcher(RandomSearcher):
    """(μ+λ)-style: mutate one field of a random elite sample."""

    def __init__(self, space_fn, population_size=5, **kwargs):
        super().__init__(space_fn, **kwargs)
        self.population_size = population_size
        self.elites: List['Trial'] = []

    def sample(self, history=None):
        if len(self.elites) < 2:
            return super().sample(history)
        spec = self.space_fn() if callable(self.space_fn) else self.space_fn
        parent = self.elites[int(self.rng.integers(0, len(self.elites)))]
        child = copy.deepcopy(parent.sample)
        # mutate one random leaf
        section = ['config', 'dnn'][int(self.rng.integers(0, 2))]
        keys = [k for k, v in spec[section].items()
                if isinstance(v, ParameterSpace)]
        if keys:
            k = keys[int(self.rng.integers(0, len(keys)))]
            child[section][k] = spec[section][k].sample(self.rng)
        if self.validation_fn is not None and not self.validation_fn(child):
            return super().sample(history)
        return child

    def update(self, trial):
        self.elites.append(trial)
        self.elites.sort(key=lambda t: t.reward, reverse=True)
        self.elites = self.elites[:self.population_size]


# ----------------------------------------------------------------------
# trials / estimator / HyperDT
# ----------------------------------------------------------------------
@dataclass
class Trial:
    trial_no: int
    sample: dict
    reward: float = float('nan')
    scores: dict = field(default_factory=dict)
    elapsed: float = 0.0
    model_path: Optional[str] = None
    succeeded: bool = False
    message: str = ''


class DTEstimator:
    """Wrap a DeepTable built from a sampled config
    (parity: reference DTEstimator at hyper_dt.py:121-255)."""

    def __init__(self, space_sample: dict, cache_preprocessed_data=False,
                 device=None, **config_kwargs):
        self.space_sample = space_sample
        self.config_kwargs = config_kwargs
        config = sample_to_config(space_sample, **config_kwargs)
        preprocessor = DefaultPreprocessor(config) \
            if cache_preprocessed_data else None
        self.model = DeepTable(config, preprocessor=preprocessor,
                               device=device)
        self.classes_ = None

    def fit(self, X, y, **kwargs):
        fit_kwargs = dict(self.space_sample.get('fit', {}))
        fit_kwargs.update(kwargs)
        self.model.fit(X, y, **fit_kwargs)
        self.classes_ = getattr(self.model, 'classes_', None)
        return self

    def fit_cross_validation(self, X, y, metrics=None, **kwargs):
        assert isinstance(metrics, (list, tuple))
        fit_kwargs = dict(self.space_sample.get('fit', {}))
        fit_kwargs.update(kwargs)
        oof_proba, _, _, oof_scores = self.model.fit_cross_validation(
            X, y, oof_metrics=metrics, **fit_kwargs)
        scores = _mean_scores(oof_scores)
        self.classes_ = getattr(self.model, 'classes_', None)
        return scores, oof_proba, oof_scores

    def predict(self, X, **kwargs):
        return self.model.predict(X, **kwargs)

    def predict_proba(self, X, **kwargs):
        return self.model.predict_proba(X, **kwargs)

    def evaluate(self, X, y, metrics=None, **kwargs):
        result = self.model.evaluate(X, y, **kwargs)
        return dict(result)

    def save(self, model_path):
        self.model.save(model_path)
        with open(os.path.join(model_path, 'dt_estimator.pkl'), 'wb') as f:
            pickle.dump(self, f, protocol=4)

    @staticmethod
    def load(model_path, device=None):
        with open(os.path.join(model_path, 'dt_estimator.pkl'), 'rb') as f:
            stub = pickle.load(f)
        stub.model = DeepTable.load(model_path, device=device)
        return stub

    def __getstate__(self):
        state = self.__dict__.copy()
        state['model'] = None
        return state


class HyperDT:
    """Search driver (parity: reference HyperDT at hyper_dt.py:258-292,
    with the search loop in-process instead of Hypernets dispatchers)."""

    def __init__(self, searcher=None, reward_metric=None, callbacks=None,
                 max_model_size=0, cache_preprocessed_data=False,
                 space_fn=None, space_sample_validation_fn=None,
                 device=None, **config_kwargs):
        metrics = config_kwargs.get('metrics')
        if metrics is None and reward_metric is None:
            raise ValueError('Must specify `reward_metric` or `metrics`.')
        if reward_metric is None:
            reward_metric = metrics[0]
        if metrics is None:
            metrics = [reward_metric]
            config_kwargs['metrics'] = metrics
        if reward_metric not in metrics:
            metrics = list(metrics) + [reward_metric]
            config_kwargs['metrics'] = metrics
        self.reward_metric = reward_metric
        self.device = device
        self.config_kwargs = config_kwargs
        self.cache_preprocessed_data = cache_preprocessed_data
        if searcher is None:
            searcher = RandomSearcher(
                space_fn or mini_dt_space,
                space_sample_validation_fn=space_sample_validation_fn
                or (mini_dt_space_validator if space_fn is None else None))
        self.searcher = searcher
        self.callbacks = callbacks or []
        self.history: List[Trial] = []
        self.best_trial: Optional[Trial] = None

    @property
    def _greater_is_better(self):
        return str(self.reward_metric).lower() in \
            consts.METRICS_BIGGER_IS_BETTER

    def _get_estimator(self, sample):
        return DTEstimator(sample, self.cache_preprocessed_data,
                           device=self.device, **self.config_kwargs)

    def search(self, X, y, X_eval=None, y_eval=None, max_trials=10, cv=False,
               num_folds=3, trial_store_dir=None, **fit_kwargs):
        if X_eval is None and not cv:
            stratify = None
            try:
                vals, counts = np.unique(np.asarray(y), return_counts=True)
                if len(vals) < 50 and counts.min() >= 2:
                    stratify = np.asarray(y)
            except Exception:
                pass
            X, X_eval, y, y_eval = train_test_split(
                X, y, test_size=0.2, random_state=9527, stratify=stratify)

        for trial_no in range(1, max_trials + 1):
            sample = self.searcher.sample(self.history)
            trial = Trial(trial_no=trial_no, sample=sample)
            start = time.time()
            try:
                estimator = self._get_estimator(sample)
                if cv:
                    scores, _, _ = estimator.fit_cross_validation(
                        X, y, metrics=[self.reward_metric],
                        num_folds=num_folds, **fit_kwargs)
                else:
                    estimator.fit(X, y, **fit_kwargs)
                    scores = estimator.evaluate(X_eval, y_eval)
                reward = self._extract_reward(scores)
                trial.reward = reward
                trial.scores = dict(scores)
                trial.succeeded = True
                if trial_store_dir is not None:
                    path = os.path.join(trial_store_dir,
                                        f'trial_{trial_no}')
                    os.makedirs(path, exist_ok=True)
                    estimator.save(path)
                    trial.model_path = path
                if self.best_trial is None or self._better(
                        trial.reward, self.best_trial.reward):
                    self.best_trial = trial
                    self._best_estimator = estimator
                self.searcher.update(trial)
            except Exception as e:
                trial.succeeded = False
                trial.message = str(e)
                logger.warning(f'Trial {trial_no} failed: {e}')
            trial.elapsed = time.time() - start
            self.history.append(trial)
            for cb in self.callbacks:
                cb(trial)
            logger.info(f'Trial {trial_no}/{max_trials} '
                        f'reward={trial.reward} ({trial.elapsed:.1f}s)')
        return self.best_trial

    def _extract_reward(self, scores):
        for k, v in scores.items():
            if str(k).lower() == str(self.reward_metric).lower():
                return float(v)
        raise ValueError(
            f'reward metric {self.reward_metric!r} not in scores {scores}')

    def _better(self, a, b):
        return a > b if self._greater_is_better else a < b

    def get_best_trial(self):
        return self.best_trial

    @property
    def best_estimator(self):
        return getattr(self, '_best_estimator', None)

    def load_estimator(self, model_path):
        return DTEstimator.load(model_path, device=self.device)

    def final_train(self, X, y, **kwargs):
        """Re-fit the best sampled config on the full data."""
        if self.best_trial is None:
            raise ValueError('No successful trial; run search() first.')
        estimator = self._get_estimator(self.best_trial.sample)
        estimator.fit(X, y, **kwargs)
        self._best_estimator = estimator
        return estimator

    def export_trial_configuration(self, trial):
        default_conf = ModelConfig()
        new_conf = sample_to_config(trial.sample, **self.config_kwargs)
        import dataclasses
        conf_set = []
        for f in dataclasses.fields(default_conf):
            if getattr(new_conf, f.name) != getattr(default_conf, f.name):
                conf_set.append(f'\n\t{f.name}={getattr(new_conf, f.name)}')
        return (f'ModelConfig({",".join(conf_set)})\n\n'
                f'fit params:{trial.sample.get("fit", {})}')

    def leaderboard(self):
        rows = [{'trial': t.trial_no, 'reward': t.reward,
                 'succeeded': t.succeeded, 'elapsed': t.elapsed,
                 'nets': t.sample['config'].get('nets')}
                for t in self.history]
        table = cl.records_table(rows)
        if not rows:
            return table
        if cl.is_frame(table):
            return table.sort_values('reward',
                                     ascending=not self._greater_is_better)
        # sort_values: missing rewards last in either direction
        reward = cl.to_float(table['reward'])
        order = np.argsort(reward if not self._greater_is_better
                           else -reward, kind='stable')
        table.index = np.arange(len(rows))
        return table.take(order)


class Experiment:
    """Compete-experiment-lite: split data, search, final-train the winner
    (parity surface: reference make_experiment at hyper_dt.py:452-524)."""

    def __init__(self, hyper_model: HyperDT, X, y, X_eval=None, y_eval=None,
                 X_test=None, cv=False, num_folds=3, max_trials=3,
                 **fit_kwargs):
        self.hyper_model = hyper_model
        self.X, self.y = X, y
        self.X_eval, self.y_eval = X_eval, y_eval
        self.X_test = X_test
        self.cv = cv
        self.num_folds = num_folds
        self.max_trials = max_trials
        self.fit_kwargs = fit_kwargs

    def run(self, max_trials=None, **kwargs):
        fit_kwargs = dict(self.fit_kwargs)
        fit_kwargs.update(kwargs)
        self.hyper_model.search(
            self.X, self.y, self.X_eval, self.y_eval,
            max_trials=max_trials or self.max_trials, cv=self.cv,
            num_folds=self.num_folds, **fit_kwargs)
        best = self.hyper_model.best_estimator
        if best is None:
            raise RuntimeError('All trials failed.')
        return best


def _mean_scores(fold_scores):
    """Each metric's mean over the folds that report it, NaN skipped (the
    mean of ``pd.concat`` of the folds' score Series)."""
    keys = list(dict.fromkeys(k for score in fold_scores for k in score))
    out = {}
    for k in keys:
        values = np.array([float(score[k]) for score in fold_scores
                           if k in score], dtype=np.float64)
        values = values[~np.isnan(values)]
        out[k] = float(values.mean()) if len(values) else float('nan')
    return out


def _read_table(data):
    """The columns of a csv path (``columns.read_csv``), a parquet path
    (``columns.read_parquet``), a DataFrame, a dict of 1-D arrays or
    ``Columns`` (a copy: the target is popped from it)."""
    if isinstance(data, str):
        data = cl.read_parquet(data) if data.endswith('.parquet') \
            else cl.read_csv(data)
    return cl.as_columns(data, rename=False).copy()


def make_experiment(train_data, target=None, eval_data=None, test_data=None,
                    searcher=None, search_space=None,
                    space_sample_validation_fn=None, reward_metric=None,
                    max_trials=3, cv=False, num_folds=3, callbacks=None,
                    searcher_options=None, log_level=None, device=None,
                    **kwargs):
    """Create a runnable experiment (parity: reference hyper_dt.py:452).

    ``train_data`` is a DataFrame, a dict of 1-D arrays, ``Columns`` (or a
    csv or parquet path, read on numpy alone) containing the ``target``
    column.
    ModelConfig fields passed as kwargs are forwarded to every trial's
    config; every trial's ``DeepTable`` runs on ``device``.
    """
    X = _read_table(train_data)
    if target is None:
        target = X.columns[-1]
    y = X.pop(target)

    X_eval = y_eval = None
    if eval_data is not None:
        X_eval = _read_table(eval_data)
        y_eval = X_eval.pop(target)

    searcher_options = searcher_options or {}
    if searcher is None and search_space is None:
        search_space = mini_dt_space
        searcher_options.setdefault('space_sample_validation_fn',
                                    mini_dt_space_validator)
    if space_sample_validation_fn is not None:
        searcher_options['space_sample_validation_fn'] = \
            space_sample_validation_fn
    if searcher is None or searcher == 'random':
        searcher = RandomSearcher(search_space or mini_dt_space,
                                  **searcher_options)
    elif searcher == 'evolution':
        searcher = EvolutionSearcher(search_space or mini_dt_space,
                                     **searcher_options)

    # ModelConfig fields arriving via kwargs go to the trial configs
    import dataclasses
    config_keys = {f.name for f in dataclasses.fields(ModelConfig)} - \
        {'name', 'task', 'nets'}
    config_options = {k: kwargs.pop(k) for k in list(kwargs)
                      if k in config_keys}

    hyper_model = HyperDT(searcher=searcher, reward_metric=reward_metric,
                          callbacks=callbacks, device=device,
                          **config_options)
    return Experiment(hyper_model, X, y, X_eval=X_eval, y_eval=y_eval,
                      X_test=test_data, cv=cv, num_folds=num_folds,
                      max_trials=max_trials, **kwargs)
