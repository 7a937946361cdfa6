# -*- coding:utf-8 -*-
"""The estimator layer with pandas and scikit-learn blocked, on the CPU.

Two subprocesses run one flow on ``device='cpu'`` with one torch thread
(``OMP_NUM_THREADS=1``), so that the same arithmetic gives the same bits:
``DeepTable.fit`` → ``evaluate`` → ``predict`` / ``predict_proba`` →
``fit_cross_validation`` → ``save`` → ``serving.Predictor.load`` →
``predict_proba``, on bank-style rows (``load_bank``, 1500 rows, DeepFM
cut to a 16-unit DNN).

- ``blocked``: ``pandas``, ``sklearn``, JAX and the JAX package blocked in
  ``sys.modules``; the loader then gives numpy columns (``Columns``), fed
  to ``DeepTable`` as a dict of 1-D arrays. It also loads the other
  process's ``dt.pkl`` (saved with pandas present) and predicts with it.
- ``frame``: pandas present, the same rows as a DataFrame.

Held exactly equal: every prediction, the evaluation, the out-of-fold
probabilities and the CV folds' rows of the two processes; the folds' rows
also equal those of the JAX package's ``fit_cross_validation`` at the same
seed (its fold function recorded, not trained), and the predictions of the
``dt.pkl`` saved beside pandas equal that process's own. The parity tool's
split and scores equal scikit-learn's for every task.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from deeptables_torch.data import split
from deeptables_torch.data.datasets import load_bank
from deeptables_torch.tools import parity_quality

REPO = Path(__file__).resolve().parents[1]
ROWS, FOLDS, SEED = 1500, 3, 9527
BLOCKED = ('pandas', 'sklearn', 'jax', 'jaxlib', 'flax', 'optax',
           'deeptables_tpu')

SCRIPT = r'''
import json, os, sys
MODE, OUT, OTHER = sys.argv[1], sys.argv[2], sys.argv[3]
if MODE == 'blocked':
    for name in BLOCKED:
        sys.modules[name] = None
import numpy as np
from deeptables_torch.data.columns import Columns
from deeptables_torch.data.datasets import load_bank
from deeptables_torch.models import DeepTable, ModelConfig
from deeptables_torch.models import deeptable as dt_mod
from deeptables_torch.serving import Predictor

table = load_bank(ROWS)
if MODE == 'blocked':
    assert isinstance(table, Columns), type(table)
    X = {name: table[name] for name in table.columns if name != 'y'}
    y = table['y']
else:
    assert type(table).__name__ == 'DataFrame'
    y = table.pop('y').to_numpy()
    X = table
folds = []
fold_fn = dt_mod._fit_and_score
def recording(*args, **kwargs):
    folds.append(np.asarray(args[7]).tolist())
    return fold_fn(*args, **kwargs)
dt_mod._fit_and_score = recording

def config(home):
    return ModelConfig(nets=['linear', 'fm_nets', 'dnn_nets'],
                       metrics=['AUC', 'logloss'], seed=0,
                       earlystopping_patience=0, home_dir=home,
                       dnn_params={'hidden_units': ((16, 0, False),)})
home = os.path.join(OUT, 'home')
dt = DeepTable(config(home), device='cpu')
dt.fit(X, y, epochs=2, batch_size=128, verbose=0)
result = {
    'evaluate': {k: float(v) for k, v in dt.evaluate(X, y).items()},
    'proba': dt.predict_proba(X).tolist(),
    'predict': [str(v) for v in dt.predict(X)]}
oof, _, test = dt.fit_cross_validation(X, y, num_folds=FOLDS, epochs=1,
                                       batch_size=128, verbose=0,
                                       random_state=SEED, X_test=X)
result.update(oof=oof.tolist(), cv_test=test.tolist(), folds=folds,
              cv_proba=dt.predict_proba(X).tolist())
with open(os.path.join(dt.output_path,
                       'linear_fm_nets_dnn_nets-cv-3.csv')) as f:
    result['csv_head'] = f.read().splitlines()[:3]
saved = os.path.join(OUT, 'saved')
dt.save(saved)
served = Predictor.load(saved, device='cpu')
result['served'] = served.predict_proba(X).tolist()
result['served_predict'] = [str(v) for v in served.predict(X)]
result['served_own'] = Predictor(dt).predict_proba(X).tolist()
if OTHER != '-':
    other = Predictor.load(OTHER, device='cpu')
    result['other_served'] = other.predict_proba(X).tolist()
    result['other_predict'] = [str(v) for v in other.predict(X)]
result['modules'] = sorted(m for m in ('pandas', 'sklearn')
                           if sys.modules.get(m) is not None)
with open(os.path.join(OUT, 'result.json'), 'w') as f:
    json.dump(result, f)
print('ok')
'''


def _run(mode, out, other='-'):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1',
               MKL_NUM_THREADS='1', PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, '-c',
         f'BLOCKED = {BLOCKED!r}\nROWS = {ROWS}\nFOLDS = {FOLDS}\n'
         f'SEED = {SEED}\n' + SCRIPT, mode, str(out), str(other)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split()[-1] == 'ok'
    with open(out / 'result.json') as f:
        return json.load(f)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    frame_dir = tmp_path_factory.mktemp('frame')
    frame = _run('frame', frame_dir)
    blocked = _run('blocked', tmp_path_factory.mktemp('blocked'),
                   frame_dir / 'saved')
    return frame, blocked


def test_blocked_run_imports_neither_pandas_nor_sklearn(runs):
    frame, blocked = runs
    assert blocked['modules'] == []
    assert 'pandas' in frame['modules']


@pytest.mark.parametrize('key', ['evaluate', 'proba', 'predict', 'oof',
                                 'cv_test', 'folds', 'csv_head', 'served'])
def test_numpy_columns_give_what_a_dataframe_gives(runs, key):
    frame, blocked = runs
    assert blocked[key] == frame[key], key


def test_fit_evaluate_predict_serve_without_pandas(runs):
    _, blocked = runs
    proba = np.asarray(blocked['proba'])
    assert proba.shape == (ROWS, 2) and np.isfinite(proba).all()
    np.testing.assert_allclose(proba.sum(1), 1, rtol=1e-6)
    assert set(blocked['predict']) <= {'yes', 'no'}
    assert blocked['evaluate']['auc'] > 0.5
    oof = np.asarray(blocked['oof'])
    assert oof.shape == (ROWS, 2) and np.isfinite(oof).all()
    # a loaded estimator serves what the fitted one serves, bit for bit
    # (its current model, the last fold's), and what it predicts in
    # batches of 128 within float32 rounding
    assert blocked['served'] == blocked['served_own']
    np.testing.assert_allclose(blocked['served'], blocked['cv_proba'],
                               rtol=0, atol=1e-6)


def test_dt_pkl_saved_with_pandas_loads_without_it(runs):
    frame, blocked = runs
    assert blocked['other_served'] == frame['served']
    assert blocked['other_predict'] == frame['served_predict']


def test_cv_folds_are_the_jax_packages(runs, monkeypatch, tmp_path):
    """The JAX package's fit_cross_validation at the same seed, its fold
    function recorded instead of trained, splits the same rows."""
    from deeptables_tpu.models import DeepTable as JaxDeepTable
    from deeptables_tpu.models import ModelConfig as JaxModelConfig
    from deeptables_tpu.models import deeptable as jax_dt_mod
    _, blocked = runs
    recorded = []

    def fold(task, num_classes, config, cats, conts, var_len, n_fold,
             valid_idx, *args, **kwargs):
        recorded.append(np.asarray(valid_idx).tolist())
        return n_fold, valid_idx, {}, np.zeros((len(valid_idx), 1)), None, \
            None

    monkeypatch.setattr(jax_dt_mod, '_fit_and_score', fold)
    df = load_bank(ROWS)
    y = df.pop('y').to_numpy()
    jax_dt = JaxDeepTable(JaxModelConfig(nets=['linear', 'fm_nets',
                                               'dnn_nets'],
                                         home_dir=str(tmp_path)))
    jax_dt.fit_cross_validation(df, y, num_folds=FOLDS, random_state=SEED,
                                verbose=0)
    assert recorded == blocked['folds']
    assert sorted(i for fold in recorded for i in fold) == list(range(ROWS))


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize('task,target,loader', [
    ('binary', 'y', lambda: load_bank(400)),
    ('multiclass', 10, None),
    ('regression', 'target', None),
    ('multilabel', parity_quality.MULTILABEL_TARGET, None)])
def test_parity_split_is_sklearns(task, target, loader):
    from sklearn.model_selection import train_test_split
    from deeptables_torch.data import datasets
    loader = loader or {
        'multiclass': lambda: datasets.load_glass_uci(300),
        'regression': lambda: datasets.load_boston(300),
        'multilabel': lambda: datasets.load_multilabel_synthetic(300)}[task]
    ours = parity_quality.split(loader(), target, task)
    df = loader()
    if isinstance(target, list):
        y = df[target].to_numpy(np.float32)
        df = df.drop(columns=target)
    else:
        y = np.asarray(df.pop(target))
    ref = train_test_split(df, y, test_size=0.2, random_state=42,
                           stratify=y if task in ('binary', 'multiclass')
                           else None)
    pd.testing.assert_frame_equal(ours[0], ref[0])
    pd.testing.assert_frame_equal(ours[1], ref[1])
    np.testing.assert_array_equal(ours[2], ref[2])
    np.testing.assert_array_equal(ours[3], ref[3])
    # numpy columns split into the same rows
    cols = parity_quality.split(_columns_of(loader()), target, task)
    np.testing.assert_array_equal(cols[2], ref[2])
    for name in ref[0].columns:
        np.testing.assert_array_equal(cols[0][name],
                                      ref[0][name].to_numpy(dtype=object)
                                      if cols[0][name].dtype == object
                                      else ref[0][name].to_numpy())


def _columns_of(df):
    from deeptables_torch.data.columns import as_columns
    return as_columns(df, rename=False)


@pytest.mark.parametrize('task', ['regression', 'multiclass', 'multilabel'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_parity_scores_are_sklearns(task, dtype):
    from sklearn.metrics import (accuracy_score, log_loss,
                                 mean_absolute_error, mean_squared_error,
                                 roc_auc_score)
    rng = np.random.default_rng(3)
    n = 500
    if task == 'regression':
        y = rng.normal(20, 5, n)
        pred = (y + rng.normal(0, 2, n)).astype(dtype)
        ours = parity_quality.score(task, y, pred)
        ref = {'rmse': np.sqrt(mean_squared_error(y, pred)),
               'mae': mean_absolute_error(y, pred)}
    elif task == 'multiclass':
        y = rng.choice([1, 2, 3, 5, 6, 7], n)
        logits = rng.normal(size=(n, 6))
        logits[np.arange(n), np.searchsorted([1, 2, 3, 5, 6, 7], y)] += 1.5
        pred = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        pred[:3] = np.eye(6)[:3]  # certain rows: clipped at eps
        pred = pred.astype(dtype)
        ours = parity_quality.score(task, y, pred)
        classes = list(np.unique(y))
        yi = np.asarray([classes.index(v) for v in y])
        ref = {'logloss': log_loss(yi, pred, labels=list(range(6))),
               'accuracy': accuracy_score(yi, pred.argmax(1))}
    else:
        y = (rng.uniform(size=(n, 4)) < 0.4).astype(np.float32)
        pred = np.clip(y * 0.6 + rng.uniform(0, 0.5, (n, 4)), 0, 1) \
            .astype(dtype)
        pred[:2] = y[:2]  # 0 and 1 exactly
        ours = parity_quality.score(task, y, pred)
        p = np.clip(pred, 1e-7, 1 - 1e-7)
        ref = {'auc': roc_auc_score(y, pred, average='macro'),
               'logloss': np.mean([log_loss(y[:, k], p[:, k], labels=[0, 1])
                                   for k in range(4)])}
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, err_msg=k)


def test_parity_split_of_columns_without_pandas_rows():
    """``data.split.train_test_split`` of ``Columns`` takes the rows of
    ``split_indices``, the same for a DataFrame."""
    df = load_bank(300)
    y = df.pop('y').to_numpy()
    train, test = split.split_indices(300, 0.2, 42, stratify=y)
    cols = _columns_of(df)
    X_train, X_test, _, _ = split.train_test_split(cols, y, 0.2, 42, y)
    np.testing.assert_array_equal(X_train['age'], df['age'].to_numpy()[train])
    np.testing.assert_array_equal(X_test['job'],
                                  df['job'].to_numpy(dtype=object)[test])
