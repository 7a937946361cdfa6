# -*- coding:utf-8 -*-
"""Trained quality of the port's ``DeepTable`` on the configurations of
``benchmarks/parity_quality.py`` (the JAX package's side, "ours" there),
with that script's protocol:

- an 80/20 train/test split (seed 42, stratified for binary and multiclass
  targets);
- ``DeepTable.fit``: 8 epochs, batch 512, Adam 1e-3 (the default
  optimizer), a 20% validation split, early stopping on the first metric
  (patience 3, best weights restored);
- the test metrics: binary AUC and logloss from ``DeepTable.evaluate``;
  regression RMSE and MAE, multiclass logloss and accuracy, multilabel
  macro AUC and mean per-label logloss, each from the test predictions
  with scikit-learn's scorers' arithmetic (``score``: ``ops/metrics.py``,
  probabilities clipped as ``sklearn.metrics.log_loss`` clips them).

The first metric drives early stopping: AUC (binary), RMSE (regression),
accuracy (multiclass); multilabel monitors logloss (the JAX script's
multilabel ``accuracy`` argmaxes the labels).

Run on the CPU, three seeds of every row it runs:

    python -m deeptables_torch.tools.parity_quality --device cpu
    python -m deeptables_torch.tools.parity_quality --device cpu \\
        --rows bank_deepfm,glass_multiclass --seeds 0,1,2
    python -m deeptables_torch.tools.parity_quality --report

``--patience 0`` runs without early stopping: the JAX package's multilabel
row runs so in effect (its multilabel ``accuracy`` fails, so the early
stopping it monitors never fires).

The criteo- and avazu-style tables are numpy 2.0's on any numpy release
(``data/datasets.py`` draws their Zipf ids as numpy 2.0 does), the tables
of ``BASELINE.md`` and of this tool's CPU runs. Every result records its
table's digest (``table``, ``table_digest``).

Each finished (row, seed) is written at once to the results file
(``--out``, default ``parity_results.json`` beside this script), which
only this process writes; ``--report`` prints each row's mean ± σ
(population σ, as the JAX script reports). numpy and torch alone: the
split comes from ``data/split.py`` (scikit-learn's rows), so it runs on
the card's machine (``--device cuda``); imports nothing of JAX.
"""

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from ..data import columns as cl
from ..data.split import train_test_split
from ..ops import metrics

SEEDS = (0, 1, 2)
EPOCHS = 8
BATCH = 512
OUT = Path(__file__).resolve().parent / 'parity_results.json'
ROWS = ('bank_deepfm', 'criteo_xdeepfm', 'avazu_autoint',
        'boston_regression', 'glass_multiclass', 'multilabel_dnn',
        'adult_widedeep_dcn', 'bank_pnn', 'bank_fgcnn', 'bank_fibinet',
        'bank_afm')
MULTILABEL_TARGET = [f'label_{k}' for k in range(4)]
# the first metric drives early stopping
TASK_METRICS = {'binary': ['AUC', 'logloss'], 'regression': ['rmse'],
                'multiclass': ['accuracy'], 'multilabel': ['logloss']}


def table_digest(table) -> str:
    """A digest of a table's names, kinds and values."""
    return cl.as_columns(table, rename=False).signature()[:16]


def configs():
    """The rows of ``benchmarks/parity_quality.py:_configs`` that the port
    runs: loader, target, task, nets and the extra config."""
    from ..data import datasets as ds
    avazu_columns = [c for c in ds.load_avazu_synthetic(10).columns
                     if c != 'click']
    specs = {
        'bank_deepfm': dict(
            loader=lambda: ds.load_bank(20000), target='y',
            nets=['linear', 'fm_nets', 'dnn_nets'], conf={}),
        'criteo_xdeepfm': dict(
            loader=lambda: ds.load_criteo_synthetic(60000), target='label',
            nets=['linear', 'cin_nets', 'dnn_nets'],
            conf=dict(cin_params={'cross_layer_size': (64, 64),
                                  'activation': 'relu'},
                      embeddings_output_dim=8,
                      categorical_columns=[f'C{i}' for i in range(1, 27)])),
        'avazu_autoint': dict(
            loader=lambda: ds.load_avazu_synthetic(60000), target='click',
            nets=['autoint_nets'],
            conf=dict(autoint_params={'num_attention': 3, 'num_heads': 2,
                                      'dropout_rate': 0,
                                      'use_residual': True},
                      categorical_columns=avazu_columns)),
        'boston_regression': dict(
            loader=lambda: ds.load_boston(20000), target='target',
            task='regression', nets=['dnn_nets'],
            conf=dict(task='regression')),
        'glass_multiclass': dict(
            loader=lambda: ds.load_glass_uci(20000), target=10,
            task='multiclass', nets=['dnn_nets'], conf={}),
        'multilabel_dnn': dict(
            loader=lambda: ds.load_multilabel_synthetic(20000),
            target=MULTILABEL_TARGET, task='multilabel', nets=['dnn_nets'],
            conf=dict(task='multilabel')),
        'adult_widedeep_dcn': dict(
            loader=lambda: ds.load_adult(20000), target=14,
            nets=['linear', 'dnn_nets', 'dcn_nets'], conf={}),
        'bank_pnn': dict(
            loader=lambda: ds.load_bank(20000), target='y',
            nets=['pnn_nets'], conf={}),
        'bank_fgcnn': dict(
            loader=lambda: ds.load_bank(20000), target='y',
            nets=['fgcnn_dnn_nets'], conf={}),
        'bank_fibinet': dict(
            loader=lambda: ds.load_bank(20000), target='y',
            nets=['fibi_dnn_nets'], conf={}),
        'bank_afm': dict(
            loader=lambda: ds.load_bank(20000), target='y',
            nets=['afm_nets'], conf={}),
    }
    return specs


def split(df, target, task):
    """``train_test_split(X, y, test_size=0.2, random_state=42,
    stratify=...)`` of a DataFrame or ``Columns``, as the JAX script
    splits (``data.split`` draws scikit-learn's rows)."""
    if isinstance(target, list):
        y = np.column_stack([np.asarray(df[t]) for t in target]) \
            .astype(np.float32)
        df = df.drop(columns=target)
    else:
        y = np.asarray(df.pop(target))
    strat = y if task in ('binary', 'multiclass') else None
    return train_test_split(df, y, test_size=0.2, random_state=42,
                            stratify=strat)


def _log_loss(labels, proba):
    """``sklearn.metrics.log_loss``: probabilities clipped to
    [eps, 1 - eps] at their type's machine epsilon."""
    proba = np.asarray(proba)
    if proba.ndim == 1:
        proba = np.column_stack([1 - proba, proba])
    eps = np.finfo(proba.dtype if proba.dtype.kind == 'f'
                   else np.float64).eps
    return metrics.logloss(labels, proba, eps=eps)


def score(task, y_true, pred):
    """The JAX script's ``_score`` for the regression, multiclass and
    multilabel rows (its scikit-learn scorers' arithmetic)."""
    if task == 'regression':
        return {'rmse': metrics.rmse(y_true, pred),
                'mae': metrics.mae(y_true, pred)}
    if task == 'multiclass':
        classes = list(np.unique(y_true))
        yi = np.asarray([classes.index(v) for v in y_true])
        return {'logloss': _log_loss(yi, pred),
                'accuracy': metrics.accuracy(yi, pred)}
    p = np.clip(pred, 1e-7, 1 - 1e-7)
    return {'auc': float(np.mean([metrics.auc(y_true[:, k], pred[:, k])
                                  for k in range(y_true.shape[1])])),
            'logloss': float(np.mean([
                _log_loss(y_true[:, k], p[:, k])
                for k in range(y_true.shape[1])]))}


def run(name, spec, seed, device, home_dir, patience=3):
    from ..models import DeepTable, ModelConfig
    task = spec.get('task', 'binary')
    table = spec['loader']()
    digest = table_digest(table)
    X_train, X_test, y_train, y_test = split(table, spec['target'], task)
    conf = ModelConfig(nets=spec['nets'], metrics=TASK_METRICS[task],
                       earlystopping_patience=patience, seed=seed,
                       home_dir=home_dir, **spec['conf'])
    dt = DeepTable(config=conf, device=device)
    t0 = time.time()
    _, history = dt.fit(X_train, y_train, epochs=EPOCHS, batch_size=BATCH,
                        verbose=0)
    out = {'fit_seconds': round(time.time() - t0, 1),
           'epochs_run': len(history.history['loss']), 'table': digest}
    if task == 'binary':
        result = dt.evaluate(X_test, y_test, verbose=0)
        out.update(auc=float(result['AUC']), logloss=float(result['logloss']))
    elif task == 'regression':
        out.update(score(task, y_test,
                         np.asarray(dt.predict(X_test)).reshape(-1)))
    else:
        out.update(score(task, y_test, np.asarray(dt.predict_proba(X_test))))
    return out


def load(path):
    if Path(path).exists():
        with open(path) as f:
            return json.load(f)
    return {}


def report(results):
    lines = []
    for name in ROWS:
        runs = results.get(name, {})
        if not runs:
            continue
        keys = [k for k in next(iter(runs.values()))
                if k not in ('fit_seconds', 'epochs_run', 'device', 'table')]
        cells = []
        for key in keys:
            xs = [r[key] for r in runs.values()]
            cells.append(f'{key} {np.mean(xs):.4f}±{np.std(xs):.4f}')
        lines.append(f'{name:20s} seeds {sorted(runs)}: ' + ', '.join(cells))
    return '\n'.join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--device', default=None,
                        help="'cpu' or 'cuda' (default: the CUDA device)")
    parser.add_argument('--rows', default=','.join(ROWS))
    parser.add_argument('--seeds', default=','.join(map(str, SEEDS)))
    parser.add_argument('--out', default=str(OUT))
    parser.add_argument('--threads', type=int, default=None,
                        help='torch CPU threads')
    parser.add_argument('--patience', type=int, default=3,
                        help='early-stopping patience; 0 trains every '
                             'epoch and keeps the last weights (the '
                             "JAX multilabel row's effective protocol)")
    parser.add_argument('--report', action='store_true',
                        help='print the results file and run nothing')
    args = parser.parse_args(argv)
    results = load(args.out)
    if args.report:
        print(report(results))
        return 0
    specs = configs()
    rows = [r for r in args.rows.split(',') if r]
    unknown = set(rows) - set(specs)
    if unknown:
        parser.error(f'unknown rows {sorted(unknown)}; rows: {list(ROWS)}')
    import torch
    if args.threads:
        torch.set_num_threads(args.threads)
    home_dir = tempfile.mkdtemp(prefix='dt_parity_')
    try:
        for name in rows:
            for seed in (int(s) for s in args.seeds.split(',')):
                out = run(name, specs[name], seed, args.device, home_dir,
                          args.patience)
                out['device'] = args.device or 'cuda'
                results.setdefault(name, {})[str(seed)] = out
                with open(args.out, 'w') as f:
                    json.dump(results, f, indent=1, sort_keys=True)
                print(json.dumps({'row': name, 'seed': seed, **out}),
                      flush=True)
    finally:
        shutil.rmtree(home_dir, ignore_errors=True)
    print(report(results))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
