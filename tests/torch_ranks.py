# -*- coding:utf-8 -*-
"""Multi-process runs of the port for the CPU tests: ``run_ranks`` starts
one subprocess a rank, each joins a gloo process group through a
``file://`` store under the test's temporary directory (no TCP port, so
parallel test workers cannot collide), runs a job of this module and writes
its result; every rank has a time limit and is killed when it passes (a rank
that dies would leave its peer waiting in a collective), and the process
group has a 60 s timeout of its own.

The jobs (run in the subprocesses, JAX never imported):
- ``fits``: DeepFM on a small schema under ``DataParallel`` for each case
  of ``CASES``; rank 0 writes the parameters and the history.
- ``checkpoint``: a data-parallel fit, ``save_checkpoint`` under the group,
  a fresh model restored on every rank, one more step.
"""

import os
import pickle
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 150

# DeepFM on 4 categorical columns, 3 dense ones; every case has BatchNorm
# (the dense inputs' and the concatenation's)
VOCABS = (13, 7, 21, 5)
CASES = {
    'batchnorm': {},
    'sample_weight': {'sample_weight': True},
    'ghmc': {'loss': 'ghmc'},
    'dropout': {'embedding_dropout': 0.3, 'dense_dropout': 0.2,
                'dnn_dropout': 0.25},
}
N_TRAIN, N_VAL, BATCH, EPOCHS = 384, 128, 128, 2


def case_data(seed=0):
    rng = np.random.default_rng(seed)
    n = N_TRAIN + N_VAL
    cat = np.stack([rng.integers(0, v, n) for v in VOCABS], axis=1)
    dense = rng.normal(size=(n, 3)).astype(np.float32)
    score = dense[:, 0] + (cat[:, 0] % 3 == 0) - 0.5
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-score))).astype(np.float32)
    weight = rng.uniform(0, 2, n).astype(np.float32)
    weight[::7] = 0.
    X = {'cat': cat.astype(np.int32), 'input_continuous_all': dense}
    return X, y, weight


def case_model(case, strategy=None, device='cpu'):
    from deeptables_torch.models import (CategoricalColumn, ContinuousColumn,
                                         DeepModel, ModelConfig)
    spec = dict(CASES[case])
    spec.pop('sample_weight', None)
    dnn_dropout = spec.pop('dnn_dropout', 0)
    config = ModelConfig(
        nets=['linear', 'fm_nets', 'dnn_nets'], task='binary',
        metrics=['AUC'], embedding_dropout=spec.pop('embedding_dropout', 0),
        dnn_params={'hidden_units': ((32, dnn_dropout, False),
                                     (16, dnn_dropout, False))},
        distribute_strategy=strategy, **spec)
    cats = tuple(CategoricalColumn(f'C{i}', v, 8)
                 for i, v in enumerate(VOCABS))
    conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
    return DeepModel('binary', 2, config, cats, conts, device=device)


def case_fit(case, strategy=None):
    """The case's model fitted: ``EPOCHS`` epochs of ``BATCH``-row global
    batches, shuffled from the config's seed. Returns (state, history)."""
    X, y, weight = case_data()
    tr = {k: v[:N_TRAIN] for k, v in X.items()}
    va = {k: v[N_TRAIN:] for k, v in X.items()}
    model = case_model(case, strategy)
    history = model.fit(
        tr, y[:N_TRAIN], batch_size=BATCH, epochs=EPOCHS, verbose=0,
        validation_data=(va, y[N_TRAIN:]),
        sample_weight=weight[:N_TRAIN]
        if CASES[case].get('sample_weight') else None)
    state = {k: v.detach().cpu().numpy().copy()
             for k, v in model.module.state_dict().items()}
    return state, {k: list(v) for k, v in history.history.data.items()}


def _join(rank, world, store):
    from deeptables_torch.parallel import initialize_distributed
    return initialize_distributed(init_method=f'file://{store}',
                                  num_processes=world, process_id=rank,
                                  backend='gloo',
                                  timeout=timedelta(seconds=60))


def job_fits(rank, world, store):
    from deeptables_torch.parallel import DataParallel, per_host_batch
    info = _join(rank, world, store)
    out = {'host_info': info, 'per_host_batch': per_host_batch(1024)}
    try:
        per_host_batch(1023)
    except ValueError:
        out['per_host_batch_refused'] = True
    for case in CASES:
        out[case] = case_fit(case, DataParallel(num_devices=world))
    return out


def job_checkpoint(rank, world, store, path):
    import torch
    from deeptables_torch.parallel import DataParallel
    from deeptables_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    _join(rank, world, store)
    X, y, _ = case_data()
    first = {k: v[:2 * BATCH] for k, v in X.items()}
    model = case_model('batchnorm', DataParallel(num_devices=world))
    model.fit(first, y[:2 * BATCH], batch_size=BATCH, epochs=1, verbose=0,
              shuffle=False, validation_data=(first, y[:2 * BATCH]))
    save_checkpoint(path, model)
    fresh = case_model('batchnorm', DataParallel(num_devices=world))
    restore_checkpoint(path, fresh)
    restored = {k: v.detach().clone()
                for k, v in fresh.module.state_dict().items()}
    same = all(torch.equal(v, restored[k])
               for k, v in model.module.state_dict().items())
    third = {k: v[2 * BATCH:3 * BATCH] for k, v in X.items()}
    fresh.fit(third, y[2 * BATCH:3 * BATCH], batch_size=BATCH, epochs=1,
              verbose=0, shuffle=False, validation_data=(third, y[:BATCH]))
    return {'restored_equal': same,
            'after': {k: v.detach().cpu().numpy().copy()
                      for k, v in fresh.module.state_dict().items()}}


def main():
    job, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch.distributed as dist
    try:
        result = globals()[f'job_{job}'](rank, world, store, *sys.argv[6:])
        with open(out, 'wb') as f:
            pickle.dump(result, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(job, tmp_path, world=2, *args):
    """Run ``job`` on ``world`` ranks; returns each rank's result. Raises
    with the ranks' output when one fails or outlives RANK_TIMEOUT_S."""
    store = tmp_path / f'{job}_store'
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1',
               PYTHONPATH=f'{REPO}{os.pathsep}{REPO / "tests"}')
    procs = []
    for rank in range(world):
        out = tmp_path / f'{job}_rank{rank}.pkl'
        procs.append((out, subprocess.Popen(
            [sys.executable, '-c', 'import torch_ranks; torch_ranks.main()',
             job, str(rank), str(world), str(store), str(out),
             *map(str, args)],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)))
    logs, failed = [], False
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for _, proc in procs:
            try:
                log, _ = proc.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                log, _ = proc.communicate()
                failed = True
            logs.append(log.decode(errors='replace')[-3000:])
            failed = failed or proc.returncode != 0
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError('a rank failed:\n' + '\n----\n'.join(logs))
    results = []
    for out, _ in procs:
        with open(out, 'rb') as f:
            results.append(pickle.load(f))
    return results
