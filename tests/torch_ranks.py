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
- ``model_axis`` (4 ranks): the row-sharded lookups of ``LOOKUP_CASES`` on
  the 2×2 and 1×4 meshes, and the fits of ``SHARDED_CASES`` on 2×2.
- ``model_axis_1x2`` (2 ranks): the 1×2 lookups, a capacity-bounded fit,
  a bridged model's logits, ``DeepTable.fit``, a streaming fit, ``save``
  and a checkpoint round trip.
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


# ---------------------------------------------------------------------------
# row-sharded tables over a model axis (tests/test_torch_sharded_embedding.py)

# the lookups: (mesh (data, model), table rows, width, batch, fields, seed,
# the ids' upper bound (None: the table's rows), lookup, capacity_factor,
# whether the gradient is taken); the cases of tests/test_parallel.py
# (skewed ids: all in shard 0's rows, or in its and shard 1's), at the
# meshes of tests/test_torch_sharded_embedding.py. psum_1x2_padded's 63
# rows do not divide the model axis, which the JAX lookups refuse.
LOOKUP_CASES = {
    'psum_dense_match': ((2, 2), 64, 8, 16, 5, 0, None, 'sharded', None,
                         False),
    'psum_gradient': ((2, 2), 32, 4, 8, 3, 1, None, 'sharded', None, True),
    'psum_model4': ((1, 4), 128, 4, 8, 7, 0, None, 'sharded', None, True),
    'a2a_dense_match': ((2, 2), 64, 8, 16, 5, 0, None, 'sharded_a2a', 2.0,
                        False),
    'a2a_model4': ((1, 4), 128, 4, 8, 7, 0, None, 'sharded_a2a', 4.0,
                   False),
    'a2a_skewed_exact': ((2, 2), 64, 8, 16, 5, 3, 32, 'sharded_a2a', 2.0,
                         False),
    'a2a_model4_default_exact': ((1, 4), 128, 8, 16, 6, 7, 32,
                                 'sharded_a2a', None, True),
    'a2a_drops_1.0': ((1, 4), 128, 4, 16, 6, 11, 32, 'sharded_a2a', 1.0,
                      False),
    'a2a_drops_1.5': ((1, 4), 128, 4, 16, 6, 11, 32, 'sharded_a2a', 1.5,
                      False),
    'a2a_drops_2x2': ((2, 2), 64, 4, 16, 6, 11, 24, 'sharded_a2a', 1.0,
                      False),
    'a2a_gradient': ((2, 2), 32, 4, 8, 3, 5, None, 'sharded_a2a', 2.0,
                     True),
    'a2a_1x2': ((1, 2), 64, 8, 16, 5, 0, None, 'sharded_a2a', None, True),
    'psum_1x2_padded': ((1, 2), 63, 8, 15, 5, 2, None, 'sharded', None,
                        True),
}


def lookup_inputs(case):
    """(table (V, D), ids (B, F), w (B, F, D)) of a lookup case, numpy: the
    gradient is that of sum(rows · w)."""
    _, V, D, B, F, seed, high, _, _, _ = LOOKUP_CASES[case]
    rng = np.random.default_rng(seed)
    if 'drops' in case:  # every row nonzero: a zero row is a drop
        table = rng.uniform(1.0, 2.0, size=(V, D)).astype(np.float32)
    else:
        table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, high or V, (B, F)).astype(np.int32)
    w = rng.normal(size=(B, F, D)).astype(np.float32)
    return table, ids, w


def _lookup(case, meshes):
    import torch
    from deeptables_torch.parallel import sharded_embedding as se
    (n_data, n_model), _, _, _, _, _, _, how, factor, grad = \
        LOOKUP_CASES[case]
    mesh = meshes[(n_data, n_model)]
    table, ids, w = lookup_inputs(case)
    d, m = mesh.data_index, mesh.model_index
    rows = slice(d * len(ids) // n_data, (d + 1) * len(ids) // n_data)
    shard = se.shard_rows(torch.from_numpy(table), n_model, m)
    shard.requires_grad_(grad)
    local_ids = torch.from_numpy(ids[rows])
    drops = se.sharded_lookup_a2a.drops
    if how == 'sharded':
        out = se.sharded_lookup(shard, local_ids, mesh)
    else:
        out = se.sharded_lookup_a2a(shard, local_ids, mesh,
                                    capacity_factor=factor)
    result = {'d': d, 'm': m, 'rows': out.detach().numpy().copy(),
              'drops': se.sharded_lookup_a2a.drops - drops}
    if grad:
        (out * torch.from_numpy(w[rows])).sum().backward()
        g = shard.grad
        if n_data > 1:
            torch.distributed.all_reduce(g, group=mesh.data_group)
        result['grad'] = g.numpy().copy()
    return result


# the fits: DeepFM over SHARDED_VOCABS and a var-len column, against a
# one-process replicated fit from the same seed; Σ vocab 53 pads a row on
# 2 shards, and the first three columns' ids fill 84% of shard 0's
# requests, so a capacity factor of 1.5 drops ids
SHARDED_VOCABS = (3, 4, 5, 41)
VARLEN_VOCAB, VARLEN_TOKENS = 9, 3
SHARDED_CASES = {
    'sharded_adam_l2': {'embedding_device_strategy': 'sharded',
                        'embeddings_regularizer': 'l2'},
    'a2a_lamb': {'embedding_device_strategy': 'sharded_a2a',
                 'optimizer': 'lamb'},
    'a2a_adam_dropout': {'embedding_device_strategy': 'sharded_a2a',
                         'embedding_dropout': 0.3, 'dense_dropout': 0.2},
}
CAPACITY_CASE = {'embedding_device_strategy': 'sharded_a2a',
                 'embedding_a2a_capacity_factor': 1.5}
N_PREDICT = 101  # not a multiple of the data shards: a padded remainder


def sharded_data(seed=0):
    rng = np.random.default_rng(seed)
    n = N_TRAIN + N_VAL
    cat = np.stack([rng.integers(0, v, n) for v in SHARDED_VOCABS], axis=1)
    dense = rng.normal(size=(n, 3)).astype(np.float32)
    tokens = rng.integers(1, VARLEN_VOCAB, (n, VARLEN_TOKENS))
    tokens[rng.uniform(size=tokens.shape) < 0.3] = 0
    score = dense[:, 0] + (cat[:, 3] % 3 == 0) - 0.5
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-score))).astype(np.float32)
    return ({'cat': cat.astype(np.int32), 'input_continuous_all': dense,
             'genres': tokens.astype(np.int32)}, y)


def sharded_model(spec, strategy=None, device='cpu'):
    from deeptables_torch.models import (CategoricalColumn, ContinuousColumn,
                                         DeepModel, ModelConfig,
                                         VarLenCategoricalColumn)
    spec = dict(spec)
    config = ModelConfig(
        nets=['linear', 'fm_nets', 'dnn_nets'], task='binary',
        metrics=['AUC'], embedding_dropout=spec.pop('embedding_dropout', 0),
        dnn_params={'hidden_units': ((32, 0, False), (16, 0, False))},
        distribute_strategy=strategy, **spec)
    cats = tuple(CategoricalColumn(f'C{i}', v, 8)
                 for i, v in enumerate(SHARDED_VOCABS))
    conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
    genres = VarLenCategoricalColumn('genres', VARLEN_VOCAB, 8,
                                     pooling_strategy='max')
    genres.max_elements_length = VARLEN_TOKENS
    return DeepModel('binary', 2, config, cats, conts,
                     var_categorical_len_columns=[genres], device=device)


def sharded_fit(spec, strategy=None):
    """A fit of ``EPOCHS`` epochs of ``BATCH``-row batches. Returns (the
    whole state, the history, the predictions on the first N_PREDICT rows,
    the model)."""
    X, y = sharded_data()
    tr = {k: v[:N_TRAIN] for k, v in X.items()}
    va = {k: v[N_TRAIN:] for k, v in X.items()}
    model = sharded_model(spec, strategy)
    history = model.fit(tr, y[:N_TRAIN], batch_size=BATCH, epochs=EPOCHS,
                        verbose=0, validation_data=(va, y[N_TRAIN:]))
    state = {k: v.detach().cpu().numpy().copy()
             for k, v in model.full_state_dict().items()}
    predictions = model.predict({k: v[:N_PREDICT] for k, v in X.items()},
                                batch_size=64)
    return (state, {k: list(v) for k, v in history.history.data.items()},
            predictions, model)


def job_model_axis(rank, world, store):
    from deeptables_torch.parallel import DataAndModelParallel, build_mesh
    _join(rank, world, store)
    meshes = {(2, 2): build_mesh(2, 2), (1, 4): build_mesh(1, 4)}
    out = {'mesh': {k: (m.data_index, m.model_index)
                    for k, m in meshes.items()}}
    out['lookups'] = {case: _lookup(case, meshes) for case in LOOKUP_CASES
                      if LOOKUP_CASES[case][0] in meshes}
    for case, spec in SHARDED_CASES.items():
        strategy = DataAndModelParallel(data_parallel=2, model_parallel=2)
        state, history, predictions, model = sharded_fit(spec, strategy)
        table = model.module.emb_categorical_vars_all.embeddings_d8
        out[case] = {'state': state, 'history': history,
                     'predictions': predictions,
                     'shard_rows': tuple(table.shape)}
    return out


def _captured_warnings():
    import logging
    from deeptables_torch.parallel import sharded_embedding
    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())
    sharded_embedding.logger.addHandler(Keep())
    return messages


def _tsv_shards(tmp, seed=1):
    """Two Criteo-format shards of 160 rows (4 integers, 3 tokens)."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(2):
        lines = []
        for _ in range(160):
            dense = rng.integers(0, 100, 4)
            cats = rng.integers(0, 2 ** 32, 3)
            label = int(rng.random() < 1 / (1 + np.exp(-(dense[0] - 50) / 20)))
            lines.append('\t'.join([str(label)] + [str(v) for v in dense] +
                                   [format(int(v), '08x') for v in cats]))
        path = os.path.join(tmp, f'day_{i}.tsv')
        with open(path, 'w') as f:
            f.write('\n'.join(lines) + '\n')
        paths.append(path)
    return paths


STREAM_BUCKETS = (64, 128, 256)


def stream_fit(paths, strategy=None):
    """DeepFM over a CriteoStreamLoader, one epoch: the losses by epoch."""
    from deeptables_torch.data.criteo import (CriteoStreamLoader,
                                              criteo_columns)
    from deeptables_torch.data.fast_ingest import CriteoTsvSource
    from deeptables_torch.models import DeepModel, ModelConfig
    source = CriteoTsvSource(paths, n_dense=4, n_cat=3,
                             hash_buckets=list(STREAM_BUCKETS),
                             chunk_bytes=8192)
    loader = CriteoStreamLoader(source, batch_size=64)
    cats, conts = criteo_columns(STREAM_BUCKETS, emb_dim=4, n_dense=4)
    config = ModelConfig(nets=['linear', 'fm_nets', 'dnn_nets'],
                         metrics=['AUC'], task='binary', embedding_dropout=0,
                         distribute_strategy=strategy,
                         embedding_device_strategy='sharded')
    model = DeepModel('binary', 2, config, cats, conts, device='cpu')
    return list(model.fit(loader, epochs=1, verbose=0).history['loss'])


def deeptable_frame(n=512, seed=0):
    import pandas as pd
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({'c1': rng.integers(0, 50, n).astype(str),
                       'c2': rng.integers(0, 30, n).astype(str),
                       'n1': rng.normal(size=n)})
    return df, pd.Series(rng.choice(['a', 'b'], n))


def job_model_axis_1x2(rank, world, store, tmp, bridged):
    import torch
    from deeptables_torch.models import DeepTable, ModelConfig
    from deeptables_torch.parallel import (DataAndModelParallel, build_mesh,
                                           sharded_embedding)
    from deeptables_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    _join(rank, world, store)
    meshes = {(1, 2): build_mesh(1, 2)}
    out = {'lookups': {case: _lookup(case, meshes) for case in LOOKUP_CASES
                       if LOOKUP_CASES[case][0] == (1, 2)}}

    def strategy():
        return DataAndModelParallel(data_parallel=1, model_parallel=2)

    # a capacity factor of 1.5: dropped ids, counted and logged
    warnings = _captured_warnings()
    drops = sharded_embedding.sharded_lookup_a2a.drops
    _, history, _, model = sharded_fit(CAPACITY_CASE, strategy())
    out['capacity'] = {
        'loss': history['loss'],
        'drops': sharded_embedding.sharded_lookup_a2a.drops - drops,
        'warnings': [w for w in warnings if 'capacity' in w]}

    # save: rank 0 writes the whole tables; predictions to compare with a
    # one-process load of the file (of an exact lookup: a bounded capacity
    # drops ids in inference too)
    _, _, _, model = sharded_fit({'embedding_device_strategy': 'sharded_a2a'},
                                 strategy())
    X, _ = sharded_data()
    head = {k: v[:N_PREDICT] for k, v in X.items()}
    model.save(os.path.join(tmp, 'sharded.dt'))
    out['saved_predictions'] = model.predict(head, batch_size=64)

    # a checkpoint round trip on the same mesh, and read back whole
    path = save_checkpoint(os.path.join(tmp, 'ckpt'), model)
    fresh = sharded_model({'embedding_device_strategy': 'sharded_a2a'},
                          strategy())
    restore_checkpoint(path, fresh)
    params = [(k, v, fresh.module.state_dict()[k])
              for k, v in model.module.state_dict().items()]
    moments = [(key, model.optimizer.state[p][key],
                fresh.optimizer.state[q][key])
               for p, q in zip(model.module.parameters(),
                               fresh.module.parameters())
               for key in ('exp_avg', 'exp_avg_sq', 'step')]
    out['checkpoint'] = {
        'params_equal': all(torch.equal(a, b) for _, a, b in params),
        'moments_equal': all(torch.equal(a, b) for _, a, b in moments),
        'whole': restore_checkpoint(path)['model'][
            'emb_categorical_vars_all.embeddings_d8'].numpy(),
        'full_table': model.full_state_dict()[
            'emb_categorical_vars_all.embeddings_d8'].numpy()}

    # a JAX model's weights bridged into the sharded model
    with open(bridged, 'rb') as f:
        case = pickle.load(f)
    port = sharded_model({'embedding_device_strategy': 'sharded_a2a'},
                         strategy())
    port.build().load_state_dict(
        {k: torch.from_numpy(v) for k, v in case['state_dict'].items()})
    logits, _ = port.forward_batch(case['batch'])
    out['bridged_logits'] = logits.numpy()

    # DeepTable and a streaming fit under the strategy
    df, y = deeptable_frame()
    conf = ModelConfig(nets=['dnn_nets'], metrics=['AUC'],
                       distribute_strategy=strategy(),
                       embedding_device_strategy='sharded',
                       embedding_dropout=0, home_dir=os.path.join(tmp, 'dt'))
    dt = DeepTable(config=conf, device='cpu')
    _, dt_history = dt.fit(df, y, epochs=1, batch_size=64, verbose=0)
    out['deeptable'] = {'history': dict(dt_history.history),
                        'proba': dt.predict_proba(df.head(50))}
    out['stream_loss'] = stream_fit(_tsv_shards(tmp), strategy())
    return out


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
