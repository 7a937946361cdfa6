# -*- coding:utf-8 -*-
"""Criteo TSV streaming in the port (``deeptables_torch/data/criteo.py``
and ``DeepModel.fit`` over a loader) against the JAX package, on the CPU.

- ``CriteoStreamLoader``'s batches are held exactly equal to the JAX
  package's. Unshuffled, against its loader itself. Shuffled, against its
  ``_chunk_batches`` called chunk by chunk on one thread with one
  generator: the JAX loader shuffles inside two pool workers from that
  generator, so which of two chunks in flight draws first is a race there,
  and this sequence is its order when none is lost.
- A bridged DeepFM trained over the loader for two epochs with a validation
  loader: per-epoch ``loss``, ``val_loss`` and ``val_auc`` rtol 1e-4, the
  final state atol 2e-4 (``tests/test_torch_train.py`` gives the reasons),
  the same ``history`` keys; then ``evaluate`` and ``predict`` over the
  loader within 1e-5. The JAX package's loader fit stacks its steps into
  one ``lax.scan`` (``train_steps_per_dispatch``), the port runs one step a
  batch: the same math, which these tolerances hold.
"""

import jax
import numpy as np
import pytest

from deeptables_tpu.data import criteo as jax_criteo
from deeptables_tpu.data import fast_ingest as jax_fi
from deeptables_torch import bridge
from deeptables_torch.data import criteo, fast_ingest
from torch_parity import SCHEMAS, Case, assert_batches_equal

BUCKETS, _, N_DENSE, _ = SCHEMAS['criteo_tsv']
N_CAT = len(BUCKETS)


def _tsv(n, seed):
    """Criteo-format lines: the label drawn from the first dense value and
    the first column's token (from a pool of 20) so that it can be learnt,
    4 integers (10% blank), 5 tokens of 8 hex digits."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2 ** 32, 20)
    lines = []
    for _ in range(n):
        dense = rng.integers(0, 100, N_DENSE)
        token = int(pool[rng.integers(0, 20)])
        p = 1 / (1 + np.exp(-(dense[0] - 50) / 20 - (token % 3 - 1)))
        cats = [token] + [int(v) for v in rng.integers(0, 2 ** 32, N_CAT - 1)]
        fields = [str(int(rng.random() < p))]
        fields += ['' if rng.random() < 0.1 else str(v) for v in dense]
        fields += [format(v, '08x') for v in cats]
        lines.append('\t'.join(fields))
    return ('\n'.join(lines) + '\n').encode()


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
    """Two training shards of 300 and 220 rows, a validation shard of 150."""
    tmp = tmp_path_factory.mktemp('criteo')
    paths = []
    for i, n in enumerate((300, 220, 150)):
        p = tmp / f'day_{i}.tsv'
        p.write_bytes(_tsv(n, seed=40 + i))
        paths.append(str(p))
    return paths[:2], paths[2:]


def _sources(paths, chunk_bytes=4096):
    kwargs = dict(n_dense=N_DENSE, n_cat=N_CAT, hash_buckets=BUCKETS,
                  chunk_bytes=chunk_bytes)
    return (fast_ingest.CriteoTsvSource(paths, **kwargs),
            jax_fi.CriteoTsvSource(paths, **kwargs))


class SequentialJaxLoader:
    """The JAX package's CriteoStreamLoader in its race-free order: its own
    ``_chunk_batches`` on each chunk in turn, one generator an epoch."""

    def __init__(self, loader):
        self.loader = loader
        self._epoch = 0

    @property
    def steps(self):
        return self.loader.steps

    def __iter__(self):
        rng = np.random.default_rng(self.loader.seed + self._epoch)
        self._epoch += 1
        for chunk in self.loader.source.iter_chunks():
            yield from self.loader._chunk_batches(chunk, rng)


def _loaders(paths, **kwargs):
    port_src, jax_src = _sources(paths)
    port = criteo.CriteoStreamLoader(port_src, **kwargs)
    ref = jax_criteo.CriteoStreamLoader(jax_src, **kwargs)
    if kwargs.get('shuffle', True):
        ref = SequentialJaxLoader(ref)
    return port, ref


def test_criteo_columns_match_jax():
    port = criteo.criteo_columns([100_000] * 7 + [8192] * 19, emb_dim=16)
    ref = jax_criteo.criteo_columns([100_000] * 7 + [8192] * 19, emb_dim=16)
    assert [(c.name, c.vocabulary_size, c.embeddings_output_dim)
            for c in port[0]] == [(c.name, c.vocabulary_size,
                                   c.embeddings_output_dim) for c in ref[0]]
    assert sum(c.vocabulary_size for c in port[0]) == 855_648
    assert [(c.name, c.column_names) for c in port[1]] == \
        [(c.name, c.column_names) for c in ref[1]]
    assert (criteo.CAT_KEY, criteo.DENSE_KEY) == (jax_criteo.CAT_KEY,
                                                  jax_criteo.DENSE_KEY)


@pytest.mark.parametrize('kwargs', [
    {'batch_size': 32},
    {'batch_size': 64, 'drop_remainder': False},
    {'batch_size': 48, 'drop_remainder': False, 'pad_multiple': 20},
], ids=['drop', 'keep', 'pad'])
@pytest.mark.parametrize('shuffle', [False, True])
def test_stream_loader_batches_match_jax(shards, kwargs, shuffle):
    port, ref = _loaders(shards[0], shuffle=shuffle, seed=5, **kwargs)
    for _ in range(2):  # two epochs: the seed advances with each
        assert_batches_equal(port, ref)
    assert port.steps == ref.steps


def test_stream_loader_crosses_chunk_boundaries(shards):
    port, _ = _loaders(shards[0], batch_size=32)
    chunks = list(port.source.iter_chunks())
    assert len(chunks) >= 6 and sum(len(c[0]) for c in chunks) == 520
    # per chunk, the remainder is dropped: fewer batches than 520 // 32
    assert sum(1 for _ in port) == sum(len(c[0]) // 32 for c in chunks)


def test_stream_loader_draws_permutations_in_reading_order(shards):
    """The batches do not depend on how the worker threads are scheduled:
    with the worker slowed down, an epoch gives the same batches."""
    import time
    port, ref = _loaders(shards[0], batch_size=32, seed=2)
    slow = criteo.CriteoStreamLoader(port.source, batch_size=32, seed=2)
    gather = slow._chunk_batches
    slow._chunk_batches = lambda chunk, idx: (time.sleep(0.01),
                                              gather(chunk, idx))[1]
    for _ in range(2):
        assert_batches_equal(slow, ref)


class RaisingStepsLoader(criteo.CriteoStreamLoader):
    """A loader whose ``steps`` may not be read: reading it parses every
    shard."""

    @property
    def steps(self):
        raise AssertionError('steps was evaluated')


def test_loader_steps_are_never_evaluated(shards):
    case = Case('criteo_tsv')
    port = case.port_model()
    src, _ = _sources(shards[0])
    val_src, _ = _sources(shards[1])
    loader = RaisingStepsLoader(src, batch_size=64)
    val = RaisingStepsLoader(val_src, batch_size=64, shuffle=False,
                             drop_remainder=False)
    assert port._is_batch_loader(loader)
    assert not port._is_batch_loader({'cat': np.zeros((2, N_CAT))})
    history = port.fit(loader, epochs=1, verbose=0, validation_data=val)
    assert np.isfinite(history.history['val_loss']).all()
    assert np.isfinite(port.evaluate(val)['loss'])
    assert port.predict(val).shape == (150, 1)


@pytest.fixture(scope='module', params=['shuffled', 'padded'])
def fitted(request, shards):
    """A JAX fit and a port fit from the same weights over the same batches:
    two epochs with a validation loader. 'padded' keeps each chunk's
    remainder, padded with zero-weight rows to a multiple of 16."""
    kwargs = {'shuffled': {'batch_size': 32, 'seed': 3},
              'padded': {'batch_size': 48, 'drop_remainder': False,
                         'pad_multiple': 16, 'shuffle': False}}[request.param]
    case = Case('criteo_tsv', seed=4)
    port = case.port_model()
    train, jax_train = _loaders(shards[0], **kwargs)
    val, jax_val = _loaders(shards[1], batch_size=64, shuffle=False,
                            drop_remainder=False)
    jax_history = case.jax_model.fit(jax_train, epochs=2, verbose=0,
                                     validation_data=jax_val)
    port_history = port.fit(train, epochs=2, verbose=0, validation_data=val)
    return case, port, val, jax_val, jax_history, port_history


@pytest.mark.parametrize('key', ['loss', 'val_loss', 'val_auc'])
def test_stream_fit_trajectory_matches_jax(fitted, key):
    *_, jax_history, port_history = fitted
    assert len(port_history.history[key]) == 2
    np.testing.assert_allclose(port_history.history[key],
                               jax_history.history[key], rtol=1e-4)


def test_stream_fit_logs_the_same_keys(fitted):
    *_, jax_history, port_history = fitted
    assert sorted(port_history.history.data) == \
        sorted(jax_history.history.data)
    assert 'auc' not in port_history.history  # no training metrics


def test_stream_fit_final_state_matches_jax(fitted):
    case, port, *_ = fitted
    expected = bridge.state_dict_from_flax(
        jax.device_get(case.jax_model.variables), case.port_cats,
        case.port_conts, case.port_config)
    state = port.module.state_dict()
    assert set(state) == set(expected)
    for key, value in state.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   rtol=0, atol=2e-4, err_msg=key)


def test_stream_evaluate_and_predict_match_jax(fitted):
    case, port, val, jax_val, *_ = fitted
    got = port.evaluate(val)
    expected = case.jax_model.evaluate(jax_val)
    assert sorted(got.data) == sorted(expected.data)
    for key in expected.data:
        np.testing.assert_allclose(got[key], expected[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(port.predict(val),
                               case.jax_model.predict(jax_val),
                               rtol=1e-5, atol=1e-5)
