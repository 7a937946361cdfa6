# -*- coding:utf-8 -*-
"""The port's spans (``utils/profiling.annotate``) on the CPU: off, a span
is one shared null context that records nothing; under ``torch.profiler``
a fit and a ``Predictor`` log the span tree that the trace's
``deeptables.*`` ranges show, with step numbers, request ids and counts.
The card's part (the backward's kernel spans on the autograd engine's
device thread) is marked ``cuda``."""

import json
import threading
import types

import numpy as np
import pytest
import torch

from deeptables_torch.models.callbacks import Callback
from deeptables_torch.models.config import ModelConfig
from deeptables_torch.models.deepmodel import DeepModel
from deeptables_torch.models.metainfo import (CategoricalColumn,
                                              ContinuousColumn)
from deeptables_torch.serving import Predictor
from deeptables_torch.utils import profiling

VOCAB, FIELDS, DIM, DENSE = 30, 4, 4, 3
BATCH, ROWS = 16, 64
BUCKETS = (8, 32)
STEP_PARTS = ['deeptables.input.check_ids', 'deeptables.input.copy',
              'deeptables.input.copy', 'deeptables.step.forward',
              'deeptables.step.backward', 'deeptables.step.optimizer',
              'deeptables.step.loss_state']


@pytest.fixture(autouse=True)
def empty_log():
    profiling.take_spans()
    yield
    profiling.take_spans()


def _model(device='cpu'):
    config = ModelConfig(nets=['linear', 'fm_nets', 'dnn_nets'],
                         metrics=['AUC'], embedding_dropout=0.0,
                         dnn_params={'hidden_units': ((8, 0.0, False),),
                                     'activation': 'relu'})
    cats = tuple(CategoricalColumn(f'C{i}', VOCAB, DIM)
                 for i in range(FIELDS))
    conts = (ContinuousColumn('input_continuous_all',
                              [f'I{i}' for i in range(DENSE)]),)
    return DeepModel('binary', 2, config, cats, conts, device=device)


def _data(seed=0, rows=ROWS):
    rng = np.random.default_rng(seed)
    X = {'cat': rng.integers(0, VOCAB, (rows, FIELDS)).astype(np.int32),
         'input_continuous_all': rng.normal(size=(rows, DENSE)).astype(
             np.float32)}
    return X, rng.integers(0, 2, rows).astype(np.float32)


def _children(log, entry):
    return [e for e in log if e['parent'] == entry['id']]


def _backward_thread(device):
    """The thread the autograd engine runs a backward on, for ``device``."""
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            seen.append(threading.get_native_id())
            return g * 2

    Probe.apply(torch.ones(2, device=device, requires_grad=True)) \
        .sum().backward()
    return seen[0]


# ---------------------------------------------------------------- off

def test_off_a_span_is_one_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('a record_function was made')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(profiling, '_range_enter', refuse)
    off = profiling.annotate('deeptables.step', step=1, rows=8)
    assert off is profiling.annotate('deeptables.serve.pad')
    with off:
        with profiling.annotate('deeptables.input.copy', bytes=64):
            pass
    assert profiling.spanned('deeptables.kernel.x')(lambda v: v + 1)(1) == 2
    assert list(profiling.iterate('deeptables.fit.batch', [1, 2])) == [1, 2]
    model = _model()
    model.fit(*_data(), batch_size=BATCH, epochs=1, verbose=0,
              validation_data=_data(1))
    Predictor(types.SimpleNamespace(
        task='binary', preprocessor=None, get_model=lambda s: model),
        batch_buckets=BUCKETS).predict_proba_arrays(_data(2, 5)[0])
    assert profiling.take_spans() == []


def test_a_span_while_profiling_logs_its_ids_and_counts():
    with torch.profiler.profile():
        with profiling.annotate('deeptables.step', step=7, rows=8):
            with profiling.annotate('deeptables.input.copy', bytes=64):
                pass
        with profiling.annotate('deeptables.serve.request', request=3):
            pass
    outer, inner, request = profiling.take_spans()
    assert (outer['name'], outer['parent'], outer['step']) == \
        ('deeptables.step', None, 7)
    assert outer['counts'] == {'rows': 8} and 'step' not in outer['counts']
    assert inner['parent'] == outer['id'] and inner['step'] == 7
    assert inner['counts'] == {'bytes': 64}
    assert inner['thread'] == threading.get_native_id()
    # a span's ids hold only while it is open
    assert request['step'] is None and request['request'] == 3
    assert profiling.take_spans() == []


# ---------------------------------------------------------------- fit

@pytest.fixture(scope='module')
def fitted():
    """A fit of three epochs whose second a callback profiles, as the
    benchmark does: the profiler starts and stops between spans."""
    profiling.take_spans()

    class ProfileEpoch(Callback):
        def on_epoch_begin(self, epoch, logs=None):
            if epoch == 1:
                self.prof = torch.profiler.profile()
                self.prof.start()

        def on_epoch_end(self, epoch, logs=None):
            if epoch == 1:
                self.prof.stop()

    model = _model()
    model.fit(*_data(), batch_size=BATCH, epochs=3, verbose=0,
              validation_data=_data(1), callbacks=[ProfileEpoch()])
    return model, profiling.take_spans()


def test_fit_logs_each_step_in_order(fitted):
    model, log = fitted
    per_epoch = ROWS // BATCH
    steps = [e for e in log if e['name'] == 'deeptables.step']
    # the profiled epoch's steps, numbered over the model's life
    assert [e['step'] for e in steps] == list(
        range(per_epoch + 1, 2 * per_epoch + 1))
    assert model.steps_trained == 3 * per_epoch
    main = threading.get_native_id()
    for step in steps:
        assert step['parent'] is None and step['thread'] == main
        assert step['counts'] == {'rows': BATCH}
        parts = _children(log, step)
        assert [e['name'] for e in parts] == STEP_PARTS
        assert all(e['step'] == step['step'] for e in parts)
        copies = [e['counts']['bytes'] for e in parts
                  if e['name'] == 'deeptables.input.copy']
        assert copies == [BATCH * (FIELDS + DENSE) * 4, BATCH * 4]
        forward = parts[3]
        assert [e['name'] for e in _children(log, forward)] == [
            'deeptables.model.embedding', 'deeptables.model.dense',
            'deeptables.model.net.linear', 'deeptables.model.net.fm_nets',
            'deeptables.model.net.dnn_nets', 'deeptables.model.head',
            'deeptables.step.loss']


def test_fit_logs_the_epoch_loop(fitted):
    _, log = fitted
    top = [e['name'] for e in log if e['parent'] is None]
    per_epoch = ROWS // BATCH
    # the loop stops at the epoch's last step, before a further batch
    assert top == ['deeptables.fit.batch', 'deeptables.step'] * per_epoch + [
        'deeptables.fit.train_metrics', 'deeptables.fit.validation']
    validation = next(e for e in log
                      if e['name'] == 'deeptables.fit.validation')
    assert validation['step'] is None
    # the validation forward's input and model spans sit under it
    names = {e['name'] for e in log if e['parent'] == validation['id']}
    assert 'deeptables.input.check_ids' in names
    # no span is left open on the thread
    assert not getattr(profiling._local, 'stack', [])


def test_backward_kernel_spans_run_on_the_autograd_thread(fitted):
    _, log = fitted
    autograd = _backward_thread('cpu')
    by_id = {e['id']: e for e in log}
    kernels = [e for e in log if e['name'] in (
        'deeptables.kernel.emb_grad', 'deeptables.kernel.fm_backward')]
    assert {e['name'] for e in kernels} == {'deeptables.kernel.emb_grad',
                                            'deeptables.kernel.fm_backward'}
    for e in kernels:
        assert e['thread'] == autograd and e['step'] is not None
        # on the CPU the engine runs the backward on the calling thread
        assert by_id[e['parent']]['name'] == 'deeptables.step.backward'
        assert by_id[e['parent']]['step'] == e['step']
    forward = [e for e in log if e['name'] == 'deeptables.kernel.fm']
    assert forward and all(by_id[e['parent']]['name'] ==
                           'deeptables.model.net.fm_nets' for e in forward)


# ---------------------------------------------------------------- serving

def test_requests_log_ids_rows_and_padding():
    model = _model()
    predictor = Predictor(types.SimpleNamespace(
        task='binary', preprocessor=None, get_model=lambda s: model),
        batch_buckets=BUCKETS)
    sizes = [1, 8, 9, 32, 33, 70]
    X, _ = _data(3, max(sizes))
    with torch.profiler.profile():
        for n in sizes:
            proba = predictor.predict_proba_arrays(
                {k: v[:n] for k, v in X.items()}, n)
            assert proba.shape == (n, 2)
    log = profiling.take_spans()
    requests = [e for e in log if e['name'] == 'deeptables.serve.request']
    assert len({e['request'] for e in requests}) == len(sizes)
    for entry, n in zip(requests, sizes):
        assert entry['counts'] == {
            'rows': n, 'padded_rows': predictor._bucket_for(n) - n}
        parts = [e['name'] for e in _children(log, entry)]
        assert parts == ['deeptables.serve.pad', 'deeptables.serve.forward',
                         'deeptables.serve.copy_back',
                         'deeptables.serve.copy_back']
        inside = [e for e in log if e['id'] > entry['id']
                  and e['request'] == entry['request']]
        assert {e['name'] for e in inside} >= {
            'deeptables.input.check_ids', 'deeptables.input.copy',
            'deeptables.model.head', 'deeptables.kernel.fm'}
    assert [e['counts']['padded_rows'] for e in requests] == \
        [7, 0, 23, 0, 31, 26]


# ---------------------------------------------------------------- export

def test_trace_writes_the_ranges_and_the_span_log(tmp_path):
    model = _model()
    X, y = _data()
    with profiling.trace(str(tmp_path)):
        model.fit(X, y, batch_size=BATCH, epochs=1, verbose=0,
                  validation_data=_data(1))
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    ranges = [e for e in events if e.get('cat') == 'user_annotation'
              and e['name'].startswith('deeptables.')]
    spans = json.loads((tmp_path / 'spans.json').read_text())
    assert sorted(e['name'] for e in ranges) == \
        sorted(e['name'] for e in spans)
    assert {e['name'] for e in spans} >= {
        'deeptables.step', 'deeptables.step.backward',
        'deeptables.fit.validation', 'deeptables.kernel.emb_grad'}
    assert {e['tid'] for e in ranges} == {e['thread'] for e in spans}
    # the log was taken by the export
    assert profiling.take_spans() == []


def test_the_span_log_holds_its_ranges_on_one_clock(tmp_path):
    """Each entry's wall-clock ``start``/``end`` holds its range in the
    trace once shifted by the trace's one base: the offsets that each
    entry admits (µs) have a common value."""
    model = _model()
    X, y = _data()
    with profiling.trace(str(tmp_path)):
        model.fit(X, y, batch_size=BATCH, epochs=1, verbose=0,
                  validation_data=_data(1))
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    ranges = sorted((e for e in events if e.get('cat') == 'user_annotation'
                     and e['name'].startswith('deeptables.')),
                    key=lambda e: (e['tid'], e['ts']))
    spans = sorted(json.loads((tmp_path / 'spans.json').read_text()),
                   key=lambda e: (e['thread'], e['start']))
    assert [e['name'] for e in ranges] == [e['name'] for e in spans]
    first = spans[0]['start']
    lo = max(r['ts'] + r['dur'] - (e['end'] - first) / 1e3
             for r, e in zip(ranges, spans))
    hi = min(r['ts'] - (e['start'] - first) / 1e3
             for r, e in zip(ranges, spans))
    assert all(e['start'] <= e['end'] for e in spans)
    # the trace's microseconds carry three decimals
    assert lo <= hi + 2e-3


# ---------------------------------------------------------------- card

@pytest.mark.cuda
def test_backward_kernel_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    model = _model('cuda')
    X, y = _data()
    model.fit(X, y, batch_size=BATCH, epochs=1, verbose=0,
              validation_data=_data(1))
    autograd = _backward_thread('cuda')
    with torch.profiler.profile():
        model.fit(X, y, batch_size=BATCH, epochs=1, verbose=0,
                  validation_data=_data(1))
        torch.cuda.synchronize()
    log = profiling.take_spans()
    kernels = [e for e in log if e['name'] == 'deeptables.kernel.emb_grad']
    assert len(kernels) == ROWS // BATCH
    steps = [e['step'] for e in log if e['name'] == 'deeptables.step']
    assert autograd != threading.get_native_id()
    for e, step in zip(kernels, steps):
        # on another thread: no parent there, the step's number all the same
        assert (e['thread'], e['parent'], e['step']) == (autograd, None, step)
