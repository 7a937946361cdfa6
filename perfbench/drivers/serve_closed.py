"""Serving through ``serving.Predictor.predict_proba_arrays``: the driver of
the ``serve_closed`` mixes.

A closed loop of one caller: each request waits for its answer before the
next is sent. A request is ``n`` consecutive rows of a pool of
``pool_rows`` rows drawn from the seed, at one of ``OFFSETS`` offsets; the
sizes are ``DISTINCT_SIZES`` fixed log-uniform quantiles of ``[min_rows,
max_rows]`` (``harness/inputs.py``), in an order drawn from the seed,
repeated. The Predictor (its default buckets) is built over the
port's model with the harness's weights, through the small holder its
docstring allows; set-up runs each size once.

End to end: ``serve_rows_per_s``, the rows answered by the window's
requests over the window's wall time; ``serve_p95_ms``, the 95th
percentile of every request's latency on the host clock, from the call
until its numpy answer returns; ``setup_s``, from the process's start to
the first timed request.

Correct: once the window has closed, a sample of ``SAMPLE_REQUESTS`` of
its requests drawn from the seed, and its longest request, are answered
again by the reference (``reference/model.py``, inference BatchNorm, in
float64) from the same weights and rows; compared is the largest gap
between a returned probability and the reference's."""

import math
import time

import numpy as np
import torch

from deeptables_torch.serving import Predictor

from perfbench import nets as nets_lib
from perfbench.harness import (compare, device as dev, faults, inputs, port,
                               spans, trace as trace_lib, weights)
from perfbench.harness.outcome import Outcome, phase_seconds
from perfbench.reference import model as ref_model

DISTINCT_SIZES = 128
OFFSETS = 4096
SAMPLE_REQUESTS = 24
# a traced run profiles PROFILE_SECONDS of requests from PROFILE_AFTER of
# the window on
PROFILE_AFTER = 0.25
PROFILE_SECONDS = 1.0
# the reference that judges the answers, as ``train_fit.PRECISION``
PRECISION = 'fp64'


class Mix:
    """The seed's requests: ``request(k)`` is the k-th one's ``(offset,
    size)``; ``arrays(offset, size)`` its packed rows."""

    def __init__(self, cell, seed):
        traffic = cell.traffic
        rng = np.random.default_rng([int(seed), 12])
        sizes = inputs.request_sizes(int(traffic['min_rows']),
                                     int(traffic['max_rows']), DISTINCT_SIZES)
        self.sizes = sizes[rng.permutation(len(sizes))]
        pool = int(traffic['pool_rows'])
        self.cat, self.dense = inputs.rows(
            rng, cell.config, pool + int(traffic['max_rows']),
            traffic['zipf_a'])
        self.offsets = rng.integers(0, pool, OFFSETS)

    def request(self, k):
        return (int(self.offsets[k % len(self.offsets)]),
                int(self.sizes[k % len(self.sizes)]))

    def arrays(self, offset, size):
        return port.arrays(self.cat[offset:offset + size],
                           self.dense[offset:offset + size])


def setup(cell, seed, device, fault=None, marks=None):
    """The seed's mix, the model, its probe and the warmed Predictor;
    ``marks`` as ``train_fit.first_steps`` keeps them."""
    config = cell.config
    marks = [] if marks is None else marks
    mix = Mix(cell, seed)
    marks.append(('data', time.time()))
    model = port.build(config, seed, device)
    model.build()
    dev.synchronize(device)
    marks.append(('build', time.time()))
    port.load(model, weights.make(config, seed, device), config)
    dev.synchronize(device)
    marks.append(('weights', time.time()))
    predictor = Predictor(port.estimator(model))
    faults.apply(fault, config, model, predictor)
    probe = spans.Probe(model)
    for size in sorted(set(mix.sizes.tolist())):
        predictor.predict_proba_arrays(mix.arrays(0, size), size)
    dev.synchronize(device)
    marks.append(('warmup', time.time()))
    return mix, model, probe, predictor


def serve(mix, predictor, probe, seconds, device, profiler=None):
    """The window: ``(answers [(offset, size, proba)], latencies s, wall s,
    trace, record)``."""
    answers, latencies = [], []
    trace, record, stretch = None, {}, None
    dev.synchronize(device)
    t_start = time.perf_counter()
    k = 0
    while True:
        now = time.perf_counter()
        if profiler is not None and stretch is None \
                and now - t_start >= PROFILE_AFTER * seconds:
            counters = dev.launch_counters()
            profiler.start()
            stretch = (time.perf_counter(), counters,
                       len(probe.forward_rows), k)
        offset, size = mix.request(k)
        arrays = mix.arrays(offset, size)
        t = time.perf_counter()
        if profiler is not None:
            with torch.profiler.record_function(spans.REQUEST):
                proba = predictor.predict_proba_arrays(arrays, size)
        else:
            proba = predictor.predict_proba_arrays(arrays, size)
        done = time.perf_counter()
        latencies.append(done - t)
        answers.append((offset, size, proba))
        k += 1
        if stretch is not None and trace is None \
                and done - stretch[0] >= PROFILE_SECONDS:
            trace = profiler.stop()
            record = {
                'launches': dev.counter_deltas(stretch[1],
                                               dev.launch_counters()),
                'forward_rows': probe.forward_rows[stretch[2]:],
                'requested_rows': sum(a[1] for a in answers[stretch[3]:])}
        if done - t_start >= seconds and (profiler is None
                                          or trace is not None):
            return answers, latencies, done - t_start, trace, record


def sample(answers, seed, count=SAMPLE_REQUESTS):
    """Indices of ``count`` answers drawn from the seed, and of the longest
    request (the first of the longest)."""
    rng = np.random.default_rng([int(seed), 13])
    picked = set(rng.choice(len(answers), min(count, len(answers)),
                            replace=False).tolist())
    picked.add(max(range(len(answers)), key=lambda i: answers[i][1]))
    return sorted(picked)


def reference(cell, seed, device, mix, requests, precision=PRECISION):
    """The reference's probabilities ``(n, 2)`` of each ``(offset, size)``."""
    params = ref_model.cast(weights.make(cell.config, seed, device),
                            precision)
    out = []
    with ref_model.ieee_float32(), torch.no_grad():
        for offset, size in requests:
            cat = torch.as_tensor(mix.cat[offset:offset + size],
                                  dtype=torch.int64, device=device)
            dense = torch.as_tensor(mix.dense[offset:offset + size],
                                    device=device)
            dense = ref_model.cast({'x': dense}, precision)['x']
            p = torch.sigmoid(ref_model.forward(
                params, cell.config, cat, dense, False, precision))
            out.append(torch.cat([1 - p, p], dim=1).double().cpu().numpy())
    return out


def proba_gap(program, ref):
    """The largest ``|p - r|`` over the answers; a missing or misshapen
    answer reads infinity."""
    worst = 0.0
    for got, want in zip(program, ref):
        got = np.asarray(got)
        if got.shape != want.shape or not np.all(np.isfinite(got)):
            return math.inf
        worst = max(worst, float(np.max(np.abs(got.astype(np.float64)
                                               - want))))
    return worst if len(program) == len(ref) else math.inf


def run(cell, seed, seconds, trace, device, t0, fault=None):
    marks = [('start', t0)]
    mix, model, probe, predictor = setup(cell, seed, device, fault, marks)
    setup_s = time.time() - t0
    if not trace:
        probe.remove()
    dev.reset_peak(device)
    answers, latencies, wall, trace_, record = serve(
        mix, predictor, probe, seconds, device,
        trace_lib.Profiler(dev.is_cuda(device)) if trace else None)
    peak = dev.memory_peak(device)
    if trace:
        record['kernel_calls'] = nets_lib.kernel_calls(
            cell.config, [(rows, 'infer') for rows in record['forward_rows']])
    probe.remove()
    del predictor, model, probe
    dev.free(device)

    failed = sum(1 for _, n, p in answers
                 if np.shape(p) != (n, 2) or not np.all(np.isfinite(p)))
    picked = sample(answers, seed)
    requests = [answers[i][:2] for i in picked]
    ref = reference(cell, seed, device, mix, requests)
    gap = proba_gap([answers[i][2] for i in picked], ref)
    rows = sum(a[1] for a in answers)
    return Outcome(
        metrics={'serve_rows_per_s': rows / wall,
                 'serve_p95_ms': 1e3 * float(np.percentile(latencies, 95)),
                 'setup_s': setup_s},
        checks=compare.checks({'proba_gap': gap}, cell.limits),
        attempted=len(answers), failed=failed, memory_peak_bytes=peak,
        trace=trace_, record=record,
        phases=phase_seconds(marks),
        notes={'latency_s': latencies})
