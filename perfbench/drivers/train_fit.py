"""Training through ``DeepModel.fit``: the driver of the ``train_fit`` mixes.

Set-up builds one model from the configuration, loads the harness's
weights, and fits it for ``WARMUP_EPOCHS`` over the seed's pool of
``pool_batches`` batches (shuffled, ``validation_batches`` more as
``validation_data``, ``metrics`` on both): that warms every shape of the
window and is where the first ``REFERENCE_STEPS`` steps are read. The
window then calls ``fit`` on the same model, over the same pool, epoch
after epoch, and ends at the first epoch end after ``--seconds``.

End to end: ``train_examples_per_s``, the examples of the window's whole
epochs over their wall time (each epoch's training metric, validation batch
and validation metric included); ``setup_s``, from the process's start to
the window's first step.

Correct: the reference (``reference/train.py``, in float64) takes the same
initial weights and the rows the program's first steps were handed, and
runs the same steps; compared are each step's loss, the norm of step 1's
gradient as the optimizer got it (from Adam's first moment after one step)
and the norm of each leaf's change after the last, each leaf against the
reference's norm of that leaf, by the worst leaf, and the gradient's also
by the median leaf (``harness/compare.py``)."""

import math
import time

import numpy as np
import torch

from deeptables_torch.models.callbacks import Callback

from perfbench import nets as nets_lib
from perfbench.harness import (compare, device as dev, faults, inputs, port,
                               spans, trace as trace_lib, weights)
from perfbench.harness.outcome import Outcome, phase_seconds
from perfbench.reference import train as ref_train

WARMUP_EPOCHS = 1
# the steps the reference follows; the optimizer's state after step 1 gives
# the first gradient, the parameters after the last their change
REFERENCE_STEPS = 3
# the window's epoch that a traced run profiles: its second, the first
# after one that may still fill the allocator's pools
PROFILE_EPOCH = 1
# the reference that judges the program: float64, so that float32's own
# rounding, which the program shares, is not counted against it
PRECISION = 'fp64'
# ``grad_own_gap``'s leaves: those whose reference gradient is over this
# share of the median leaf's (a leaf under ``compare.ROUNDING_SHARE`` of it
# may still carry a fault of its own, as ``cin_tile`` in xDeepFM's last
# CIN layer, at 7e-5 of it)
OWN_SHARE = 1e-6


def make_data(cell, seed):
    config, traffic = cell.config, cell.traffic
    rng = np.random.default_rng([int(seed), 11])
    batch = int(traffic['batch_size'])
    n_train = batch * int(traffic['pool_batches'])
    n_val = batch * int(traffic['validation_batches'])
    cat, dense = inputs.rows(rng, config, n_train + n_val, traffic['zipf_a'])
    y = inputs.labels(rng, cat, dense)
    return ((port.arrays(cat[:n_train], dense[:n_train]), y[:n_train]),
            (port.arrays(cat[n_train:], dense[n_train:]), y[n_train:]))


class FirstSteps:
    """The program's first steps, as the harness reads them: the rows each
    step was handed, its loss, step 1's gradient norms (Adam's first moment
    over 1 - β1) and each leaf's change after the last."""

    def __init__(self, model, config, seed, device, steps):
        self.model, self.config = model, config
        self.seed, self.device, self.steps = seed, device, steps
        self.leaves = port.leaves(model, config)
        self.batches, self.losses = [], []
        self.grad_norms, self.change_norms = None, None

    def on_train_step(self, batch, yb, wb, loss):
        if len(self.batches) < self.steps:
            self.batches.append(port.columns(batch) + (yb.copy(),))
            self.losses.append(float(loss))

    def on_optimizer_step(self, n):
        if n == 1:
            optimizer = self.model.optimizer
            beta1 = optimizer.param_groups[0]['betas'][0]
            self.grad_norms = {}
            for leaf, p in self.leaves.items():
                m = optimizer.state.get(p, {}).get('exp_avg')
                self.grad_norms[leaf] = math.inf if m is None else float(
                    torch.linalg.vector_norm(m)) / (1 - beta1)
        if n == self.steps:
            self.change_norms = {}
            for leaf, p in self.leaves.items():
                p0 = weights.leaf(self.config, self.seed, self.device, leaf)
                self.change_norms[leaf] = float(
                    torch.linalg.vector_norm(p.detach() - p0))
                del p0

    def readings(self):
        return {'losses': self.losses, 'grad_norms': self.grad_norms or {},
                'change_norms': self.change_norms or {}}


class Window(Callback):
    """Times the window's epochs; ends ``fit`` at the first epoch end after
    ``seconds``; profiles epoch ``PROFILE_EPOCH`` when given a profiler."""

    def __init__(self, seconds, device, profiler=None, probe=None):
        self.seconds, self.device = seconds, device
        self.profiler = profiler
        self.probe = probe
        self.t_start, self.ends, self.losses = None, [], []
        self.trace, self.record = None, {}

    def on_epoch_begin(self, epoch, logs=None):
        if epoch == 0:
            dev.synchronize(self.device)
            self.t_start = time.perf_counter()
        if self.profiler is not None and epoch == PROFILE_EPOCH:
            self._before = (dev.launch_counters(), self.probe.optimizer_steps,
                            len(self.probe.forward_rows))
            self.profiler.start()

    def on_epoch_end(self, epoch, logs=None):
        dev.synchronize(self.device)
        t = time.perf_counter()
        self.ends.append(t)
        self.losses.append((logs or {}).get('loss', math.nan))
        if self.profiler is not None and epoch == PROFILE_EPOCH:
            self.trace = self.profiler.stop()
            counters, steps, forwards = self._before
            self.record = {
                'launches': dev.counter_deltas(counters,
                                               dev.launch_counters()),
                'train_steps': self.probe.optimizer_steps - steps,
                'forward_rows': self.probe.forward_rows[forwards:]}
        profiled = self.profiler is None or self.trace is not None
        if t - self.t_start >= self.seconds and profiled:
            self.model.stop_training = True


def first_steps(cell, seed, device, fault=None, marks=None):
    """Set-up: the model, its probe, the seed's data and the first steps'
    readings, after ``WARMUP_EPOCHS`` of ``fit``. ``marks`` (a list) gets
    ``(phase, time.time())`` at the end of each phase."""
    config, traffic = cell.config, cell.traffic
    marks = [] if marks is None else marks
    train, val = make_data(cell, seed)
    marks.append(('data', time.time()))
    model = port.build(config, seed, device, traffic['metrics'])
    model.build()
    dev.synchronize(device)
    marks.append(('build', time.time()))
    port.load(model, weights.make(config, seed, device), config)
    model.make_optimizer()
    dev.synchronize(device)
    marks.append(('weights', time.time()))
    faults.apply(fault, config, model)
    steps = FirstSteps(model, config, seed, device,
                       REFERENCE_STEPS)
    probe = spans.Probe(model, steps.on_train_step, steps.on_optimizer_step)
    fit_args = dict(batch_size=int(traffic['batch_size']), verbose=0,
                    shuffle=bool(traffic['shuffle']), validation_data=val)
    model.fit(*train, epochs=WARMUP_EPOCHS, **fit_args)
    probe.on_train_step = probe.on_optimizer_step = None
    dev.synchronize(device)
    marks.append(('warmup', time.time()))
    return model, probe, steps, train, fit_args


def reference(cell, seed, device, batches, precision=PRECISION):
    """The reference's readings of the same steps from the same weights."""
    to = lambda a, dtype: torch.as_tensor(a, dtype=dtype, device=device)
    batches = [(to(c, torch.int64), to(d, torch.float32),
                to(y, torch.float32)) for c, d, y in batches]
    params0 = weights.make(cell.config, seed, device)
    return ref_train.adam_steps(params0, cell.config, batches, precision)


def numbers(program, ref):
    """The compared numbers of ``program`` (``FirstSteps.readings()`` or a
    control's ``adam_steps``) against the reference's (``harness/compare``
    says how): the worst step's loss gap; the first gradient's norm gap,
    by the worst leaf, by the worst leaf over its own norm (every leaf
    whose gradient is over ``OWN_SHARE`` of the median leaf's) and by the
    leaves' lower quartile; the change's norm gap by the worst leaf."""
    grads, ref_grads = program['grad_norms'], ref['grad_norms']
    moved = compare.moved_leaves(ref_grads)
    grad, grad_leaf = compare.norm_gap(grads, ref_grads, moved)
    own, own_leaf = compare.norm_gap(
        grads, ref_grads, compare.moved_leaves(ref_grads, OWN_SHARE),
        own=True)
    change, change_leaf = compare.norm_gap(program['change_norms'],
                                           ref['change_norms'], moved)
    return ({'loss_gap': compare.relative_gap(program['losses'],
                                              ref['losses']),
             'grad_gap': grad, 'grad_own_gap': own,
             'grad_quartile_gap': compare.quartile_gap(grads, ref_grads,
                                                       moved),
             'change_gap': change},
            {'grad_gap': grad_leaf, 'grad_own_gap': own_leaf,
             'change_gap': change_leaf,
             'unmoved': sorted(set(ref_grads) - set(moved))})


def run(cell, seed, seconds, trace, device, t0, fault=None):
    traffic = cell.traffic
    marks = [('start', t0)]
    model, probe, steps, train, fit_args = first_steps(cell, seed, device,
                                                       fault, marks)
    setup_s = time.time() - t0
    if not trace:
        probe.remove()
    window = Window(seconds, device,
                    trace_lib.Profiler(dev.is_cuda(device)) if trace else None,
                    probe)
    dev.reset_peak(device)
    model.fit(*train, epochs=10 ** 9, callbacks=[window], **fit_args)
    peak = dev.memory_peak(device)

    batch = int(traffic['batch_size'])
    per_epoch = len(train[1]) // batch
    epochs = len(window.ends)
    examples = epochs * per_epoch * batch
    failed = per_epoch * sum(1 for x in window.losses if not math.isfinite(x))
    record = dict(window.record, batch_size=batch)
    if trace:
        record['kernel_calls'] = nets_lib.kernel_calls(
            cell.config, [(batch, 'train')] * record['train_steps']
            + [(rows, 'infer') for rows in record['forward_rows']])

    program = steps.readings()
    batches = steps.batches
    probe.remove()
    del model, probe, steps, window.model
    dev.free(device)
    ref = reference(cell, seed, device, batches)
    readings, where = numbers(program, ref)
    return Outcome(
        metrics={'train_examples_per_s': examples / (window.ends[-1]
                                                     - window.t_start),
                 'setup_s': setup_s},
        checks=compare.checks(readings, cell.limits),
        attempted=epochs * per_epoch, failed=failed,
        memory_peak_bytes=peak, trace=window.trace, record=record,
        where={k: v for k, v in where.items() if k in readings},
        phases=phase_seconds(marks),
        notes={'epoch_s': np.diff([window.t_start] + window.ends).tolist()})
