# -*- coding:utf-8 -*-
"""Profiling and tracing hooks: the port's copy of
``deeptables_tpu/utils/profiling.py`` on ``torch.profiler``.

- :func:`trace`: a context manager around ``torch.profiler.profile`` (host
  and CUDA activity) that writes a Chrome trace (``trace.json``) or, with
  ``tensorboard=True``, a TensorBoard profile into ``logdir``, and the
  span log (``spans.json``) beside it;
- :func:`annotate`: a named span for a phase of the host's work, the port's
  one span primitive. While a profiler runs on the calling thread it is a
  ``torch.profiler.record_function`` range, stamped on the clock of the
  card's kernels and copies, and an entry of the span log
  (:func:`take_spans`); otherwise it is one shared null context that
  records nothing. :func:`spanned` puts a function's calls in a span,
  :func:`iterate` each ``next`` of an iterator;
- :class:`StepTimer`: rolling step-time and throughput statistics for
  training loops (host clock; a caller timing device work synchronises
  before each ``tick``).

The port names its own spans ``deeptables.<layer>.<part>``: the epoch loop
(``fit.*``), the train step (``step`` and its parts), the input
(``input.*``), the model (``model.*``), the kernels' wrappers
(``kernel.*``) and serving (``serve.*``). README.md lists them.
"""

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import deque

import numpy as np
import torch

from . import dt_logging

logger = dt_logging.get_logger(__name__)

# whether a profiler runs on the calling thread (the autograd engine's
# threads take the state of the thread whose backward they run)
_profiling = torch._C._autograd._profiler_enabled
# a record_function range (a user-scope RecordFunction), opened and closed
# without the Python object and operator dispatch of
# torch.profiler.record_function, which cost the span around it ~10 µs
_range_enter = torch.autograd._record_function_with_args_enter
_range_exit = torch.autograd._record_function_with_args_exit
_OFF = contextlib.nullcontext()
# the log of the spans opened while a profiler ran, until take_spans()
_log = []
_log_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()
# the step number and the request id of the innermost span that gave one,
# for the spans of every thread (a backward's kernels run on another)
_current = {'step': None, 'request': None}


@contextlib.contextmanager
def trace(logdir: str, with_memory: bool = True, tensorboard: bool = False):
    """Capture a host and device trace viewable in Perfetto or
    ``chrome://tracing`` (or TensorBoard); yields the profiler. The spans
    logged meanwhile (:func:`annotate`) are written to ``spans.json`` in
    ``logdir``, a list of the log's entries."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    on_ready = torch.profiler.tensorboard_trace_handler(logdir) \
        if tensorboard else None
    first = next(_ids)
    with profile(activities=activities, profile_memory=with_memory,
                 on_trace_ready=on_ready) as prof:
        yield prof
    if not tensorboard:
        prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
    with open(os.path.join(logdir, 'spans.json'), 'w') as f:
        json.dump([s for s in take_spans() if s['id'] > first], f)
    logger.info(f'profiler trace written to {logdir}')


class _Span:
    """An open span: a ``record_function`` range and its log entry. The
    range opens first and closes last, and the entry's times lie just
    outside it, so that the span's own cost falls inside it and inside
    its entry, and not in the span around it."""

    __slots__ = ('name', 'counts', 'saved', 'range')

    def __init__(self, name, counts):
        self.name, self.counts = name, counts

    def __enter__(self):
        start = time.time_ns()
        self.range = _range_enter(self.name)
        counts = self.counts
        self.saved = None
        if 'step' in counts or 'request' in counts:
            self.saved = dict(_current)
            for key in ('step', 'request'):
                if key in counts:
                    _current[key] = counts.pop(key)
        stack = getattr(_local, 'stack', None)
        if stack is None:
            stack = _local.stack = []
        entry = {'id': next(_ids), 'name': self.name,
                 'thread': threading.get_native_id(),
                 'parent': stack[-1]['id'] if stack else None,
                 'step': _current['step'], 'request': _current['request'],
                 'counts': counts, 'start': start, 'end': None}
        stack.append(entry)
        with _log_lock:
            _log.append(entry)
        return self

    def __exit__(self, *exc):
        if self.saved is not None:
            _current.update(self.saved)
        entry = _local.stack.pop()
        _range_exit(self.range)
        entry['end'] = time.time_ns()
        return False


def annotate(name: str, **counts):
    """A span named ``name`` around a phase of the host's work.

    While no profiler runs on the calling thread this returns one shared
    null context: it opens no range, logs nothing and never synchronises.
    While one runs, the span is a ``record_function`` range of that name
    (the profiler stamps it on the clock of the card's kernels and
    copies) and an entry of the span log: its ``name``, ``thread``
    (the native thread id, the trace's ``tid``), ``parent`` (the ``id`` of
    the span open around it on its thread, or None), the current ``step``
    and ``request``, the ``counts`` given, and ``start`` and ``end``, the
    host's wall clock (``time.time_ns``) just outside the range: the clock
    the profiler converts its host events to, so that an entry holds its
    range once shifted by the trace's one offset. The counts ``step`` and
    ``request`` are identifiers: the span sets them for every span opened
    inside it, on any thread, until it closes.

    A span is opened and closed while the same profiler runs: never across
    a point where one may start or stop."""
    if not _profiling():
        return _OFF
    return _Span(name, counts)


def spanned(name: str):
    """Decorator: each call of the function inside :func:`annotate`'s span
    ``name``."""
    def decorate(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return call
    return decorate


_END = object()


def iterate(name: str, iterable):
    """The items of ``iterable``, each ``next`` inside :func:`annotate`'s
    span ``name`` (the span closes before the item is handed on)."""
    it = iter(iterable)
    while True:
        with annotate(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item


def take_spans() -> list:
    """The span log (each entry a dict, as :func:`annotate` says, in the
    order the spans opened), which this empties."""
    global _log
    with _log_lock:
        spans, _log = _log, []
    return spans


class StepTimer:
    """Rolling throughput statistics over training steps."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times = deque(maxlen=window)
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    @property
    def mean_step_time(self):
        return float(np.mean(self.times)) if self.times else float('nan')

    @property
    def p50(self):
        return float(np.median(self.times)) if self.times else float('nan')

    @property
    def p99(self):
        return float(np.percentile(self.times, 99)) if self.times \
            else float('nan')

    def throughput(self, batch_size: int):
        st = self.mean_step_time
        return batch_size / st if st and st > 0 else float('nan')

    def summary(self, batch_size: int = None):
        s = {'mean_step_s': self.mean_step_time, 'p50_s': self.p50,
             'p99_s': self.p99}
        if batch_size:
            s['examples_per_sec'] = self.throughput(batch_size)
        return s
