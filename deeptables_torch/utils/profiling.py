# -*- coding:utf-8 -*-
"""Profiling and tracing hooks: the port's copy of
``deeptables_tpu/utils/profiling.py`` on ``torch.profiler``.

- :func:`trace`: a context manager around ``torch.profiler.profile`` (host
  and CUDA activity) that writes a Chrome trace (``trace.json``) or, with
  ``tensorboard=True``, a TensorBoard profile into ``logdir``;
- :func:`annotate`: a named range for a host-side phase inside a trace
  (``torch.profiler.record_function``);
- :class:`StepTimer`: rolling step-time and throughput statistics for
  training loops (host clock; a caller timing device work synchronises
  before each ``tick``).
"""

import contextlib
import os
import time
from collections import deque

import numpy as np

from . import dt_logging

logger = dt_logging.get_logger(__name__)


@contextlib.contextmanager
def trace(logdir: str, with_memory: bool = True, tensorboard: bool = False):
    """Capture a host and device trace viewable in Perfetto or
    ``chrome://tracing`` (or TensorBoard); yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    on_ready = torch.profiler.tensorboard_trace_handler(logdir) \
        if tensorboard else None
    with profile(activities=activities, profile_memory=with_memory,
                 on_trace_ready=on_ready) as prof:
        yield prof
    if not tensorboard:
        prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))
    logger.info(f'profiler trace written to {logdir}')


def annotate(name: str):
    """Named annotation context for host-side phases inside a trace."""
    import torch
    return torch.profiler.record_function(name)


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
