"""A profiled stretch of a run, reduced to what the metric readers need.

:class:`Profiler` runs ``torch.profiler`` (host and CUDA activity) over a
stretch that the harness marks with a ``perfbench.stretch`` range, writes
the trace in the Chrome trace format to a temporary file, reads it back and
deletes it. :meth:`Trace.from_events` keeps, in microseconds on the
profiler's clock:

- ``start``/``end``: the marked stretch;
- ``device``: every kernel, copy and fill on the card, ``(name, start, end,
  correlation)``;
- ``launches``: the host time of each launch, by correlation id (the CUDA
  runtime's or driver's call that the card's event names);
- ``spans``: the harness's ``perfbench.*`` ranges, ``(name, start, end)``;
- ``host_ops``: the outermost operators on the stretch's host thread,
  ``(name, start, end)``, in order.
"""

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .spans import STRETCH

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATEGORIES = ('cuda_runtime', 'cuda_driver')


@dataclass
class Trace:
    start: float
    end: float
    device: List[Tuple[str, float, float, int]] = field(default_factory=list)
    launches: Dict[int, float] = field(default_factory=dict)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    host_ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @classmethod
    def from_events(cls, events) -> 'Trace':
        """From the ``traceEvents`` of a Chrome trace."""
        complete = [e for e in events if e.get('ph') == 'X']
        marks = [e for e in complete if e.get('name') == STRETCH
                 and e.get('cat') == 'user_annotation']
        if len(marks) != 1:
            raise ValueError(f'the trace holds {len(marks)} {STRETCH} '
                             'ranges, not one')
        mark = marks[0]
        start = float(mark['ts'])
        trace = cls(start=start, end=start + float(mark['dur']))
        for e in complete:
            cat = e.get('cat')
            ts, end = float(e['ts']), float(e['ts']) + float(e['dur'])
            corr = (e.get('args') or {}).get('correlation')
            if cat in DEVICE_CATEGORIES:
                trace.device.append((e['name'], ts, end,
                                     -1 if corr is None else int(corr)))
            elif cat in LAUNCH_CATEGORIES and corr is not None:
                trace.launches[int(corr)] = ts
            elif cat == 'user_annotation' and e['name'].startswith(
                    'perfbench.') and e['name'] != STRETCH:
                trace.spans.append((e['name'], ts, end))
            elif cat == 'cpu_op' and e.get('tid') == mark.get('tid'):
                trace.host_ops.append((e['name'], ts, end))
        trace.device.sort(key=lambda d: d[1])
        trace.host_ops = _outermost(trace.host_ops)
        return trace

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_us(self) -> float:
        """Time within the stretch in which the card ran a kernel, a copy
        or a fill (the union of their intervals)."""
        busy, reach = 0.0, self.start
        for _, a, b, _ in self.device:
            a, b = max(a, reach), min(b, self.end)
            if b > a:
                busy += b - a
                reach = b
        return busy

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The stretch's intervals in which nothing ran on the card."""
        gaps, reach = [], self.start
        for _, a, b, _ in self.device:
            if a > reach and reach < self.end:
                gaps.append((reach, min(a, self.end)))
            reach = max(reach, b)
        if reach < self.end:
            gaps.append((reach, self.end))
        return gaps

    def host_activity(self, t: float) -> str:
        """What the host thread was in at time ``t``: the innermost harness
        span and the outermost operator, else ``'host'``."""
        span = min((s for s in self.spans if s[1] <= t < s[2]),
                   key=lambda s: s[2] - s[1], default=None)
        i = bisect.bisect_right(self._op_starts(), t) - 1
        op = self.host_ops[i] if i >= 0 and t < self.host_ops[i][2] else None
        parts = [p[0] for p in (span, op) if p is not None]
        return ' / '.join(parts) if parts else 'host'

    def _op_starts(self):
        if getattr(self, '_starts', None) is None:
            self._starts = [o[1] for o in self.host_ops]
        return self._starts

    def _pieces(self, a: float, b: float):
        """``[a, b)`` cut where a host operator or a harness span starts or
        ends, so that the host does one thing in each piece."""
        cuts = {a, b}
        starts = self._op_starts()
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(self.host_ops) and self.host_ops[i][1] < b:
            cuts.update(t for t in self.host_ops[i][1:] if a < t < b)
            i += 1
        for _, s, e in self.spans:
            cuts.update(t for t in (s, e) if a < t < b)
        cuts = sorted(cuts)
        return list(zip(cuts, cuts[1:]))

    def launched_in(self, span_name: str):
        """The card's events whose launch lies in a span of that name."""
        spans = [(a, b) for name, a, b in self.spans if name == span_name]
        out = []
        for event in self.device:
            t = self.launches.get(event[3])
            if t is not None and any(a <= t < b for a, b in spans):
                out.append(event)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing meanwhile (the innermost harness span and
        the outermost operator), each ``[[name, seconds], ...]``."""
        ops = {}
        for name, a, b, _ in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b > a:
                key = short_name(name)
                ops[key] = ops.get(key, 0.0) + (b - a) / 1e6
        gaps = {}
        for a, b in self.idle_gaps():
            for p, q in self._pieces(a, b):
                key = self.host_activity((p + q) / 2)
                gaps[key] = gaps.get(key, 0.0) + (q - p) / 1e6
        by_time = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {'device_ops': [[k, v] for k, v in by_time(ops)],
                'idle_gaps': [[k, v] for k, v in by_time(gaps)]}


def _outermost(ops):
    ops = sorted(ops, key=lambda o: (o[1], -o[2]))
    out, reach = [], float('-inf')
    for op in ops:
        if op[1] >= reach:
            out.append(op)
            reach = op[2]
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void ``, anonymous namespaces and its
    parameter list."""
    name = name.replace('(anonymous namespace)::', '')
    if name.startswith('void '):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == '<':
            depth += 1
        elif ch == '>':
            depth -= 1
        elif ch == '(' and depth == 0:
            name = name[:i]
            break
    return name[:width]


class Profiler:
    """``start()`` begins the profiler and the stretch's range;
    ``stop()`` ends both (after the card has finished) and returns the
    :class:`Trace`."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._prof = None
        self._range = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=activities)
        self._prof.start()
        self._range = record_function(STRETCH)
        self._range.__enter__()

    def stop(self) -> Trace:
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(prefix='perfbench-', suffix='.json')
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        finally:
            os.unlink(path)
        self._prof = None
        return Trace.from_events(events)
