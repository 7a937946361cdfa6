"""Readings of the program's own spans (``deeptables_torch.utils.profiling``:
``deeptables.*`` ranges, and the span log with its counts), shared by the
``idle_*`` readers and ``serve_pad_share``. Each returns None where the
traced stretch holds nothing to read: a program without such spans gives
none.

The spans are read from the program's log (``take_spans()``), whose
entries carry their thread, nesting and host wall-clock times
(``time.time_ns``). The profiler converts its host events to the same
clock and stores them less one base of its own, so the log lies on the
trace's clock shifted by one offset. :func:`clock_offset` bounds that
offset with the harness's spans (``harness/spans.py``), each of which
holds one program span or lies inside one (:data:`PAIRS`), and takes the
middle of the bounds."""

import json
import math
import sys

from .spans import FORWARD, OPTIMIZER_STEP, TRAIN_STEP
from .spans import REQUEST as HARNESS_REQUEST

PROGRAM = 'deeptables.'
STEP = PROGRAM + 'step'
REQUEST = PROGRAM + 'serve.request'
SERVE_FORWARD = PROGRAM + 'serve.forward'
EPOCH_LOOP = tuple(PROGRAM + 'fit.' + part
                   for part in ('batch', 'train_metrics', 'validation'))
# the spans with parts of their own: idle time under one of these alone
# lies between its parts
INNER = (STEP, PROGRAM + 'step.forward', REQUEST, SERVE_FORWARD) + EPOCH_LOOP
# the key of idle time under no program span
NO_PROGRAM_SPAN = 'no program span'
# (harness span, program span, whether the harness's span holds the
# program's): each call of the one is one call of the other
PAIRS = ((TRAIN_STEP, STEP, True),
         (OPTIMIZER_STEP, PROGRAM + 'step.optimizer', False),
         (HARNESS_REQUEST, REQUEST, True),
         (FORWARD, SERVE_FORWARD, False))
# how far the pairs' bounds on the offset may cross (µs) before the log
# and the trace count as being on different clocks
CLOCK_TOLERANCE_US = 50.0


def log_us(log):
    """An entry's time (ns) → µs after the log's first start, exact for
    the integers of ``time.time_ns``."""
    first = min(e['start'] for e in log)
    return lambda ns: (ns - first) / 1e3


def clock_bounds(trace, log):
    """``(lo, hi, thread)``: the least and the most microseconds that may
    place the log's times on the trace's clock (trace time = :func:`log_us`
    of the log time + offset), as the pairs of :data:`PAIRS` in both
    bound them, and the thread of the step's or request's spans; None
    where no pair is in both."""
    lo, hi, thread, us = -math.inf, math.inf, None, log_us(log)
    for harness, program, outer in PAIRS:
        held = sorted((a, b) for name, a, b in trace.spans if name == harness)
        entries = sorted((e for e in log if e['name'] == program
                          and e.get('end') is not None),
                         key=lambda e: e['start'])
        if not held or len(held) != len(entries):
            continue
        for (h0, h1), e in zip(held, entries):
            p0, p1 = us(e['start']), us(e['end'])
            if outer:
                lo, hi = max(lo, h0 - p0), min(hi, h1 - p1)
            else:
                lo, hi = max(lo, h1 - p1), min(hi, h0 - p0)
        if thread is None:
            thread = entries[0]['thread']
    return None if thread is None else (lo, hi, thread)


def clock_offset(trace, log):
    """``(offset, thread)``: the middle of :func:`clock_bounds`; None where
    there are none, or where they cross by more than
    :data:`CLOCK_TOLERANCE_US`."""
    bounds = clock_bounds(trace, log)
    if bounds is None:
        return None
    lo, hi, thread = bounds
    if lo > hi + CLOCK_TOLERANCE_US:
        print(f'note: the program\'s span log and the trace disagree on '
              f'the clock by {lo - hi:.1f} us', file=sys.stderr)
        return None
    return (lo + hi) / 2, thread


def segments(spans):
    """One thread's time cut where a span starts or ends, from its spans
    ``[(name, start, end)]``: ``[(start, end, path)]`` in order, ``path``
    the names of the spans open there, outermost first (a span is cut to
    the one around it); time under no span is left out."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out, stack, t = [], [], None

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][1] <= limit:
            path = tuple(name for name, _ in stack)
            end = stack.pop()[1]
            if end > t:
                out.append((t, end, path))
            t = end

    for name, a, b in spans:
        close_until(a)
        if stack and a > t:
            out.append((t, a, tuple(n for n, _ in stack)))
        t = a
        stack.append((name, min(b, stack[-1][1]) if stack else b))
    close_until(math.inf)
    return out


def idle_pieces(gaps, spans):
    """The idle intervals ``gaps`` cut by the spans open meanwhile:
    ``[(start, end, path)]``, ``path`` as :func:`segments` gives it, ``()``
    under no span."""
    cut = segments(spans)
    out, i = [], 0
    for a, b in gaps:
        t = a
        while i < len(cut) and cut[i][1] <= a:
            i += 1
        j = i
        while j < len(cut) and cut[j][0] < b:
            p, q, path = cut[j]
            p, q = max(p, a), min(q, b)
            if p > t:
                out.append((t, p, ()))
            if q > p:
                out.append((p, q, path))
                t = q
            j += 1
        if b > t:
            out.append((t, b, ()))
    return out


def program_spans(trace, log):
    """The log's spans on the step's or request's thread, on the trace's
    clock: ``[(name, start, end)]``; None where the log cannot be placed."""
    placed = clock_offset(trace, log)
    if placed is None:
        return None
    (offset, thread), us = placed, log_us(log)
    return [(e['name'], us(e['start']) + offset, us(e['end']) + offset)
            for e in log if e['thread'] == thread and e.get('end') is not None]


def by_span(pieces, top=10):
    """The idle time by the innermost program span (seconds), most first:
    ``[[name, seconds], ...]``."""
    spans = {}
    for a, b, path in pieces:
        key = path[-1] if path else NO_PROGRAM_SPAN
        spans[key] = spans.get(key, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in
            sorted(spans.items(), key=lambda kv: -kv[1])[:top]]


def placed_pct(trace, pieces, harness=(TRAIN_STEP, FORWARD)):
    """Of the idle time inside the harness's spans ``harness``, the share
    (%) under a program span that has no parts of its own (not in
    :data:`INNER`); None where there is no such idle time."""
    held = [(a, b) for name, a, b in trace.spans if name in harness]
    inside = placed = 0.0
    for p, q, path in pieces:
        for a, b in held:
            us = min(q, b) - max(p, a)
            if us > 0:
                inside += us
                if path and path[-1] not in INNER:
                    placed += us
    return 100.0 * placed / inside if inside > 0 else None


def idle_paths(ctx):
    """The stretch's idle time by the program spans open on the step's or
    request's thread: ``[(start, end, path)]``, worked out once and kept
    in the record (its breakdown is written to standard error); None where
    there is nothing to read."""
    if 'program_idle_pieces' in ctx.record:
        return ctx.record['program_idle_pieces']
    trace, pieces = ctx.trace, None
    log = span_log(ctx)
    if trace is not None and trace.window_us > 0 and trace.device and log:
        spans = program_spans(trace, log)
        if spans:
            pieces = idle_pieces(trace.idle_gaps(), spans)
            lo, hi, _ = clock_bounds(trace, log)
            print('idle_by_program_span ' + json.dumps(
                {'spans': by_span(pieces),
                 'placed_pct': placed_pct(trace, pieces),
                 'clock_bounds_us': hi - lo}), file=sys.stderr)
    ctx.record['program_idle_pieces'] = pieces
    return pieces


def idle_pct_under(ctx, under):
    """Share of the stretch (%) in which nothing ran on the card while the
    spans open on the step's or request's thread, outermost first (a
    tuple of names), satisfied ``under``."""
    pieces = idle_paths(ctx)
    if pieces is None:
        return None
    idle = sum(b - a for a, b, path in pieces if path and under(path))
    return 100.0 * idle / ctx.trace.window_us


def in_step(part):
    """``under`` for the time inside a step's span ``part``."""
    return lambda path: STEP in path and PROGRAM + part in path


def in_input(path):
    """Inside a step, in one of its ``input.*`` spans."""
    return STEP in path and path[-1].startswith(PROGRAM + 'input.')


def in_epoch_loop(path):
    return any(name in EPOCH_LOOP for name in path)


def in_request(path):
    """Inside a request, outside its forward."""
    return REQUEST in path and SERVE_FORWARD not in path


def in_serve_forward(path):
    return SERVE_FORWARD in path


def span_log(ctx):
    """The program's span log of the traced stretch (``take_spans()``: the
    spans opened while the profiler ran), read once and kept in the
    record; None where the program keeps no log."""
    if 'program_span_log' not in ctx.record:
        try:
            from deeptables_torch.utils.profiling import take_spans
        except ImportError:
            take_spans = None
        ctx.record['program_span_log'] = None if take_spans is None \
            else take_spans()
    return ctx.record['program_span_log']


def pad_share(ctx):
    """The padded rows of the stretch's requests over the rows their
    forwards ran (%), from the ``serve.request`` entries' counts."""
    log = span_log(ctx) or []
    rows = padded = 0
    for entry in log:
        if entry.get('name') == REQUEST:
            rows += entry['counts']['rows']
            padded += entry['counts']['padded_rows']
    if rows + padded == 0:
        return None
    return 100.0 * padded / (rows + padded)
