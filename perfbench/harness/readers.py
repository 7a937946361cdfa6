"""Readings shared by the metric readers of ``perfbench/metrics``: each
returns None where the traced stretch holds nothing to read."""

import sys

from .. import nets as nets_lib
from ..counts import bounds, flops, peaks
from ..reference.model import param_specs
from .spans import OPTIMIZER_STEP


def idle_pct(ctx):
    """Share of the stretch in which nothing ran on the card."""
    trace = ctx.trace
    if trace is None or trace.window_us <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)


def mfu(ctx, ops):
    """``ops`` over the stretch's time, against the tensor cores' peak on
    the configuration's input type."""
    trace = ctx.trace
    if trace is None or trace.window_us <= 0 or not ops:
        return None
    rate = ops / (trace.window_us / 1e6)
    return 100.0 * rate / peaks.tensor_core_peak(ctx.config['dtype_policy'])


def train_mfu(ctx):
    steps = ctx.record.get('train_steps', 0)
    return mfu(ctx, steps and steps * flops.train_step_ops(
        ctx.config, ctx.record['batch_size']))


def serve_mfu(ctx):
    return mfu(ctx, flops.forward_ops(ctx.config,
                                      ctx.record.get('requested_rows', 0)))


def n_params(config) -> int:
    total = 0
    for _, shape, _ in param_specs(config):
        count = 1
        for s in shape:
            count *= s
        total += count
    return total


def optimizer_roofline_pct(ctx):
    """Least time of the Adam updates in the stretch over the device time
    of the kernels launched inside the harness's optimizer spans."""
    trace = ctx.trace
    if trace is None:
        return None
    steps = sum(1 for s in trace.spans if s[0] == OPTIMIZER_STEP)
    busy = sum(b - a for _, a, b, _ in trace.launched_in(OPTIMIZER_STEP))
    if steps == 0 or busy <= 0:
        return None
    least = steps * bounds.adam_bound(n_params(ctx.config))
    return 100.0 * least / (busy / 1e6)


def kernel_roofline_pct(ctx, kernels):
    """Least time of the calls of ``kernels`` (hand-written kernels of the
    configuration's nets) in the stretch over the device time of the device
    kernels that do their work. The calls' shapes come from the harness's
    records (``record['kernel_calls']``), each kernel's bound and device
    kernels from its net's module (``bounds``); a call the profiler lost is
    left out of both sides, by the share of launches it saw of those the
    program's counters count."""
    trace = ctx.trace
    calls = ctx.record.get('kernel_calls') or {}
    if trace is None or not any(calls.get(k) for k in kernels):
        return None
    specs = nets_lib.bounds(ctx.config)
    itemsize = peaks.itemsize(ctx.config['dtype_policy'])
    events = [e for e in trace.device
              if any(specs[k].runs(e[0]) for k in kernels)]
    busy = sum(b - a for _, a, b, _ in events) / 1e6
    if busy <= 0:
        return None
    least = 0.0
    for kernel in kernels:
        shapes = calls.get(kernel) or []
        if not shapes:
            continue
        spec = specs[kernel]
        total = sum(spec.least(*shape, itemsize)[0] for shape in shapes)
        seen = sum(1 for e in events if spec.once_a_call(e[0]))
        counted = ctx.record.get('launches', {}).get(kernel, len(shapes))
        if seen != len(shapes) or counted != len(shapes):
            print(f'note: {kernel}: the profiler saw {seen} launches, the '
                  f'counter counts {counted}, the harness expects '
                  f'{len(shapes)}', file=sys.stderr)
        least += total * min(seen, len(shapes)) / len(shapes)
    return 100.0 * least / busy
