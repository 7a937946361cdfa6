"""Run one cell of the benchmark and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the port
(``deeptables_torch``). The cell's driver (``perfbench/drivers``) makes
its inputs and weights from the seed, warms up, measures for ``--seconds``
and checks what the timed path produced against the plain reference. With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` a stretch of the window is profiled and it carries the
cell's per-layer metrics, ``busy_s``/``window_s`` and a ``breakdown``.

A checkout's first run builds the port's CUDA kernels (``nvcc``, into
``build/deeptables_torch/<hash>``) before its set-up; ``setup_s`` holds
that build, and the result says so apart: ``kernels_built`` (whether this
run built any) and ``kernels_build_s`` (the seconds it took, which a run
that finds them built spends loading them).

The numbers compared are printed, each beside its limit, as the last lines
of standard error and under ``checks``, the last key of the result. The
run fails (no result, a non-zero exit) without a CUDA card, with fewer
cards than the cell asks for, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# every build and kernel cache inside the checkout, at fixed paths (the
# port builds its CUDA libraries under build/deeptables_torch/<hash>)
for _var, _sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton'),
                   ('CUDA_CACHE_PATH', 'nv_compute_cache')):
    os.environ[_var] = str(ROOT / 'build' / 'perfbench' / _sub)


def fail(message: str, code: int = 2) -> int:
    print(f'perfbench: {message}', file=sys.stderr)
    return code


def build_kernels():
    """Build the port's CUDA libraries, as its first kernel call would:
    ``(seconds, whether any was missing)``."""
    from deeptables_torch.ops.kernels import _build
    out_dir = _build.build_dir()
    missing = [src for src in _build.sources()
               if not (out_dir / f'lib{src.stem}.so').is_file()]
    t = time.time()
    _build.build_all()
    return time.time() - t, bool(missing)


def result_line(cell, outcome, trace: bool, device_info: dict,
                build=None) -> dict:
    from perfbench.harness import compare
    from perfbench.harness.outcome import ReadContext
    from perfbench.harness import spec as spec_lib
    metrics = {}
    if trace:
        ctx = ReadContext(cell.config, cell.traffic, outcome.trace,
                          outcome.record)
        for entry in cell.per_layer:
            value = spec_lib.metric(entry['name']).read(ctx)
            if value is not None:
                metrics[entry['name']] = {'value': value,
                                          'unit': entry['unit']}
        if outcome.trace is not None:
            device_info['busy_s'] = outcome.trace.busy_us() / 1e6
            device_info['window_s'] = outcome.trace.window_us / 1e6
    else:
        for entry in cell.end_to_end:
            if entry['name'] not in outcome.metrics:
                raise KeyError(f'the driver gave no {entry["name"]}')
            metrics[entry['name']] = {'value': outcome.metrics[entry['name']],
                                      'unit': entry['unit']}
    line = {'correct': compare.all_within(outcome.checks) and
            outcome.failed == 0,
            'attempted': outcome.attempted, 'failed': outcome.failed,
            'metrics': metrics, 'device': device_info}
    if trace and outcome.trace is not None:
        line['breakdown'] = outcome.trace.breakdown()
    if build is not None:
        line['kernels_build_s'], line['kernels_built'] = build
    line['checks'] = outcome.checks
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch
    from perfbench.harness import isolation, spec as spec_lib

    if not torch.cuda.is_available():
        return fail('no CUDA device: the benchmark measures the card')
    try:
        cell = spec_lib.cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        return fail(f'cannot load the cell: {e}')
    if torch.cuda.device_count() < cell.chips:
        return fail(f'{args.workload} needs {cell.chips} cards, '
                    f'{torch.cuda.device_count()} present')
    # the configurations' float32 has TF32 off (``spec.ONLY``)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = spec_lib.driver(cell.traffic['driver'])
    build = build_kernels()
    outcome = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                         'cuda', T0)
    device_info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                   'count': cell.chips,
                   'memory_peak_bytes': outcome.memory_peak_bytes}
    line = result_line(cell, outcome, bool(args.trace), device_info, build)

    found = isolation.forbidden_modules()
    if found:
        return fail(f'the run loaded {", ".join(found)}', 3)
    print(f'kernels {"built" if build[1] else "found built"}: '
          f'{build[0]:.3f} s of setup_s', file=sys.stderr)
    print('setup ' + ', '.join(f'{k} {v:.3f} s' for k, v in
                               outcome.phases.items()), file=sys.stderr)
    for name, values in outcome.notes.items():
        print(f'window {name}: {len(values)}, min {min(values):.6f} median '
              f'{sorted(values)[len(values) // 2]:.6f} max {max(values):.6f}',
              file=sys.stderr)
        if len(values) <= 200:
            print(f'window {name} ' + ' '.join(f'{v:.4f}' for v in values),
                  file=sys.stderr)
    for name, check in line['checks'].items():
        value = check['value']
        shown = repr(value) if math.isfinite(value) else 'inf'
        where = outcome.where.get(name)
        print(f'check {name} {shown} limit {check["limit"]!r}'
              + (f' (worst leaf {where})' if where else ''), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line), allow_nan=False), flush=True)
    return 0


def _finite(value):
    """``value`` with every infinite or NaN float written as a string
    (strict JSON has no such numbers)."""
    if isinstance(value, dict):
        return {k: _finite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_finite(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


if __name__ == '__main__':
    sys.exit(main())
