#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``deeptables_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``deeptables_torch/csrc`` and runs
these phases, each printing one JSON line:

1. ``card``: the card's name and power limit (``nvidia-smi``), the versions,
   the kernel build time and what ``ptxas`` reports for each kernel.
2. ``kernel``: the FM forward kernel against its plain PyTorch version
   (``fm_reference``) on the card, in float32 and bfloat16, at every batch
   shape the serving path gives it (F=26, D=16) and a ragged B=4093, inputs
   rotated over more than twice the 50 MB L2. ``ms`` is the device time of
   one call (``torch.profiler``), ``call_ms`` the time between back-to-back
   calls (CUDA events), beside the bound (bytes over 3.35 TB/s).
3. ``serving``: a DeepFM ``DeepModel`` at full criteo width (26 categorical
   columns at D=16, 13 dense, DNN 1024/512 relu), random weights from
   ``config.seed``, served through ``Predictor`` with the default buckets,
   under ``dtype_policy='bfloat16'`` and then ``'float32'``. Requests of
   1, 37, 4096 and 10000 rows from ``load_criteo_synthetic``. It checks the
   probabilities (finite, ``(n, 2)``, rows sum to 1), that the FM kernel ran
   once per padded chunk, and that the same weights on ``device='cpu'`` (the
   plain path) give the same probabilities: float32 atol 1e-5, bfloat16
   atol 1e-2.
4. ``profile``: device time by kernel over three 4096-row requests
   (``torch.profiler``), and the device's busy share of that window.

Then one ``kernels`` line (every ported kernel, its launches on the serving
run, error and times), the ``nvidia-smi`` line again, and last
``{"ok": true, "device": {...}}``. Any failed check raises and exits
nonzero. Without a CUDA device, or outside a checkout, it prints no result
and exits nonzero.
"""

import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate, and the float32 rate outside the
# tensor cores (the FM kernel runs on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

F_CRITEO, D_CRITEO, N_DENSE = 26, 16, 13
KERNEL_BATCHES = (1, 8, 64, 512, 4096, 4093, 12288)
REQUESTS = (1, 37, 4096, 10000)
REPEATS = 5
HEADLINE = ('bfloat16', 4096)  # the kernels line: bench dtype, largest bucket
RTOL = {'float32': 1e-5, 'bfloat16': 1e-2}
SERVING_ATOL = {'float32': 1e-5, 'bfloat16': 1e-2}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, message):
    if not cond:
        raise AssertionError(message)


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def call_ms(torch, fn, inputs, iters):
    """Mean milliseconds between back-to-back calls of ``fn``, from CUDA
    events: the host's launch cost wherever that exceeds the device's."""
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(torch, prof):
    """The device-side events of a ``torch.profiler`` run, busiest first."""
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return sorted(events, key=lambda e: -e.self_device_time_total)


def device_ms(torch, fn, inputs, iters):
    """Mean device time of one call of ``fn`` in ms: the sum of the
    kernels it launches, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total
                   for e in device_kernels(torch, prof))
    check(total_us > 0, 'the profiler saw no device time')
    return total_us / 1e3 / iters


def fm_bound(B, F, D, itemsize):
    """Least time for FM pooling in ms, and what bounds it: read x once,
    write one value a row; 3 operations per element (add, multiply-add)
    and 3 per (row, d)."""
    bytes_ms = 1e3 * (B * F * D + B) * itemsize / HBM_BYTES_PER_S
    ops_ms = 1e3 * (3 * B * F * D + 3 * B * D) / FP32_OPS_PER_S
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')


def card_phase(torch, _build):
    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build_dir = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for log in sorted(build_dir.glob('lib*.log')):
        ptxas[log.stem[3:]] = sorted({line.split(':', 1)[1].strip()
                                      for line in log.read_text().splitlines()
                                      if 'registers' in line})
    emit({'phase': 'card', 'nvidia_smi': smi,
          'kind': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(),
          'python': sys.version.split()[0], 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'build_s': build_s,
          'sources': [p.name for p in _build.sources()], 'ptxas': ptxas,
          'tf32': {'matmul': torch.backends.cuda.matmul.allow_tf32,
                   'cudnn': torch.backends.cudnn.allow_tf32}})
    return smi


def kernel_phase(torch, fm_module):
    """FM kernel against fm_reference on the card; returns the rows."""
    fm, fm_reference = fm_module.fm, fm_module.fm_reference
    gen = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    for dtype_name in ('float32', 'bfloat16'):
        dtype = getattr(torch, dtype_name)
        itemsize = torch.empty((), dtype=dtype).element_size()
        for B in KERNEL_BATCHES:
            shape = (B, F_CRITEO, D_CRITEO)
            x = torch.randn(shape, generator=gen, device='cuda').to(dtype)
            out = fm(x)
            ref = fm_reference(x.float())
            torch.cuda.synchronize()
            check(out.shape == (B, 1) and out.dtype == dtype,
                  f'fm returned {tuple(out.shape)} {out.dtype}')
            rtol = RTOL[dtype_name]
            # FM is a difference of two sums of size Σ x²: the absolute
            # term of the tolerance scales with it
            scale = float(x.float().square().sum(dim=(1, 2)).max())
            err = (out.float() - ref).abs()
            ok = bool((err <= rtol * scale + rtol * ref.abs()).all())
            max_abs_err = float(err.max())
            check(ok, f'fm kernel disagrees with fm_reference: {dtype_name} '
                      f'B={B} max_abs_err={max_abs_err}')
            # rotate over enough distinct inputs to read them from HBM
            n_buf = max(1, min(64, math.ceil(2 * L2_BYTES / x.nbytes)))
            bufs = [x] + [torch.randn(shape, generator=gen, device='cuda')
                          .to(dtype) for _ in range(n_buf - 1)]
            iters = 200 if B <= 4096 else 100
            bound_ms, bound_by = fm_bound(B, F_CRITEO, D_CRITEO, itemsize)
            rows.append({
                'dtype': dtype_name, 'B': B, 'F': F_CRITEO, 'D': D_CRITEO,
                'max_abs_err': max_abs_err, 'rtol': rtol,
                'atol': rtol * scale,
                'ms': device_ms(torch, fm, bufs, iters),
                'plain_ms': device_ms(torch, fm_reference, bufs, iters),
                'call_ms': call_ms(torch, fm, bufs, iters),
                'plain_call_ms': call_ms(torch, fm_reference, bufs, iters),
                'bound_ms': bound_ms, 'bound_by': bound_by,
                'buffers': n_buf})
            del bufs, x
    emit({'phase': 'kernel', 'kernel': 'fm_fwd', 'library_ms': None,
          'library_note': 'no single PyTorch call computes FM pooling',
          'rows': rows})
    return rows


def criteo_model(port, dtype_policy, device, vocabs):
    config = port.ModelConfig(
        nets=['linear', 'fm_nets', 'dnn_nets'], metrics=['AUC'],
        task='binary', embedding_dropout=0,
        embeddings_output_dim=D_CRITEO,
        dnn_params={'hidden_units': ((1024, 0, False), (512, 0, False)),
                    'activation': 'relu'},
        dtype_policy=dtype_policy)
    cats = tuple(port.CategoricalColumn(f'C{i + 1}', int(v) + 1, D_CRITEO)
                 for i, v in enumerate(vocabs))
    conts = (port.ContinuousColumn(
        'input_continuous_all', [f'I{i + 1}' for i in range(N_DENSE)]),)
    return port.DeepModel('binary', 2, config, cats, conts, device=device)


def estimator(model):
    """What ``Predictor`` reads from a fitted estimator."""
    return types.SimpleNamespace(task=model.task, preprocessor=None,
                                 get_model=lambda selector: model)


def serving_phase(torch, port, fm_fn, dtype_policy, vocabs, requests):
    """Serve the requests on the card; the FM launch count is read around
    exactly this run."""
    t0 = time.perf_counter()
    model = criteo_model(port, dtype_policy, None, vocabs)
    predictor = port.Predictor(estimator(model))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(model.device.type == 'cuda', f'model is on {model.device}')

    fm_fn.launches = 0
    t0 = time.perf_counter()
    predictor.warmup()
    warmup_s = time.perf_counter() - t0
    check(fm_fn.launches == len(predictor.buckets),
          f'warmup launched the FM kernel {fm_fn.launches} times for '
          f'{len(predictor.buckets)} buckets')
    served, outputs = [], {}
    for n, arrays in requests:
        bucket = predictor._bucket_for(n)
        chunks = math.ceil(n / bucket)
        times = []
        for _ in range(REPEATS):
            before = fm_fn.launches
            t = time.perf_counter()
            proba = predictor.predict_proba_arrays(arrays)
            times.append(1e3 * (time.perf_counter() - t))
            check(fm_fn.launches - before == chunks,
                  f'n={n}: {fm_fn.launches - before} FM launches for '
                  f'{chunks} padded chunks')
        check(proba.shape == (n, 2), f'n={n}: proba shape {proba.shape}')
        check(bool(torch.isfinite(torch.from_numpy(proba)).all()),
              f'n={n}: non-finite probabilities')
        row_sum_err = float(abs(proba.sum(axis=1) - 1).max())
        check(row_sum_err <= 1e-6, f'n={n}: rows sum to 1 ± {row_sum_err}')
        outputs[n] = proba
        served.append({'n': n, 'bucket': bucket, 'chunks': chunks,
                       'ms': times, 'ms_median': sorted(times)[REPEATS // 2],
                       'row_sum_err': row_sum_err})
    launches = fm_fn.launches
    check(launches > 0, 'the serving run never launched the FM kernel')

    # the same weights on the CPU run the plain path
    cpu_model = criteo_model(port, dtype_policy, 'cpu', vocabs)
    cpu_model.build().load_state_dict(model.module.state_dict())
    cpu_predictor = port.Predictor(estimator(cpu_model))
    atol = SERVING_ATOL[dtype_policy]
    for row, (n, arrays) in zip(served, requests):
        diff = float(abs(cpu_predictor.predict_proba_arrays(arrays)
                         - outputs[n]).max())
        check(diff <= atol, f'{dtype_policy} n={n}: card and CPU plain path '
                            f'differ by {diff} > {atol}')
        row['max_abs_diff_vs_cpu'] = diff
    check(fm_fn.launches == launches, 'the CPU path launched the FM kernel')
    emit({'phase': 'serving', 'dtype_policy': dtype_policy,
          'build_s': build_s, 'warmup_s': warmup_s,
          'buckets': predictor.buckets, 'fm_launches': launches,
          'atol_vs_cpu': atol, 'requests': served})
    return predictor, launches


def profile_phase(torch, predictor, arrays, n):
    """Device time by kernel over three requests, and the busy share."""
    from torch.profiler import ProfilerActivity, profile
    predictor.predict_proba_arrays(arrays)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(3):
            predictor.predict_proba_arrays(arrays)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    device = device_kernels(torch, prof)
    busy_us = sum(e.self_device_time_total for e in device)
    check(busy_us > 0, 'the profiler saw no device time')
    emit({'phase': 'profile', 'dtype_policy': predictor.model.config.dtype_policy,
          'n': n, 'requests': 3, 'wall_ms': wall_us / 1e3,
          'device_busy_ms': busy_us / 1e3,
          'device_busy_share': busy_us / wall_us,
          'by_kernel': [{'name': e.key[:90], 'count': e.count,
                         'device_ms': e.self_device_time_total / 1e3}
                        for e in device[:12]]})


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available; this script runs '
              'the port on a GPU only.', file=sys.stderr)
        return 1
    if not (ROOT / 'deeptables_torch' / 'csrc').is_dir():
        print(f'chip_smoke: no deeptables_torch package beside {__file__}; '
              'run it from the root of a checkout.', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import deeptables_torch as port
    from deeptables_torch.data.datasets import load_criteo_synthetic
    from deeptables_torch.ops.kernels import _build
    from deeptables_torch.ops.kernels import fm as fm_module

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, 'TF32 is on')

    smi = card_phase(torch, _build)
    rows = kernel_phase(torch, fm_module)

    vocabs = load_criteo_synthetic(n_rows=1, return_arrays=True)[3]
    requests = []
    for i, n in enumerate(REQUESTS):
        cat, dense, _, _ = load_criteo_synthetic(n_rows=n, seed=100 + i,
                                                 return_arrays=True)
        requests.append((n, {'cat': cat, 'input_continuous_all': dense}))
    launches = 0
    for dtype_policy in ('bfloat16', 'float32'):
        predictor, count = serving_phase(torch, port, fm_module.fm,
                                         dtype_policy, vocabs, requests)
        launches += count
        if dtype_policy == HEADLINE[0]:
            profile_phase(torch, predictor, dict(requests)[4096], 4096)
        del predictor
        torch.cuda.empty_cache()

    head = next(r for r in rows if (r['dtype'], r['B']) == HEADLINE)
    emit({'kernels': [{
        'name': 'fm_fwd', 'route': 'cuda',
        'source': 'deeptables_torch/csrc/fm.cu',
        'replaces': 'deeptables_tpu/ops/kernels/fm.py:22',
        'launches': launches, 'max_abs_err': head['max_abs_err'],
        'ms': head['ms'], 'plain_ms': head['plain_ms'],
        'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
        'library_ms': None,
        'library_note': 'no single PyTorch call computes FM pooling',
        'at': {'dtype': HEADLINE[0], 'B': HEADLINE[1], 'F': F_CRITEO,
               'D': D_CRITEO}}]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
