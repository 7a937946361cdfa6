"""Each metric reader against a small synthetic profiler trace (Chrome
trace events as ``torch.profiler`` writes them)."""

import pytest

import tiny
from perfbench.counts import bounds, flops
from perfbench.harness import readers, spans, spec as spec_lib
from perfbench.harness.outcome import ReadContext
from perfbench.harness.trace import Trace, short_name
from perfbench.nets import cin_nets


def x(cat, name, ts, dur, corr=None, tid=1):
    event = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
             'tid': tid}
    if corr is not None:
        event['args'] = {'correlation': corr}
    return event


def events():
    """A 1000 µs stretch: a step span with two overlapping kernels, an
    optimizer span whose launch runs later on the card, a CIN forward and
    backward, and idle time under an ``aten::item``."""
    return [
        x('user_annotation', spans.STRETCH, 0, 1000),
        x('user_annotation', spans.TRAIN_STEP, 10, 700),
        x('user_annotation', spans.OPTIMIZER_STEP, 500, 150),
        x('cpu_op', 'aten::mm', 20, 30),
        x('cpu_op', 'aten::item', 750, 200),
        x('cpu_op', 'aten::add', 760, 10),  # inside aten::item: not outermost
        x('cuda_runtime', 'cudaLaunchKernel', 25, 5, corr=1),
        x('cuda_runtime', 'cudaLaunchKernel', 30, 5, corr=2),
        x('cuda_runtime', 'cudaLaunchKernel', 510, 5, corr=3),
        x('cuda_runtime', 'cudaLaunchKernel', 520, 5, corr=4),
        x('cuda_driver', 'cuLaunchKernelEx', 40, 5, corr=5),
        x('kernel', 'void cin_fwd_wgmma_kernel<float>(CUtensorMap_st, int)',
          100, 200, corr=1),
        x('kernel', 'void cin_bwd_dx_wgmma_kernel<float>(int)', 250, 150,
          corr=2),
        x('kernel', 'void cin_bwd_dw_wgmma_kernel<float>(int)', 400, 50,
          corr=5),
        x('kernel', 'void at::native::foreach_adam<float>(int)', 600, 150,
          corr=3),
        x('gpu_memset', 'Memset (Device)', 750, 50, corr=4),
        x('gpu_user_annotation', spans.OPTIMIZER_STEP, 600, 200),
        x('kernel', 'outside', 1200, 10, corr=6),
    ]


def context(record, traffic='train', trace=True):
    cfg = tiny.config('xdeepfm_criteo_synth')
    tr = Trace.from_events(events()) if trace else None
    return ReadContext(cfg, tiny.traffic(traffic), tr, record)


def test_trace_reduction():
    trace = Trace.from_events(events())
    assert trace.window_us == 1000
    # kernels over [100, 450] and [600, 800]; the annotation on the card
    # and the kernel past the stretch are not counted
    assert trace.busy_us() == 350 + 200
    assert trace.idle_gaps() == [(0, 100), (450, 600), (800, 1000)]
    assert [e[0][:18] for e in trace.launched_in(spans.OPTIMIZER_STEP)] == \
        ['void at::native::f', 'Memset (Device)']
    assert [o[0] for o in trace.host_ops] == ['aten::mm', 'aten::item']
    assert trace.host_activity(800) == 'aten::item'
    assert trace.host_activity(510) == 'perfbench.optimizer_step'
    assert trace.host_activity(5) == 'host'
    breakdown = trace.breakdown()
    assert breakdown['device_ops'][0] == ['cin_fwd_wgmma_kernel<float>',
                                          pytest.approx(200e-6)]
    # each idle stretch by what the host did meanwhile
    assert dict(map(tuple, breakdown['idle_gaps'])) == pytest.approx(
        {'aten::item': 150e-6, 'perfbench.train_step': 110e-6,
         'perfbench.optimizer_step': 100e-6, 'host': 60e-6,
         'perfbench.train_step / aten::mm': 30e-6})


def test_short_name():
    assert short_name('void f<a<b>, (c)>(int, float)') == 'f<a<b>, (c)>'


def test_idle_readers():
    for name in ('device_idle_pct.train', 'device_idle_pct.serve'):
        read = spec_lib.metric(name).read
        assert read(context({})) == pytest.approx(45.0)
        assert read(context({}, trace=False)) is None


def test_train_mfu_reader():
    ctx = context({'train_steps': 2, 'batch_size': 64})
    ops = 2 * flops.train_step_ops(ctx.config, 64)
    assert spec_lib.metric('train_mfu').read(ctx) == pytest.approx(
        100 * ops / 1e-3 / 495e12)


def test_serve_mfu_reader():
    ctx = context({'requested_rows': 500}, 'serve')
    ops = flops.forward_ops(ctx.config, 500)
    assert spec_lib.metric('serve_mfu').read(ctx) == pytest.approx(
        100 * ops / 1e-3 / 495e12)
    assert spec_lib.metric('serve_mfu').read(context({}, 'serve')) is None


def test_optimizer_roofline_reader():
    ctx = context({})
    least = bounds.adam_bound(readers.n_params(ctx.config))
    # one optimizer span; its kernels ran 150 + 50 µs on the card
    assert spec_lib.metric('optimizer_roofline_pct').read(ctx) == \
        pytest.approx(100 * least / 200e-6)


def test_cin_roofline_readers(capsys):
    shape = (64, 5, 5, 8, 4)
    record = {'kernel_calls': {'cin_fwd': [shape], 'cin_bwd': [shape]},
              'launches': {'cin_fwd': 1, 'cin_bwd': 1}}
    fwd = cin_nets.cin_bound('cin_fwd', *shape, 4)[0]
    bwd = cin_nets.cin_bound('cin_bwd', *shape, 4)[0]
    read = spec_lib.metric('cin_roofline_pct.train').read
    assert read(context(record)) == pytest.approx(
        100 * (fwd + bwd) / 400e-6)
    read = spec_lib.metric('cin_roofline_pct.serve').read
    assert read(context(record, 'serve')) == pytest.approx(
        100 * fwd / 200e-6)
    assert capsys.readouterr().err == ''
    # two K4 calls counted, one seen: the bound of the one seen
    record['kernel_calls']['cin_fwd'] = [shape, shape]
    record['launches']['cin_fwd'] = 2
    assert read(context(record, 'serve')) == pytest.approx(
        100 * fwd / 200e-6)
    assert 'the profiler saw 1 launches' in capsys.readouterr().err
    assert read(context({}, 'serve')) is None
