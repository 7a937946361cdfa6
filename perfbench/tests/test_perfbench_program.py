"""The readers of ``harness/program.py`` (the program's span log placed on
the trace's clock, the idle time by program span, the ``idle_*`` shares
and ``serve_pad_share``) against synthetic profiler traces and logs; and,
on the card (``-m cuda``), that a kernel wrapper's span holds its launch
in the trace and, placed from the log, in the harness's trace."""

import json

import numpy as np
import pytest
import torch

import tiny
from perfbench.harness import program
from perfbench.harness import spans as spans_lib
from perfbench.harness import spec as spec_lib
from perfbench.harness import trace as trace_lib
from perfbench.harness.outcome import ReadContext
from perfbench.harness.program import NO_PROGRAM_SPAN
from perfbench.harness.trace import Trace
from test_perfbench_metrics import events, x

ROOT = spec_lib.ROOT
P = 'deeptables.'
TRAIN = ('idle_input_pct.train', 'idle_forward_pct.train',
         'idle_backward_pct.train', 'idle_epoch_loop_pct.train')
SERVE = ('idle_request_pct.serve', 'idle_forward_pct.serve')
# the host's wall clock (ns) at the trace's 0: the log's times are
# ``time.time_ns`` values, the trace's lie on the profiler's own base
WALL = 1_790_857_026_123_456_789


def log_of(spans, shift_us=0):
    """A span log of ``[(name, start, end[, thread])]`` (µs on the trace's
    clock; thread 1 unless given), its times on the wall clock, later
    than the trace's by ``shift_us``."""
    out = []
    for i, (name, a, b, *tid) in enumerate(spans):
        out.append({'id': i, 'name': P + name, 'thread': tid[0] if tid else 1,
                    'start': WALL + round((a + shift_us) * 1000),
                    'end': WALL + round((b + shift_us) * 1000),
                    'counts': {}})
    return out


# one step inside ``events()``'s ``perfbench.train_step`` [10, 710], its
# ``step.optimizer`` around the ``perfbench.optimizer_step`` [500, 650],
# each 10 µs from its harness span; the card idle over [0, 100], [450,
# 600] and [800, 1000]
TRAIN_SPANS = [('fit.batch', 0, 8), ('step', 20, 700),
               ('input.check_ids', 20, 60), ('input.copy', 60, 100),
               ('step.forward', 100, 430), ('model.net.cin_nets', 110, 400),
               ('step.backward', 430, 490), ('kernel.cin_bwd', 445, 470, 2),
               ('step.optimizer', 490, 660), ('step.loss_state', 660, 700),
               ('fit.train_metrics', 720, 780), ('fit.validation', 780, 990),
               ('input.check_ids', 790, 850)]


def program_events():
    """The ranges of ``TRAIN_SPANS`` as the profiler writes them: the
    harness's trace reads none of them."""
    return [x('user_annotation', P + name, a, b - a, tid=tid[0] if tid else 1)
            for name, a, b, *tid in TRAIN_SPANS]


def serve_events():
    """A 1000 µs serving stretch: two requests in the harness's spans, the
    card busy over [100, 300] and [500, 700]."""
    return [x('user_annotation', spans_lib.STRETCH, 0, 1000),
            x('user_annotation', spans_lib.REQUEST, 0, 480),
            x('user_annotation', spans_lib.FORWARD, 60, 330),
            x('user_annotation', spans_lib.REQUEST, 480, 520),
            x('user_annotation', spans_lib.FORWARD, 530, 360),
            x('kernel', 'cin_fwd_wgmma_kernel', 100, 200),
            x('kernel', 'cin_fwd_wgmma_kernel', 500, 200)]


SERVE_SPANS = [('serve.request', 2, 478), ('serve.pad', 2, 50),
               ('serve.forward', 50, 400), ('input.copy', 60, 90),
               ('serve.copy_back', 400, 470), ('serve.request', 482, 998),
               ('serve.pad', 482, 520), ('serve.forward', 520, 900),
               ('serve.copy_back', 900, 990)]


def context(evs, traffic='train', record=None, log=None):
    record = {} if record is None else record
    record.setdefault('program_span_log', log)
    return ReadContext(tiny.config('xdeepfm_criteo_synth'),
                       tiny.traffic(traffic), Trace.from_events(evs), record)


def read(name, ctx):
    return spec_lib.metric(name).read(ctx)


def test_program_ranges_change_no_existing_reading():
    plain = Trace.from_events(events())
    traced = Trace.from_events(events() + program_events())
    for field in ('start', 'end', 'device', 'launches', 'spans',
                  'host_ops'):
        assert getattr(traced, field) == getattr(plain, field)
    record = {'train_steps': 1, 'batch_size': 64,
              'kernel_calls': {'cin_fwd': [(64, 5, 5, 8, 4)],
                            'cin_bwd': [(64, 5, 5, 8, 4)]},
              'launches': {'cin_fwd': 1, 'cin_bwd': 1}}
    for entry in spec_lib.load_json(ROOT / 'BENCHMARK.json')['per_layer']:
        if entry['name'] in TRAIN + SERVE + ('serve_pad_share',):
            continue
        for traffic in ('train', 'serve'):
            assert read(entry['name'], context(
                events() + program_events(), traffic, dict(record),
                log_of(TRAIN_SPANS))) == \
                read(entry['name'], context(events(), traffic, dict(record)))
    assert traced.breakdown() == plain.breakdown()


@pytest.mark.parametrize('shift_us', [0, 37.5, -1234567.25])
def test_the_log_is_placed_on_the_trace_clock(shift_us):
    trace = Trace.from_events(events())
    log = log_of(TRAIN_SPANS, shift_us)
    offset, thread = program.clock_offset(trace, log)
    assert thread == 1
    placed = program.program_spans(trace, log)
    assert [name for name, _, _ in placed] == \
        [P + s[0] for s in TRAIN_SPANS if len(s) == 3]
    for (_, a, b), (_, a0, b0, *_) in zip(
            placed, [s for s in TRAIN_SPANS if len(s) == 3]):
        assert (a, b) == pytest.approx((a0, b0), abs=1e-6)


def test_the_log_is_not_placed_without_a_pair_or_with_a_wrong_clock(capsys):
    trace = Trace.from_events(events())
    # no step in the log: nothing pairs with the harness's spans
    assert program.clock_offset(trace, log_of(TRAIN_SPANS[:1])) is None
    # the step 200 µs longer than the harness's span around it
    wrong = [('step', -90, 810) if s[0] == 'step' else s
             for s in TRAIN_SPANS]
    assert program.clock_offset(trace, log_of(wrong)) is None
    assert 'disagree on the clock' in capsys.readouterr().err
    assert read('idle_input_pct.train', context(events(),
                                                log=log_of(wrong))) is None


def test_idle_by_program_span(capsys):
    trace = Trace.from_events(events())
    pieces = program.idle_pieces(
        trace.idle_gaps(), program.program_spans(trace, log_of(TRAIN_SPANS)))
    assert dict(map(tuple, program.by_span(pieces))) == pytest.approx(
        {P + 'fit.batch': 8e-6, NO_PROGRAM_SPAN: 22e-6,
         P + 'input.check_ids': 90e-6, P + 'input.copy': 40e-6,
         P + 'step.backward': 40e-6, P + 'step.optimizer': 110e-6,
         P + 'fit.validation': 140e-6})
    # the kernel's span on the autograd thread places no idle time
    paths = {path for _, _, path in pieces}
    assert all(P + 'kernel.cin_bwd' not in path for path in paths)
    assert (P + 'fit.validation', P + 'input.check_ids') in paths
    # inside perfbench.train_step: 10 µs under no span, 230 under leaves
    assert program.placed_pct(trace, pieces) == pytest.approx(
        100 * 230 / 240)
    # the readers write the breakdown to standard error once
    ctx = context(events(), log=log_of(TRAIN_SPANS, 5))
    for name in TRAIN:
        read(name, ctx)
    err = [line for line in capsys.readouterr().err.splitlines()
           if line.startswith('idle_by_program_span ')]
    assert len(err) == 1
    assert json.loads(err[0].split(' ', 1)[1])['placed_pct'] == \
        pytest.approx(100 * 230 / 240)


def test_training_readers():
    ctx = context(events(), log=log_of(TRAIN_SPANS, 12.25))
    # input 40 + 40 µs under the step (the validation's check is the loop's)
    assert read('idle_input_pct.train', ctx) == pytest.approx(8.0)
    assert read('idle_forward_pct.train', ctx) == pytest.approx(0.0)
    assert read('idle_backward_pct.train', ctx) == pytest.approx(4.0)
    # fit.batch 8, the validation's check 50 and the rest of it 140
    assert read('idle_epoch_loop_pct.train', ctx) == pytest.approx(19.8)
    assert read('device_idle_pct.train', ctx) == pytest.approx(45.0)
    for name in TRAIN:
        # a program without spans or a log, or a trace without the card:
        # nothing
        assert read(name, context(events())) is None
        assert read(name, context(events(), log=[])) is None
        assert read(name, context([e for e in events()
                                   if e['cat'] != 'kernel'
                                   and e['cat'] != 'gpu_memset'],
                                  log=log_of(TRAIN_SPANS))) is None


def test_serving_readers():
    ctx = context(serve_events(), 'serve', log=log_of(SERVE_SPANS, -3))
    # pad 48 + 18, copy back 70 + 90, the requests' own 8 + 8
    assert read('idle_request_pct.serve', ctx) == pytest.approx(24.2)
    # forward 10 + 10 + 100 + 200, its input copy's 30 included
    assert read('idle_forward_pct.serve', ctx) == pytest.approx(35.0)
    assert read('device_idle_pct.serve', ctx) == pytest.approx(60.0)


def test_pad_share_reads_the_span_log():
    log = [{'name': P + 'serve.request', 'counts': {'rows': 500,
                                                    'padded_rows': 12}},
           {'name': P + 'serve.pad', 'counts': {}},
           {'name': P + 'serve.request', 'counts': {'rows': 4096,
                                                    'padded_rows': 0}},
           {'name': P + 'serve.request', 'counts': {'rows': 9000,
                                                    'padded_rows': 3288}}]
    ctx = context(serve_events(), 'serve', {'program_span_log': log})
    assert read('serve_pad_share', ctx) == pytest.approx(
        100 * 3300 / (13596 + 3300))
    assert read('serve_pad_share', context(
        serve_events(), 'serve', {'program_span_log': None})) is None
    assert read('serve_pad_share', context(
        serve_events(), 'serve', {'program_span_log': []})) is None


def test_pad_share_takes_the_programs_log_once():
    from deeptables_torch.utils import profiling
    profiling.take_spans()
    with torch.profiler.profile():
        with profiling.annotate(P + 'serve.request', request=1, rows=3,
                                padded_rows=5):
            pass
    ctx = ReadContext(tiny.config('xdeepfm_criteo_synth'),
                      tiny.traffic('serve'),
                      Trace.from_events(serve_events()), {})
    assert read('serve_pad_share', ctx) == pytest.approx(62.5)
    assert read('serve_pad_share', ctx) == pytest.approx(62.5)
    assert profiling.take_spans() == []


# what the program nests in what (the names after ``deeptables.``)
TREE = {'': ['step', 'fit.batch', 'fit.train_metrics', 'fit.validation',
             'serve.request'],
        'step': ['input.check_ids', 'input.copy', 'step.forward',
                 'step.backward', 'step.optimizer', 'step.loss_state'],
        'step.forward': ['model.embedding', 'model.net.cin_nets',
                         'model.head'],
        'model.net.cin_nets': ['kernel.cin_fwd'],
        'fit.validation': ['input.check_ids', 'input.copy', 'model.head'],
        'serve.request': ['serve.pad', 'serve.forward', 'serve.copy_back'],
        'serve.forward': ['input.copy', 'model.dense', 'model.head']}
# the harness's span around each of the program's roots that has one
AROUND = {'step': spans_lib.TRAIN_STEP, 'serve.request': spans_lib.REQUEST}


@pytest.mark.parametrize('seed', range(40))
def test_idle_shares_partition_the_device_idle(seed):
    """Random span trees as the program nests them, on the step's thread
    and the autograd thread, and random kernels: the idle time by path
    adds up to the idle time, and the ``idle_*`` shares of a cell, each
    and together, are at most ``device_idle_pct``."""
    rng = np.random.default_rng(seed)
    evs = [x('user_annotation', spans_lib.STRETCH, 0, 1000)]
    for _ in range(int(rng.integers(1, 30))):
        a = float(rng.uniform(-50, 1050))
        evs.append(x('kernel', 'k', a, float(rng.uniform(1, 80))))
    spans = []

    def nest(a, b, parent):
        t = a
        while t < b and TREE.get(parent):
            s = float(rng.uniform(t, b))
            e = float(rng.uniform(s, b))
            name = str(rng.choice(TREE[parent]))
            spans.append((name, s, e, 2 if name.startswith('kernel.')
                          else 1))
            if not parent and name in AROUND:
                evs.append(x('user_annotation', AROUND[name], s - 1,
                             e - s + 2))
            nest(s, e, name)
            t = e + float(rng.uniform(0, 100))
    nest(-20, 1020, '')
    log = log_of(spans, float(rng.uniform(-1e6, 1e6)))
    trace = Trace.from_events(evs)
    placed = program.program_spans(trace, log)
    for traffic, group in (('train', TRAIN), ('serve', SERVE)):
        ctx = context(evs, traffic, log=log)
        device = read(f'device_idle_pct.{traffic}', ctx)
        shares = [read(name, ctx) for name in group]
        if not placed or not trace.device:
            assert shares == [None] * len(group)
            continue
        pieces = program.idle_pieces(trace.idle_gaps(), placed)
        assert sum(b - a for a, b, _ in pieces) == pytest.approx(
            trace.window_us - trace.busy_us())
        assert all(0 <= v <= device + 1e-9 for v in shares)
        assert sum(shares) <= device + 1e-9


def test_new_entries_in_the_benchmark():
    doc = spec_lib.load_json(ROOT / 'BENCHMARK.json')
    entries = {m['name']: m for m in doc['per_layer']}
    layers = {m['layer'] for m in doc['per_layer']}
    assert {'train step', 'request', 'model, nets',
            'epoch loop (host)'} <= layers
    for name in TRAIN:
        assert entries[name]['moves'] == 'train_examples_per_s'
        assert entries[name]['workloads'] == [
            'deepfm_criteo_kaggle.train', 'xdeepfm_criteo_synth.train']
    for name in SERVE + ('serve_pad_share',):
        assert entries[name]['moves'] == 'serve_rows_per_s'
        assert entries[name]['workloads'] == ['xdeepfm_criteo_synth.serve']
    for cell in ('deepfm_criteo_kaggle.train', 'xdeepfm_criteo_synth.train',
                 'xdeepfm_criteo_synth.serve'):
        listed = [m['name'] for m in spec_lib.cell(cell).per_layer]
        assert set(listed) & set(TRAIN + SERVE)


# ---------------------------------------------------------------- card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return 'cuda'


@pytest.mark.cuda
def test_a_kernel_span_holds_its_launch(card, tmp_path):
    """The program's span around K2 (``kernel.fm``) and, on the autograd
    engine's thread, around its backward (``kernel.fm_backward``) hold
    the CUDA runtime's launch of the kernel the card ran: as the profiler
    writes the ranges (the spans and the card's events share the
    profiler's clock), and as the span log, placed on the harness's trace
    by the harness's span around the program's step, says."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from deeptables_torch.ops.kernels.fm import fm
    from deeptables_torch.utils import profiling

    def step():
        with record_function(spans_lib.TRAIN_STEP):
            with profiling.annotate(P + 'step', step=0):
                fm(x_).sum().backward()
        torch.cuda.synchronize()

    kernels = (('kernel.fm', 'fm_fwd', True),
               ('kernel.fm_backward', 'fm_bwd', False))
    x_ = torch.randn(4096, 26, 16, device=card, requires_grad=True)
    fm(x_).sum().backward()
    torch.cuda.synchronize()
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    prof.export_chrome_trace(str(tmp_path / 'trace.json'))
    evs = [e for e in json.loads((tmp_path / 'trace.json').read_text())[
        'traceEvents'] if e.get('ph') == 'X']
    corr = lambda e: (e.get('args') or {}).get('correlation')
    launches = {corr(e): e['ts'] for e in evs
                if e.get('cat') in trace_lib.LAUNCH_CATEGORIES}
    step_tid = [e['tid'] for e in evs if e['name'] == P + 'step']
    for span, kernel, same_thread in kernels:
        ranges = [e for e in evs if e['name'] == P + span
                  and e.get('cat') == 'user_annotation']
        launched = [launches[corr(e)] for e in evs
                    if e.get('cat') == 'kernel' and kernel in e['name']]
        assert len(ranges) == 1 and len(launched) == 1, (ranges, launched)
        r = ranges[0]
        assert r['ts'] <= launched[0] < r['ts'] + r['dur']
        assert (r['tid'] == step_tid[0]) == same_thread

    profiling.take_spans()
    profiler = trace_lib.Profiler(cuda=True)
    profiler.start()
    step()
    trace = profiler.stop()
    log = profiling.take_spans()
    lo, hi, thread = program.clock_bounds(trace, log)
    us = program.log_us(log)
    for span, kernel, same_thread in kernels:
        entries = [e for e in log if e['name'] == P + span]
        launched = [trace.launches[e[3]] for e in trace.device
                    if kernel in e[0]]
        assert len(entries) == 1 and len(launched) == 1, (entries, launched)
        # the launch within the entry: offsets that the bounds admit
        e = entries[0]
        assert max(lo, launched[0] - us(e['end'])) <= \
            min(hi, launched[0] - us(e['start']))
        assert (e['thread'] == thread) == same_thread
    json.dumps(trace.breakdown())
