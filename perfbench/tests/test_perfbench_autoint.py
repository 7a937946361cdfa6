"""``autoint_avazu``: AutoInt's net as a file of its own
(``nets/autoint_nets.py``, its fault ``head_swap``), its configuration and
cell, and the readers of its two per-layer metrics.

- a tiny variant (five columns, D = 4 → 2 heads of 4, three layers)
  trains and serves on the CPU within the tiny limits, and ``head_swap``
  fails it;
- the operations a row against a count by hand, at the tiny shape and at
  the configuration's;
- K5's calls and bounds at the cell's shapes, and the readers of
  ``fa_roofline_pct.train`` and ``idle_autoint_pct.train`` on synthetic
  traces;
- the net's module reaches nothing of the port."""

import time

import pytest
import torch

import tiny
from perfbench import nets as nets_lib
from perfbench import run as run_lib
from perfbench.counts import flops
from perfbench.harness import port, spec as spec_lib, weights
from perfbench.harness.outcome import ReadContext
from perfbench.harness.trace import Trace
from perfbench.nets import autoint_nets
from test_perfbench_isolation import ROOT, reaches_out
from test_perfbench_metrics import events, x
from test_perfbench_program import TRAIN_SPANS, context, log_of, read

CONFIG = 'autoint_avazu'
CELL = 'autoint_avazu.train_b32768'
SEED = 2 ** 31 + 41


def full():
    return spec_lib.load_json(spec_lib.BENCH_DIR / 'configs' /
                              f'{CONFIG}.json')


def tiny_config():
    """Five columns at D = 4, three layers of 2 heads of 4: each layer
    changes the width (4 → 8), as the configuration's does (16 → 64)."""
    cfg = tiny.config(CONFIG)
    cfg['autoint_num_units'] = 8
    return cfg


def tiny_cell(traffic):
    cell = tiny.cell(CONFIG, traffic)
    cell.config = tiny_config()
    return cell


def run(traffic, fault=None):
    cell = tiny_cell(traffic)
    driver = spec_lib.driver(cell.traffic['driver'])
    result = driver.run(cell, SEED, 0.3, False, 'cpu', time.time(),
                        fault=fault)
    info = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': 0}
    return run_lib.result_line(cell, result, False, info)


def test_the_cell_loads():
    cell = spec_lib.cell(CELL)
    cfg = cell.config
    assert cfg == full() and cell.traffic['batch_size'] == 32768
    assert sum(v + 1 for v in cfg['vocabulary']) == 9_449_467
    assert len(cfg['vocabulary']) == 22
    assert autoint_nets.widths(cfg) == [(16, 64), (64, 64), (64, 64)]
    assert {m['name'] for m in cell.end_to_end} == {
        'train_examples_per_s', 'setup_s'}
    assert {'fa_roofline_pct.train', 'idle_autoint_pct.train',
            'train_mfu', 'optimizer_roofline_pct'} <= {
        m['name'] for m in cell.per_layer}
    assert set(cell.limits) == {'loss_gap', 'grad_gap', 'grad_own_gap',
                                'grad_quartile_gap', 'change_gap'}


def test_the_port_takes_the_harness_weights():
    cfg = tiny_config()
    model = port.build(cfg, 3, 'cpu')
    port.load(model, weights.make(cfg, SEED, 'cpu'), cfg)
    block = model.build().autoint_attention_0
    assert tuple(block.dense_Q.weight.shape) == (8, 4)
    assert model.config.autoint_params['num_units'] == 8


@pytest.mark.parametrize('traffic', ['train', 'serve'])
def test_tiny_cell_is_correct(traffic):
    line = run(traffic)
    assert line['correct'] and line['failed'] == 0, line['checks']


def test_head_swap_is_not_correct():
    line = run('train', 'head_swap')
    assert not line['correct']
    # the fault changes the loss itself, not only a leaf's gradient
    assert line['checks']['loss_gap']['value'] > \
        line['checks']['loss_gap']['limit']


def test_head_swap_changes_only_its_block():
    """Planted, block 1's output changes and block 0's and block 2's do
    not; the port's attention is restored afterwards."""
    from deeptables_torch.ops import interactions
    from perfbench.nets.faults.autoint_nets import head_swap
    model = port.build(tiny_config(), 3, 'cpu')
    blocks = [getattr(model.build(), f'autoint_attention_{i}')
              for i in range(3)]
    inputs = [torch.randn(6, 5, 4)] + [torch.randn(6, 5, 8)] * 2
    original = interactions.field_attention
    with torch.no_grad():
        before = [b(x) for b, x in zip(blocks, inputs)]
        try:
            head_swap(model)
            after = [b(x) for b, x in zip(blocks, inputs)]
        finally:
            interactions.field_attention = original
    assert torch.equal(before[0], after[0])
    assert torch.equal(before[2], after[2])
    assert not torch.allclose(before[1], after[1])


def test_ops_per_row_by_hand():
    # tiny: F = 5, D = 4, U = 8, H = 2 (dh = 4), 4 projections a layer.
    # Layer 0: projections 4·5·(2·4·8 + 8) = 1440, attention 4·5·5·4·2 =
    # 800, residual 5·8 = 40; layers 1 and 2: 4·5·(2·8·8 + 8) = 2720, 800,
    # 40; the logit 2·5·8 = 80
    assert autoint_nets.ops_per_row(tiny_config()) == \
        2280 + 2 * 3560 + 80 == 9480
    # the cell: F = 22, D = 16, U = 64, H = 2 (dh = 32). Layer 0:
    # 4·22·(2·16·64 + 64) = 185,856, 4·22·22·32·2 = 123,904, 22·64 =
    # 1408; layers 1, 2: 4·22·(2·64·64 + 64) = 726,528, 123,904, 1408; the
    # logit 2·22·64 = 2816
    assert autoint_nets.ops_per_row(full()) == \
        311_168 + 2 * 851_840 + 2816 == 2_017_664
    per_row = flops.forward_per_row(full())
    assert per_row == {'linear': 22 * 16 + 2 * 22, 'autoint_nets': 2_017_664,
                       'head': 1 + 2 + 1}


def test_kernel_calls_and_bounds():
    cfg = full()
    shape = (32768, 22, 2, 32)
    calls = nets_lib.kernel_calls(cfg, [(32768, 'train'), (4096, 'infer')])
    assert calls == {'fa_fwd': [shape] * 3 + [(4096, 22, 2, 32)] * 3,
                     'fa_bwd': [shape] * 3}
    elements = 32768 * 22 * 64
    fwd, fwd_ops = autoint_nets.fa_bound('fa_fwd', *shape, 4)
    bwd, bwd_ops = autoint_nets.fa_bound('fa_bwd', *shape, 4)
    assert fwd == pytest.approx(4 * 4 * elements / 3.35e12)
    assert bwd == pytest.approx(7 * 4 * elements / 3.35e12)
    assert fwd_ops == 4 * 22 * 22 * 32 * 2 * 32768
    assert bwd_ops == 10 * 22 * 22 * 32 * 2 * 32768
    spec = nets_lib.bounds(cfg)
    assert set(spec) == {'fa_fwd', 'fa_bwd'}
    tile = 'void fa_fwd_tile_kernel<float, float, 32>(float const*, int)'
    warp = 'void fa_bwd_kernel<float, float, 64, 0>(float const*, long)'
    assert spec['fa_fwd'].runs(tile) and spec['fa_fwd'].once_a_call(tile)
    assert spec['fa_bwd'].runs(warp) and not spec['fa_fwd'].runs(warp)
    for other in ('void ab_fwd_tile_kernel<float, 32>(float const*)',
                  'void ab_bwd_kernel<float, 64, 0>(float const*)'):
        assert not spec['fa_fwd'].runs(other)
        assert not spec['fa_bwd'].runs(other)


def fa_events():
    """``events()``'s stretch with two K5 kernels and one K6 kernel on the
    card, 100, 150 and 50 µs."""
    return events() + [
        x('kernel', 'void fa_fwd_tile_kernel<float, float, 8>(int)', 820, 100,
          corr=7),
        x('kernel', 'void fa_bwd_tile_kernel<float, float, 8>(int)', 460, 130,
          corr=8),
        x('kernel', 'void ab_fwd_tile_kernel<float, 8>(int)', 940, 50,
          corr=9)]


def test_fa_roofline_reader(capsys):
    shape = (64, 5, 2, 4)
    record = {'kernel_calls': {'fa_fwd': [shape], 'fa_bwd': [shape]},
              'launches': {'fa_fwd': 1, 'fa_bwd': 1}}
    ctx = ReadContext(tiny_config(), tiny.traffic('train'),
                      Trace.from_events(fa_events()), record)
    fwd = autoint_nets.fa_bound('fa_fwd', *shape, 4)[0]
    bwd = autoint_nets.fa_bound('fa_bwd', *shape, 4)[0]
    reader = spec_lib.metric('fa_roofline_pct.train')
    assert reader.read(ctx) == pytest.approx(100 * (fwd + bwd) / 230e-6)
    assert capsys.readouterr().err == ''
    assert reader.read(ReadContext(tiny_config(), tiny.traffic('train'),
                                   Trace.from_events(fa_events()), {})) \
        is None


def test_idle_autoint_reader():
    # a layer in a step's forward, where the card is busy, and one in the
    # validation forward over [850, 900], where it is idle: 50 µs of 1000
    spans = TRAIN_SPANS + [('autoint.block', 150, 250),
                           ('autoint.block', 850, 900)]
    ctx = context(events(), log=log_of(spans, 7.5))
    assert read('idle_autoint_pct.train', ctx) == pytest.approx(5.0)
    # a program without the layers' spans (the parent's), or without a log
    for log in (log_of(TRAIN_SPANS), [], None):
        assert read('idle_autoint_pct.train', context(events(), log=log)) \
            is None


def test_the_net_reaches_nothing_of_the_port():
    for path in (ROOT / 'perfbench' / 'nets' / 'autoint_nets.py',
                 ROOT / 'perfbench' / 'metrics' / 'fa_roofline_pct.train.py',
                 ROOT / 'perfbench' / 'metrics'
                 / 'idle_autoint_pct.train.py'):
        assert path.is_file()
    assert reaches_out(ROOT / 'perfbench' / 'nets' / 'autoint_nets.py',
                       'perfbench.nets') == []
    fault = ROOT / 'perfbench' / 'nets' / 'faults' / 'autoint_nets.py'
    assert reaches_out(fault, 'perfbench.nets.faults') == [
        'deeptables_torch.ops']


def test_the_reference_refuses_dropout():
    cfg = tiny_config()
    cfg['autoint_dropout_rate'] = 0.1
    with pytest.raises(ValueError, match='autoint_dropout_rate'):
        autoint_nets.param_specs(cfg)
