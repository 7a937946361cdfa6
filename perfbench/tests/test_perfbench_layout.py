"""The harness is driven by data: a configuration, a traffic mix, a cell's
limits and a per-layer metric are added as new files alone. And
``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import tiny
from perfbench.harness import spec as spec_lib
from perfbench.harness.outcome import ReadContext
from perfbench.harness.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
WIDTH = re.compile(r'_dim$|_rank$|hidden|units|size|head|width|factor')


def benchmark():
    return spec_lib.load_json(ROOT / 'BENCHMARK.json')


# a net the harness lacks, as a later configuration would bring it: DCN's
# cross layers (the port's ``cross_nets``), x_{l+1} = x0·(x_l·w_l) + x_l + b_l
# over the BatchNormed concatenation, then a Dense without bias to a logit
CROSS_NETS = '''
from perfbench.reference import model as ref


def _layers(config):
    return int(config['cross_layers'])


def param_specs(config):
    n = ref.concat_width(config)
    specs = []
    for i in range(_layers(config)):
        specs += [(f'cross.{i}.w', (n, 1), ref.lecun(n)),
                  (f'cross.{i}.b', (n,), ref.SMALL)]
    return specs + [('cross.logit.w', (1, n), ref.lecun(n))]


def forward(params, config, parts, training, precision):
    x0 = x = parts.concat
    for i in range(_layers(config)):
        x = x0 * ref.matmul(x, params[f'cross.{i}.w'], precision) + x \\
            + params[f'cross.{i}.b']
    return ref.matmul(x, params['cross.logit.w'].t(), precision)


def ops_per_row(config):
    return (5 * _layers(config) + 2) * ref.concat_width(config)


def port_settings(config):
    return {'cross_params': {'num_cross_layer': _layers(config)}}


def port_names(config):
    names = {'cross.logit.w': 'dense_logit_cross_nets.weight'}
    for i in range(_layers(config)):
        names[f'cross.{i}.w'] = f'cross_layer.kernels_{i}'
        names[f'cross.{i}.b'] = f'cross_layer.bias_{i}'
    return names
'''

# run in a copy of the checkout: its cells, each driver's whole run
IN_COPY = '''
import json, sys, time
sys.path[:0] = [{copy!r}]
sys.path.append({root!r})
import perfbench
from perfbench.harness import compare, spec
assert perfbench.__file__.startswith({copy!r}), perfbench.__file__
out = {{}}
for name in {cells!r}:
    cell = spec.cell(name)
    result = spec.driver(cell.traffic['driver']).run(
        cell, 2 ** 31 + 29, 0.3, False, 'cpu', time.time())
    out[name] = dict(checks=result.checks, failed=result.failed,
                     correct=compare.all_within(result.checks))
print(json.dumps(out))
'''


def test_new_files_alone(tmp_path):
    """A copy of the harness gains a configuration, a mix, limits and a
    metric; then a configuration of a net it lacks (``cross_nets``) and no
    dense features, with that net's module, whose cells train and serve on
    the CPU within the tiny limits; nothing that was there is edited."""
    bench = tmp_path / 'perfbench'
    shutil.copytree(spec_lib.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in bench.rglob('*') if p.is_file()}
    cfg = tiny.config('deepfm_criteo_kaggle')
    cfg['name'] = 'deepfm_tiny'
    (bench / 'configs' / 'deepfm_tiny.json').write_text(json.dumps(cfg))
    mix = dict(tiny.traffic('train'), batch_size=32)
    (bench / 'traffic' / 'small_batches.json').write_text(json.dumps(mix))
    (bench / 'limits' / 'deepfm_tiny.small_batches.json').write_text(
        json.dumps(tiny.LIMITS['train_fit']))
    (bench / 'metrics' / 'stretch_ms.py').write_text(
        'def read(ctx):\n'
        '    return None if ctx.trace is None else ctx.trace.window_us / 1e3\n')
    doc = benchmark()
    doc['configs'].append({'name': 'deepfm_tiny', 'source': 'x',
                           'file': 'perfbench/configs/deepfm_tiny.json',
                           'reduced': [], 'why': 'a test'})
    doc['workloads'].append({
        'name': 'deepfm_tiny.small_batches', 'config': 'deepfm_tiny',
        'traffic': 'small_batches', 'chips': 1, 'why': 'a test'})
    doc['per_layer'].append({
        'name': 'stretch_ms', 'unit': 'ms', 'better': 'lower',
        'source': 'device_trace', 'layer': 'device',
        'moves': 'train_examples_per_s',
        'workloads': ['deepfm_tiny.small_batches']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(doc))

    cell = spec_lib.cell('deepfm_tiny.small_batches', root=tmp_path,
                         bench_dir=bench)
    assert cell.config == cfg and cell.traffic == mix
    assert [m['name'] for m in cell.end_to_end] == [
        'setup_s']  # the others list their cells
    assert [m['name'] for m in cell.per_layer] == ['stretch_ms']
    reader = spec_lib.metric('stretch_ms', bench_dir=bench)
    trace = Trace(start=0.0, end=2500.0)
    assert reader.read(ReadContext(cfg, mix, trace, {})) == 2.5
    assert spec_lib.driver(mix['driver'], bench_dir=bench).run

    (bench / 'nets' / 'cross_nets.py').write_text(CROSS_NETS)
    cross = dict(tiny.config('deepfm_criteo_kaggle'), name='dcn_tiny',
                 nets=['linear', 'cross_nets', 'dnn_nets'],
                 dense_features=0, cross_layers=2)
    (bench / 'configs' / 'dcn_tiny.json').write_text(json.dumps(cross))
    doc['configs'].append({'name': 'dcn_tiny', 'source': 'x',
                           'file': 'perfbench/configs/dcn_tiny.json',
                           'reduced': [], 'why': 'a test'})
    cells = []
    for kind in ('train', 'serve'):
        (bench / 'traffic' / f'tiny_{kind}.json').write_text(
            json.dumps(tiny.traffic(kind)))
        driver = tiny.traffic(kind)['driver']
        (bench / 'limits' / f'dcn_tiny.tiny_{kind}.json').write_text(
            json.dumps(tiny.LIMITS[driver]))
        doc['workloads'].append({
            'name': f'dcn_tiny.tiny_{kind}', 'config': 'dcn_tiny',
            'traffic': f'tiny_{kind}', 'chips': 1, 'why': 'a test'})
        cells.append(f'dcn_tiny.tiny_{kind}')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(doc))
    proc = subprocess.run(
        [sys.executable, '-c', IN_COPY.format(
            copy=str(tmp_path), root=str(ROOT), cells=cells)],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in cells:
        assert runs[name]['correct'] and runs[name]['failed'] == 0, runs
    assert all(p.read_bytes() == data for p, data in before.items())


def test_every_cell_loads():
    doc = benchmark()
    for workload in doc['workloads']:
        cell = spec_lib.cell(workload['name'])
        spec_lib.driver(cell.traffic['driver'])
        for metric in cell.per_layer:
            assert callable(spec_lib.metric(metric['name']).read)
        e2e = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in e2e and len(e2e) >= 2 and cell.per_layer
        for metric in cell.per_layer:
            assert metric['moves'] in e2e


def test_contract():
    doc = benchmark()
    assert set(doc) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
    assert doc['paths'] == ['perfbench'] and 1 <= doc['run_seconds'] <= 51
    assert doc['command'] == ['python3', 'perfbench/run.py']
    names = set()
    for c in doc['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and c['file'].startswith('perfbench/')
        assert (ROOT / c['file']).is_file()
        cfg = spec_lib.load_json(ROOT / c['file'])
        assert cfg['reduced'] == c['reduced'] and cfg['source'] == c['source']
        for key in c['reduced']:
            # a changed key is in the file, with the reason, and no width
            assert NAME.match(key) and key in cfg and key in cfg['why_reduced']
            assert not WIDTH.search(key)
        assert 1 <= len(c['why']) <= 200 and 1 <= len(c['source']) <= 200
        names.add(c['name'])
    used = set()
    for w in doc['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['config'] in names and w['chips'] == 1
        assert 1 <= len(w['why']) <= 200
        used.add(w['config'])
    assert used == names
    metrics = doc['end_to_end'] + doc['per_layer']
    assert len({m['name'] for m in metrics}) == len(metrics)
    cells = {w['name'] for w in doc['workloads']}
    for m in doc['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in doc['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert set(m['workloads']) <= cells
    for m in metrics:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
    assert len(json.dumps(doc)) < 64 * 1024


@pytest.mark.parametrize('key, value', [('dnn_dropout', 0.5),
                                        ('l2_penalty', 1e-4)])
def test_a_setting_the_reference_lacks_is_refused(tmp_path, key, value):
    bench = tmp_path / 'perfbench'
    shutil.copytree(spec_lib.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    path = bench / 'configs' / 'xdeepfm_criteo_synth.json'
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cfg, **{key: value})))
    with pytest.raises(ValueError, match=key):
        spec_lib.cell('xdeepfm_criteo_synth.train', root=tmp_path,
                      bench_dir=bench)
