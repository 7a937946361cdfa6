"""The nets as files of their own (``perfbench/nets``): what the harness
computed before they were, held bit for bit (``golden.json``: the leaves,
the operation counts, the port's names and settings of both
configurations; at the tiny sizes the initial weights, the reference's
logits and its three Adam steps at each precision); no module outside
``perfbench/nets`` names a net; a net with no module is refused."""

import ast
import dataclasses
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import tiny
from perfbench import nets as nets_lib
from perfbench.counts import flops
from perfbench.harness import device, inputs, port, spec as spec_lib, weights
from perfbench.reference import model as ref

HERE = Path(__file__).resolve().parent
GOLDEN = json.loads((HERE / 'golden.json').read_text())
CONFIGS = ['deepfm_criteo_kaggle', 'xdeepfm_criteo_synth']
SEED = 2 ** 31 + 23
PER_ROW = {'deepfm_criteo_kaggle': 861_553,
           'xdeepfm_criteo_synth': 45_282_704}


def full(name):
    return spec_lib.load_json(spec_lib.BENCH_DIR / 'configs' / f'{name}.json')


def specs(config):
    return [[n, list(s), list(i)] for n, s, i in ref.param_specs(config)]


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's sums in one order, run to run."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize('name', CONFIGS)
def test_leaves_counts_names_and_settings(name):
    cfg, golden = full(name), GOLDEN[name]
    assert specs(cfg) == golden['leaves']
    assert flops.forward_per_row(cfg) == golden['forward_per_row']
    assert sum(flops.forward_per_row(cfg).values()) == PER_ROW[name]
    # the names of the configuration's leaves and statistics (the map
    # once also named the CIN's output for DeepFM, which has none)
    keys = {leaf for leaf, _, _ in ref.param_specs(cfg)} | {
        f'{bn}.{stat}' for bn in ('bn_dense', 'bn_concat')
        for stat in ('mean', 'var')}
    names = port.port_names(cfg)
    assert set(names) == keys
    assert names == {k: v for k, v in golden['port_names'].items()
                     if k in keys}
    small = tiny.config(name)
    assert set(port.port_names(small)) == set(weights.make(small, 1, 'cpu'))
    model = port.build(cfg, 3, 'cpu')
    assert {k: repr(v) for k, v in dataclasses.asdict(
        model.config).items()} == golden['model_config']


@pytest.mark.parametrize('name', CONFIGS)
def test_tiny_weights_and_reference(name, one_thread):
    cell, golden = tiny.cell(name, 'train'), GOLDEN[name]['tiny']
    cfg = cell.config
    assert specs(cfg) == golden['leaves']
    assert flops.forward_per_row(cfg) == golden['forward_per_row']
    params = weights.make(cfg, SEED, 'cpu')
    assert {k: hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()
            for k, v in params.items()} == golden['weights_sha256']

    cat, dense = inputs.rows(np.random.default_rng(5), cfg, 50, 1.2)
    for precision in ('fp32', 'tf32', 'fp64'):
        p = ref.cast(params, precision)
        d = ref.cast({'x': torch.as_tensor(dense)}, precision)['x']
        for training in (False, True):
            with torch.no_grad():
                z = ref.forward(p, cfg, torch.as_tensor(cat).long(), d,
                                training, precision)
            assert hashlib.sha256(z.numpy().tobytes()).hexdigest() == \
                golden[f'logits_{precision}_{training}'], (precision, training)

    driver = spec_lib.driver('train_fit')
    (train, y), _ = driver.make_data(cell, SEED)
    b = int(cell.traffic['batch_size'])
    rows = [slice(i * b, (i + 1) * b) for i in range(3)]
    batches = [port.columns({k: v[r] for k, v in train.items()}) + (y[r],)
               for r in rows]
    for precision in ('fp32', 'tf32', 'fp64'):
        got = driver.reference(cell, SEED, 'cpu', batches, precision)
        want = golden[f'reference_{precision}']
        assert [float(x).hex() for x in got['losses']] == want['losses']
        for key in ('grad_norms', 'change_norms'):
            assert {k: float(v).hex() for k, v in got[key].items()} == \
                want[key], (precision, key)


def as_lists(calls):
    return {k: [list(s) for s in v] for k, v in calls.items()}


def test_cin_kernel_calls():
    cfg, golden = full('xdeepfm_criteo_synth'), GOLDEN['xdeepfm_criteo_synth']
    train = nets_lib.kernel_calls(cfg, [(8192, 'train')] * 2 +
                                  [(8192, 'infer'), (4096, 'infer')])
    assert as_lists(train) == golden['train_calls']
    serve = nets_lib.kernel_calls(cfg, [(4096, 'infer'), (8192, 'infer')])
    assert as_lists(serve) == golden['serve_calls']
    assert nets_lib.kernel_calls(full('deepfm_criteo_kaggle'),
                                 [(8192, 'train')]) == {}


def test_launch_counters_found_without_names():
    counters = device.launch_counters()
    assert {'cin_fwd', 'cin_bwd', 'fm', 'fm_backward', 'emb_grad', 'fa_fwd',
            'fa_bwd', 'ab_fwd', 'ab_bwd'} <= set(counters)
    assert all(isinstance(v, int) for v in counters.values())


def test_launch_counters_refuse_two_wrappers_of_one_name(monkeypatch):
    """A wrapper is known by its name alone (the nets' bounds and calls),
    so two kernel modules that define one name are refused, not merged."""
    import types

    def module(name):
        def wrapper():
            pass
        wrapper.__module__, wrapper.launches = name, 3
        return types.SimpleNamespace(__name__=name, cin_fwd=wrapper)

    mods = {f'deeptables_torch.ops.kernels.{m}': module(
        f'deeptables_torch.ops.kernels.{m}') for m in ('one', 'two')}
    monkeypatch.setattr(device.pkgutil, 'iter_modules', lambda path: [
        types.SimpleNamespace(name='one'), types.SimpleNamespace(name='two')])
    monkeypatch.setattr(device.importlib, 'import_module', mods.__getitem__)
    with pytest.raises(ValueError, match='cin_fwd'):
        device.launch_counters()
    del mods['deeptables_torch.ops.kernels.two'].cin_fwd
    assert device.launch_counters() == {'cin_fwd': 3}


def zoo():
    from deeptables_torch.models import deepnets
    return set(deepnets._BUILTIN)


def test_no_module_outside_nets_names_a_net():
    """No string in the harness's code outside ``perfbench/nets`` and the
    tests is a net's name, and none of it imports a net's module."""
    names = zoo()
    assert {'linear', 'fm_nets', 'cin_nets', 'dnn_nets'} <= names
    bench = spec_lib.BENCH_DIR
    found = []
    for path in sorted(bench.rglob('*.py')):
        rel = path.relative_to(bench).parts
        if rel[0] in ('nets', 'tests'):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and node.value in names:
                found.append((str(path), node.lineno, node.value))
            if isinstance(node, ast.ImportFrom) and node.module and (
                    node.module.split('.')[-1] in names or
                    any(a.name in names for a in node.names)):
                found.append((str(path), node.lineno, node.module))
    assert not found, found


def test_a_net_without_a_file_is_refused(tmp_path):
    bench = tmp_path / 'perfbench'
    shutil.copytree(spec_lib.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(spec_lib.ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    path = bench / 'configs' / 'xdeepfm_criteo_synth.json'
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cfg, nets=['linear', 'autoint_nets'])))
    missing = bench / 'nets' / 'autoint_nets.py'
    with pytest.raises(FileNotFoundError, match=str(missing)):
        spec_lib.cell('xdeepfm_criteo_synth.train', root=tmp_path,
                      bench_dir=bench)
    with pytest.raises(FileNotFoundError, match='autoint_nets.py'):
        nets_lib.load('autoint_nets')
    with pytest.raises(ValueError):
        nets_lib.load('../harness/port')
