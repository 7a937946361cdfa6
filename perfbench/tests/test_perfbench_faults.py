"""A run without the look for a card: each driver at a tiny size on the
CPU, sound and with each fault it can have planted under the timed path.
The sound run is correct; every broken one is not."""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest

import tiny
from perfbench import run as run_lib
from perfbench.harness import spec as spec_lib

ROOT = Path(__file__).resolve().parents[2]


def outcome(traffic, fault=None, trace=False, config='xdeepfm_criteo_synth'):
    cell = tiny.cell(config, traffic)
    driver = spec_lib.driver(cell.traffic['driver'])
    return cell, driver.run(cell, 2 ** 31 + 17, 0.3, trace, 'cpu',
                            time.time(), fault=fault)


def correct(cell, result, trace=False):
    info = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
            'memory_peak_bytes': result.memory_peak_bytes}
    return run_lib.result_line(cell, result, trace, info)


@pytest.mark.parametrize('config', ['deepfm_criteo_kaggle',
                                    'xdeepfm_criteo_synth'])
def test_sound_training_run(config):
    cell, result = outcome('train', config=config)
    line = correct(cell, result)
    assert line['correct'], line['checks']
    assert result.attempted % 4 == 0 and result.attempted >= 4
    assert result.metrics['train_examples_per_s'] > 0
    assert list(line)[-1] == 'checks'


@pytest.mark.parametrize('fault', ['half_batch', 'unchanged_state',
                                   'cin_tile'])
def test_broken_training_run(fault):
    cell, result = outcome('train', fault)
    assert not correct(cell, result)['correct']


def test_sound_serving_run():
    cell, result = outcome('serve')
    assert correct(cell, result)['correct']
    assert result.failed == 0 and result.attempted >= 1
    assert result.metrics['serve_p95_ms'] > 0


@pytest.mark.parametrize('fault', ['altered_answer', 'half_rows'])
def test_broken_serving_run(fault):
    cell, result = outcome('serve', fault)
    assert not correct(cell, result)['correct']


@pytest.mark.parametrize('traffic', ['train', 'serve'])
def test_traced_run_line(traffic):
    cell, result = outcome(traffic, trace=True)
    cell.per_layer = [m for m in spec_lib.load_json(
        ROOT / 'BENCHMARK.json')['per_layer']
        if any(w.endswith('.' + traffic) for w in m['workloads'])]
    assert cell.per_layer
    line = correct(cell, result, trace=True)
    assert line['correct'] and result.trace is not None
    # no device on the CPU: the device readers find nothing to read
    assert not any(k.startswith(('device_idle', 'cin_', 'optimizer'))
                   for k in line['metrics'])
    assert line['device']['window_s'] > 0
    assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
    json.dumps(run_lib._finite(line), allow_nan=False)


def test_finite_json():
    assert run_lib._finite({'a': [math.inf, 1.0]}) == {'a': ['inf', 1.0]}


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, 'perfbench/run.py', '--workload',
         'xdeepfm_criteo_synth.serve', '--seed', '1', '--seconds', '1',
         '--trace', '0'], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ''
    assert 'no CUDA device' in proc.stderr
