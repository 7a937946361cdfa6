"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
``configs/<config>.json``, each net its ``nets`` names (``nets/<net>.py``),
``traffic/<traffic>.json`` (its ``driver``: ``drivers/<driver>.py``),
``limits/<cell>.json`` and, for each per-layer metric,
``metrics/<metric>.py``. Adding a configuration, a net, a traffic mix or a
metric is adding its file and naming it in ``BENCHMARK.json`` or the
configuration."""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from .. import nets as nets_lib

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# keys of a configuration that the reference (``reference/``) computes at
# one value only: a configuration that names another is refused
ONLY = {'dnn_dropout': 0, 'l2_penalty': 0, 'dtype_policy': 'float32',
        'tf32': False}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json's entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(entries, cell_name, e2e_names=None):
    out = []
    for entry in entries:
        cells = entry.get('workloads')
        if cells is not None:
            if cell_name in cells:
                out.append(entry)
        elif e2e_names is None or entry.get('moves') in e2e_names:
            out.append(entry)
    return out


def cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    benchmark = load_json(root / 'BENCHMARK.json')
    matches = [w for w in benchmark['workloads'] if w['name'] == name]
    if len(matches) != 1:
        raise KeyError(f'BENCHMARK.json has no cell {name!r}')
    workload = matches[0]
    e2e = _reported(benchmark['end_to_end'], name)
    config = load_json(bench_dir / 'configs' / f'{workload["config"]}.json')
    for key, value in ONLY.items():
        if config.get(key, value) != value:
            raise ValueError(f'{workload["config"]}: {key} {config[key]!r}; '
                             f'the reference computes {value!r} only')
    for net in config['nets']:
        nets_lib.path(net, bench_dir / 'nets')
    return Cell(
        name=name, chips=int(workload['chips']), config=config,
        traffic=load_json(
            bench_dir / 'traffic' / f'{workload["traffic"]}.json'),
        limits=load_json(bench_dir / 'limits' / f'{name}.json'),
        end_to_end=e2e,
        per_layer=_reported(benchmark['per_layer'], name,
                            {m['name'] for m in e2e}))


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str, bench_dir: Path = BENCH_DIR):
    """``drivers/<kind>.py``: its ``run(cell, seed, seconds, trace, device,
    t0, fault=None)`` returns an ``Outcome``."""
    return _module(bench_dir / 'drivers' / f'{kind}.py',
                   f'perfbench_driver_{kind}')


def metric(name: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<name>.py``: its ``read(ctx)`` returns the metric's value,
    or None where the run holds nothing to read."""
    return _module(bench_dir / 'metrics' / f'{name}.py',
                   'perfbench_metric_' + name.replace('.', '_'))
