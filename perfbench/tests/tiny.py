"""Tiny cells of the benchmark's configurations and mixes, for the CPU
tests: the same keys, small widths, vocabularies and batches."""

import copy

from perfbench.harness import spec as spec_lib
from perfbench.harness.spec import Cell

LIMITS = {
    'train_fit': {'loss_gap': 1e-5, 'grad_gap': 1e-4, 'change_gap': 1e-3},
    'serve_closed': {'proba_gap': 1e-5},
}


def config(name='xdeepfm_criteo_synth'):
    cfg = copy.deepcopy(spec_lib.load_json(
        spec_lib.BENCH_DIR / 'configs' / f'{name}.json'))
    cfg.update(vocabulary=[7, 11, 13, 50, 3], embedding_dim=4,
               dnn_hidden_units=[16, 8])
    if 'cin_cross_layer_size' in cfg:
        cfg['cin_cross_layer_size'] = [8, 6]
    return cfg


def traffic(name):
    tr = copy.deepcopy(spec_lib.load_json(
        spec_lib.BENCH_DIR / 'traffic' / f'{name}.json'))
    if tr['driver'] == 'train_fit':
        tr.update(batch_size=64, pool_batches=4)
    else:
        tr.update(min_rows=8, max_rows=300, pool_rows=1000)
    return tr


def cell(config_name='xdeepfm_criteo_synth', traffic_name='train'):
    tr = traffic(traffic_name)
    return Cell(f'{config_name}.{traffic_name}', 1, config(config_name), tr,
                dict(LIMITS[tr['driver']]), [], [])
