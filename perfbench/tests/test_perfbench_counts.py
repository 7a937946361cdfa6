"""The operation and byte counts against hand counts of both
configurations."""

import pytest

from perfbench.counts import bounds, flops, peaks
from perfbench.harness import readers, spec as spec_lib
from perfbench.nets import cin_nets


def config(name):
    return spec_lib.load_json(spec_lib.BENCH_DIR / 'configs' / f'{name}.json')


def test_deepfm_forward_by_hand():
    by_net = flops.forward_per_row(config('deepfm_criteo_kaggle'))
    # F=26 fields of D=10, 13 dense; concat 26·10 + 13 = 273
    assert by_net['linear'] == 26 * 10 + 2 * (26 + 13)
    assert by_net['fm_nets'] == 3 * 26 * 10 + 3 * 10
    assert by_net['dnn_nets'] == (2 * 273 * 400 + 400) + \
        2 * (2 * 400 * 400 + 400) + 2 * 400
    assert by_net['head'] == 2 + 2 + 1  # two sums of three logits, Dense
    per_row = sum(by_net.values())
    assert per_row == 861_553
    # three forwards a step at B=8192: 21.2 GFLOP
    assert flops.train_step_ops(config('deepfm_criteo_kaggle'), 8192) == \
        3 * 8192 * per_row


def test_xdeepfm_forward_by_hand():
    by_net = flops.forward_per_row(config('xdeepfm_criteo_synth'))
    layer0 = 10 * (2 * 200 * 26 * 26 + 26 * 26)  # G = F = 26
    layer1 = 10 * (2 * 200 * 26 * 200 + 26 * 200)  # G = 200, every map on
    width = 3 * 200  # every layer's maps pooled
    assert by_net['cin_nets'] == layer0 + 2 * layer1 + width * 10 + \
        2 * width + 1
    assert by_net['cin_nets'] == 44_421_961
    assert 'fm_nets' not in by_net


def test_cin_bound_by_hand():
    # K4 at the first layer's shape, float32: bytes and operations
    seconds, ops = cin_nets.cin_bound('cin_fwd', 8192, 26, 26, 128, 16, 4)
    n = 8192 * 16
    assert ops == 2 * 128 * 26 * 26 * n + 26 * 26 * n
    nbytes = 4 * (n * 26 + n * 26 + 128 * 26 * 26) + 4 * 128 * n
    assert seconds == pytest.approx(max(nbytes / 3.35e12, ops / 495e12))
    seconds, ops = cin_nets.cin_bound('cin_bwd', 8192, 26, 64, 128, 16, 2)
    assert ops == 4 * 128 * 26 * 64 * n + 5 * 26 * 64 * n
    assert seconds == pytest.approx(ops / 989e12)


def test_adam_bound_and_parameters():
    cfg = config('deepfm_criteo_kaggle')
    table = (33_762_577 + 26) * 10
    others = 2 * 13 + 2 * 273 + 39 + (273 * 400 + 400) + \
        2 * (400 * 400 + 400) + 400 + 2
    assert readers.n_params(cfg) == table + others
    assert bounds.adam_bound(table + others) == pytest.approx(
        28 * (table + others) / 3.35e12)
    # 9.5 GB of traffic a step: 2.8 ms at HBM bandwidth
    assert 2.8e-3 < bounds.adam_bound(table + others) < 2.9e-3


def test_peaks():
    assert peaks.tensor_core_peak('float32') == 495e12
    assert peaks.tensor_core_peak('bfloat16') == 989e12
