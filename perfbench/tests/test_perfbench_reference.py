"""The plain reference against the port's CPU path at tiny sizes, and the
TF32 control against both."""

import math

import numpy as np
import pytest
import torch

import tiny
from perfbench.harness import (compare, inputs, port, spec as spec_lib,
                               weights)
from perfbench.reference import model as ref


@pytest.mark.parametrize('name', ['deepfm_criteo_kaggle',
                                  'xdeepfm_criteo_synth'])
@pytest.mark.parametrize('training', [False, True])
def test_forward_matches_the_port(name, training):
    cfg = tiny.config(name)
    model = port.build(cfg, 7, 'cpu')
    params = weights.make(cfg, 7, 'cpu')
    port.load(model, params, cfg)
    cat, dense = inputs.rows(np.random.default_rng(3), cfg, 96, 1.2)
    got, _ = model.module(model.to_device(port.arrays(cat, dense)),
                          training=training)
    want = ref.forward(params, cfg, torch.as_tensor(cat, dtype=torch.int64),
                       torch.as_tensor(dense), training)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize('cin', [{'cin_direct': False},
                                 {'cin_direct': False,
                                  'cin_activation': 'relu'},
                                 {'cin_activation': 'relu'}])
def test_other_cin_settings_match_the_port(cin):
    """The CIN with half of each layer's maps passed on, as DeepTables'
    default builds it, and under relu."""
    cfg = dict(tiny.config('xdeepfm_criteo_synth'), **cin)
    model = port.build(cfg, 8, 'cpu')
    params = weights.make(cfg, 8, 'cpu')
    port.load(model, params, cfg)
    cat, dense = inputs.rows(np.random.default_rng(4), cfg, 64, 1.2)
    got, _ = model.module(model.to_device(port.arrays(cat, dense)),
                          training=True)
    want = ref.forward(params, cfg, torch.as_tensor(cat, dtype=torch.int64),
                       torch.as_tensor(dense), True)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize('name', ['deepfm_criteo_kaggle',
                                  'xdeepfm_criteo_synth'])
def test_first_steps_match_and_the_control_does_not(name):
    cell = tiny.cell(name, 'train')
    driver = spec_lib.driver('train_fit')
    model, probe, steps, _, _ = driver.first_steps(cell, 2 ** 31 + 9, 'cpu')
    probe.remove()
    assert len(steps.batches) == 3
    ref_steps = driver.reference(cell, 2 ** 31 + 9, 'cpu', steps.batches,
                                 'fp32')
    program, _ = driver.numbers(steps.readings(), ref_steps)
    tf32 = driver.reference(cell, 2 ** 31 + 9, 'cpu', steps.batches, 'tf32')
    control, _ = driver.numbers(tf32, ref_steps)
    assert all(v < 1e-5 for v in program.values()), program
    assert max(control[k] / max(program[k], 1e-12) for k in program) > 10
    # against the reference that judges a run (float64): the program within
    # the tiny limits, the control not
    judge = driver.reference(cell, 2 ** 31 + 9, 'cpu', steps.batches)
    limits = tiny.LIMITS['train_fit']
    within = lambda numbers: compare.all_within(compare.checks(numbers,
                                                               limits))
    assert within(driver.numbers(steps.readings(), judge)[0])
    assert not within(driver.numbers(tf32, judge)[0])


def test_tf32_round():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -(1 + 2 ** -12), 3.0e-5])
    got = ref.tf32_round(x)
    assert got[0] == 1.0 and got[1] == 1 + 2 ** -10
    assert got[2] == 1.0  # a tie rounds to even
    assert got[3] == 1 + 2 ** -9  # a tie rounds to even, up
    assert got[4] == -1.0
    bits = got.view(torch.int32)
    assert int((bits & 0x1FFF).abs().sum()) == 0


def test_dense_moments_match_the_recipe():
    mean, var = ref.dense_moments()
    x = np.log1p(np.maximum(np.random.default_rng(0).normal(2, 1.5, 10 ** 6),
                            0))
    assert abs(mean - x.mean()) < 3e-3 and abs(var - x.var()) < 3e-3


def test_float64_witness():
    cell = tiny.cell('deepfm_criteo_kaggle', 'train')
    driver = spec_lib.driver('train_fit')
    model, probe, steps, _, _ = driver.first_steps(cell, 5, 'cpu')
    probe.remove()
    fp32 = driver.reference(cell, 5, 'cpu', steps.batches, 'fp32')
    fp64 = driver.reference(cell, 5, 'cpu', steps.batches, 'fp64')
    numbers, _ = driver.numbers(fp32, fp64)
    assert 0 < max(numbers.values()) < 1e-4


@pytest.mark.parametrize('case', ['worst', 'own', 'quartile'])
def test_norm_gaps_by_worst_leaf_and_lower_quartile(case):
    # 'e' is round-off (under a thousandth of the median leaf's 1.5);
    # 'f' is small, so its gap is taken over the median leaf's norm, 2,
    # save where ``own`` takes it over its own, 0.01
    reference = {'a': 1.0, 'b': 2.0, 'c': 4.0, 'd': 8.0, 'e': 1e-9,
                 'f': 0.01}
    program = {'a': 1.001, 'b': 2.002, 'c': 4.04, 'd': 8.0, 'e': 2e-9,
               'f': 0.0103}
    moved = compare.moved_leaves(reference)
    assert moved == ['a', 'b', 'c', 'd', 'f']
    assert compare.moved_leaves(reference, 1e-10) == list(reference)
    if case == 'worst':
        assert compare.leaf_gaps(program, reference, moved) == \
            pytest.approx({'a': 5e-4, 'b': 1e-3, 'c': 0.01, 'd': 0,
                           'f': 1.5e-4})
        assert compare.norm_gap(program, reference, moved) == (
            pytest.approx(0.01), 'c')
        assert compare.norm_gap({'a': 1.0}, reference, moved)[0] == \
            math.inf
    elif case == 'own':
        assert compare.norm_gap(program, reference, moved, own=True) == (
            pytest.approx(0.03), 'f')
    else:
        # the gaps 0, 1.5e-4, 5e-4, 1e-3, 0.01: the lower quartile by
        # ``statistics.quantiles``' default lies halfway between 0 and
        # 1.5e-4
        assert compare.quartile_gap(program, reference, moved) == \
            pytest.approx(7.5e-5)
        assert compare.quartile_gap({'a': 1.0}, reference, moved) == \
            math.inf
        assert compare.quartile_gap({}, reference, moved) == math.inf