"""On the card, at sizes a test run holds: the program passes the cells'
limits, the control (the reference with TF32 products in the program's
place) fails one of them, on three seeds; each fault fails too. Run with
``python -m pytest perfbench/tests -m cuda`` on a machine with a card."""

import copy

import pytest
import torch

from perfbench import proof
from perfbench.harness import compare, spec as spec_lib

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield 'cuda'
    torch.backends.cuda.matmul.allow_tf32 = saved


def small(name):
    cell = copy.deepcopy(spec_lib.cell(name))
    if cell.traffic['driver'] == 'train_fit':
        cell.traffic.update(batch_size=1024, pool_batches=4)
    else:
        cell.traffic.update(max_rows=4096, pool_rows=8192)
    return cell, spec_lib.driver(cell.traffic['driver'])


def within(readings, limits):
    return compare.all_within(compare.checks(readings, limits))


@pytest.mark.cuda
@pytest.mark.parametrize('seed', SEEDS)
def test_training_control_fails(card, seed):
    cell, driver = small('xdeepfm_criteo_synth.train')
    reading = proof.train_readings(driver, cell, seed, card, control=True)
    assert within(reading['program'], cell.limits)
    assert not within(reading['control'], cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize('fault', ['half_batch', 'unchanged_state',
                                   'cin_tile'])
def test_training_faults_fail(card, fault):
    cell, driver = small('xdeepfm_criteo_synth.train')
    reading = proof.train_readings(driver, cell, SEEDS[0], card, fault)
    assert not within(reading['program'], cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize('seed', SEEDS)
def test_serving_control_fails(card, seed):
    cell, driver = small('xdeepfm_criteo_synth.serve')
    reading = proof.serve_readings(driver, cell, seed, card, 0.5,
                                   control=True)
    assert within(reading['program'], cell.limits)
    assert not within(reading['control'], cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize('fault', ['altered_answer', 'half_rows',
                                   'cin_tile'])
def test_serving_faults_fail(card, fault):
    cell, driver = small('xdeepfm_criteo_synth.serve')
    reading = proof.serve_readings(driver, cell, SEEDS[0], card, 0.5, fault)
    assert not within(reading['program'], cell.limits)
