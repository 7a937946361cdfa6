# -*- coding:utf-8 -*-
"""The port's ``serving.Predictor`` against the JAX package's, over the same
weights, on the CPU.

Both predictors are built over a plain holder of what ``Predictor`` reads
from a fitted estimator (``task``, ``preprocessor``, ``get_model``). Requests
of 1, 37 and 70 rows with buckets ``(1, 8, 64)`` cover an exact bucket, a
padded one and a request past the largest bucket. Tolerance: float32
atol 1e-5, the summation order of the two frameworks.
"""

import types

import numpy as np
import pytest

from deeptables_tpu import serving as jax_serving
from deeptables_torch import serving
from deeptables_torch.ops.kernels import fm as fm_module
from torch_parity import Case

BUCKETS = (1, 8, 64)


def _holder(model):
    return types.SimpleNamespace(task='binary', preprocessor=None,
                                 get_model=lambda selector: model)


@pytest.fixture(scope='module')
def case():
    case = Case('nonascending_d16')
    case.jax_predictor = jax_serving.Predictor(_holder(case.jax_model),
                                               batch_buckets=BUCKETS)
    case.predictor = serving.Predictor(_holder(case.port_model()),
                                       batch_buckets=BUCKETS)
    return case


@pytest.mark.parametrize('n', [1, 37, 70])
def test_predict_proba_arrays_matches_jax(case, n):
    arrays = case.batch(n, seed=n)
    expected = case.jax_predictor.predict_proba_arrays(arrays)
    proba = case.predictor.predict_proba_arrays(arrays)
    assert proba.shape == expected.shape == (n, 2)
    np.testing.assert_allclose(proba, expected, atol=1e-5)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-6)


def test_buckets_match_jax(case):
    assert case.predictor.buckets == case.jax_predictor.buckets
    for n in range(1, 200):
        assert case.predictor._bucket_for(n) == \
            case.jax_predictor._bucket_for(n)
    assert serving.DEFAULT_BUCKETS == jax_serving.DEFAULT_BUCKETS


def test_warmup_runs_every_bucket_without_a_kernel_on_cpu(case):
    before = fm_module.fm.launches
    assert case.predictor.warmup() is case.predictor
    assert fm_module.fm.launches == before


@pytest.mark.parametrize('proba', [np.array([0.25, 0.5]),
                                   np.array([[0.25], [0.5]])])
def test_fix_binary_predict_proba_result(proba):
    from deeptables_tpu.models.deeptable import \
        fix_binary_predict_proba_result as jax_fix
    np.testing.assert_array_equal(
        serving.fix_binary_predict_proba_result(proba), jax_fix(proba))
