# -*- coding:utf-8 -*-
"""The port's ``serving.Predictor`` against the JAX package's, over the same
weights, on the CPU.

Both predictors are built over a plain holder of what ``Predictor`` reads
from a fitted estimator (``task``, ``preprocessor``, ``get_model``). Requests
of 1, 37 and 70 rows with buckets ``(1, 8, 64)`` cover an exact bucket, a
padded one and a request past the largest bucket. Tolerance: float32
atol 1e-5, the summation order of the two frameworks. Then the estimator
entry points, ``export_predictor``, ``Predictor.load`` and
``Predictor.predict``, over a saved ``DeepTable`` of each package.
"""

import types

import jax
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


def test_predictor_load_and_predict_match_jax(tmp_path):
    """``export_predictor``, ``Predictor.load`` and ``Predictor.predict``
    over a saved ``DeepTable`` in each package, the port's holding the JAX
    model's weights (bridged): the same probabilities (atol 1e-5) and the
    same decoded labels."""
    from deeptables_tpu.data.datasets import load_bank
    from deeptables_tpu.models import DeepTable as JaxDeepTable
    from deeptables_tpu.models import ModelConfig as JaxModelConfig
    from deeptables_torch import bridge
    from deeptables_torch.models import DeepTable, ModelConfig
    df = load_bank(300)
    y = df.pop('y')
    kwargs = dict(nets=['linear', 'dnn_nets'], metrics=['AUC'],
                  embedding_dropout=0, home_dir=str(tmp_path))
    jax_dt = JaxDeepTable(JaxModelConfig(**kwargs))
    jax_dt.fit(df, y, epochs=1, verbose=0)
    port_dt = DeepTable(ModelConfig(**kwargs), device='cpu')
    port_dt.fit(df, y, epochs=1, verbose=0)
    pre = port_dt.preprocessor
    port_dt.get_model().module.load_state_dict(bridge.state_dict_from_flax(
        jax.device_get(jax_dt.get_model().variables),
        pre.categorical_columns, pre.continuous_columns, port_dt.config))
    jax_predictor = jax_serving.Predictor.load(
        jax_serving.export_predictor(jax_dt, str(tmp_path / 'jax')),
        batch_buckets=BUCKETS)
    predictor = serving.Predictor.load(
        serving.export_predictor(port_dt, str(tmp_path / 'port')),
        device='cpu', batch_buckets=BUCKETS)
    X = df.head(70)
    np.testing.assert_allclose(predictor.predict_proba(X),
                               jax_predictor.predict_proba(X), atol=1e-5)
    np.testing.assert_array_equal(predictor.predict(X),
                                  jax_predictor.predict(X))
    np.testing.assert_array_equal(
        predictor.predict(X, encode_to_label=False),
        jax_predictor.predict(X, encode_to_label=False))
