# -*- coding:utf-8 -*-
"""The port's Zipf draws (``deeptables_torch/data/datasets.py`` ``zipf``),
which give the reference tables on any numpy release.

numpy 2.0's ``Generator.zipf(a)`` is a rejection loop over the generator's
doubles, two an attempt; later releases draw ``U`` otherwise, so their
criteo- and avazu-style tables differ. The port draws the loop's attempts
in batches and redoes in Python floats (libm's ``pow``) each attempt whose
outcome an ulp of ``np.power`` could change. Checked here:

- the draws equal an in-test scalar transcription of the loop at several
  ``a`` and seeds, and leave the generator where it leaves it (the next
  doubles and 32-bit integers equal, the buffered half kept);
- where numpy is 2.0.x, they equal ``Generator.zipf`` itself;
- the vectorised attempts equal the scalar ones one by one;
- the parity tool's criteo and avazu tables hash to ``chip_smoke.py``'s
  ``ESTIMATOR_TABLES``, the digests of the tables numpy 2.0 draws.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

from deeptables_torch.data import datasets
from deeptables_torch.tools import parity_quality as pq

REPO = Path(__file__).resolve().parents[1]


def scalar_zipf(rng, a, n):
    """numpy 2.0's loop, one attempt at a time in Python floats."""
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    out = []
    while len(out) < n:
        U = 1.0 - rng.random()
        V = rng.random()
        X = math.floor(math.pow(U, -1.0 / am1))
        if X > 9.223372036854775807e18 or X < 1.0:
            continue
        T = math.pow(1.0 + 1.0 / X, am1)
        if V * X * (T - 1.0) / (b - 1.0) <= T / b:
            out.append(int(X))
    return np.array(out, dtype=np.int64)


def _pair(seed):
    """Two generators in one state, a 32-bit half buffered in each."""
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    r1.integers(0, 7, 3, dtype=np.int32)
    r2.integers(0, 7, 3, dtype=np.int32)
    return r1, r2


def _same_state(r1, r2):
    assert r1.bit_generator.state == r2.bit_generator.state
    assert r1.integers(0, 2 ** 31, 5, dtype=np.int32).tolist() == \
        r2.integers(0, 2 ** 31, 5, dtype=np.int32).tolist()
    assert r1.random(3).tolist() == r2.random(3).tolist()


@pytest.mark.parametrize('a', [1.05, 1.2, 1.3, 2.0, 3.5])
@pytest.mark.parametrize('seed', [0, 7])
def test_draws_equal_the_scalar_loop(a, seed):
    r1, r2 = _pair(seed)
    ref = scalar_zipf(r1, a, 4000)
    got = datasets.zipf(r2, a, 4000)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    _same_state(r1, r2)


@pytest.mark.skipif(not np.__version__.startswith('2.0.'),
                    reason='Generator.zipf draws the reference stream only '
                           'on numpy 2.0.x')
@pytest.mark.parametrize('a', [1.2, 1.3, 1.7])
def test_draws_equal_numpy_2_0(a):
    r1, r2 = _pair(3)
    ref = r1.zipf(a, (300, 7))
    got = datasets.zipf(r2, a, (300, 7))
    np.testing.assert_array_equal(got, ref)
    _same_state(r1, r2)


def test_vectorised_attempts_equal_scalar_ones():
    rng = np.random.default_rng(11)
    u, v = rng.random(30000), rng.random(30000)
    # attempts at the floor's and the acceptance test's boundaries too
    u[:200] = 1.0 - (np.arange(1, 201) ** -0.2)
    for a in (1.2, 1.3):
        am1 = a - 1.0
        b, e = math.pow(2.0, am1), -1.0 / am1
        got = datasets._zipf_attempts(u, v, am1, b, e)
        ref = [datasets._zipf_scalar(float(p), float(q), am1, b, e)
               for p, q in zip(u, v)]
        np.testing.assert_array_equal(got, ref)


def test_empty_and_bad_exponent():
    rng = np.random.default_rng(0)
    state = rng.bit_generator.state
    assert datasets.zipf(rng, 1.2, 0).shape == (0,)
    assert rng.bit_generator.state == state
    for a in (1.0, 0.5, 2000.0):
        with pytest.raises(ValueError, match='zipf'):
            datasets.zipf(rng, a, 3)


def test_parity_tables_hash_to_the_reference():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', REPO / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    specs = pq.configs()
    for row in ('criteo_xdeepfm', 'avazu_autoint'):
        table = specs[row]['loader']()
        assert pq.table_digest(table) == smoke.ESTIMATOR_TABLES[row]
