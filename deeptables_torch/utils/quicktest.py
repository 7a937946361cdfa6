# -*- coding:utf-8 -*-
"""Smoke-train sanity check (the port's copy of
``deeptables_tpu/utils/quicktest.py``; parity: upstream
``utils/quicktest.py:12-16``): a ``DeepTable`` fitted on a random 2-D
array and labels, on numpy alone; ``device`` as for ``DeepTable``
(``None``: the current CUDA device)."""

import numpy as np


def test(device=None):
    from ..models import deepnets, deeptable
    X = np.random.random((100, 4))
    y = np.random.randint(0, 2, 100)
    dt = deeptable.DeepTable(deeptable.ModelConfig(nets=deepnets.DeepFM),
                             device=device)
    dt.fit(X, y, verbose=0)
    return dt


if __name__ == '__main__':
    test()
