# -*- coding:utf-8 -*-
"""Synthetic dataset generators (the port's copy of the Criteo-style loader in
``deeptables_tpu/data/datasets.py``; the same seed gives bit-identical
arrays)."""

import numpy as np


def load_criteo_synthetic(n_rows=100_000, n_cat=26, n_dense=13,
                          max_vocab=100_000, seed=2024, return_arrays=False):
    """Criteo-display-ads-style CTR data: ``n_dense`` numeric columns
    I1..I13 and ``n_cat`` hashed categorical columns C1..C26 with a
    long-tailed (Zipf) vocabulary, binary 'label'.

    ``return_arrays=True`` skips the DataFrame and returns
    ``(cat int32 (n, n_cat), dense float32 (n, n_dense), y float32,
    vocab_sizes)``; only the DataFrame branch imports pandas.
    """
    rng = np.random.default_rng(seed)
    vocab_sizes = np.minimum(
        (np.logspace(1, np.log10(max_vocab), n_cat)).astype(np.int64),
        max_vocab)
    cat = np.empty((n_rows, n_cat), dtype=np.int64)
    for j, v in enumerate(vocab_sizes):
        z = rng.zipf(1.2, size=n_rows)
        cat[:, j] = (z - 1) % v
    dense = np.maximum(rng.normal(2.0, 1.5, (n_rows, n_dense)), 0)
    dense = np.log1p(dense).astype(np.float32)
    w_cat = rng.normal(0, 0.35, n_cat)
    w_dense = rng.normal(0, 0.45, n_dense)
    score = (dense @ w_dense
             + np.sum(np.sin(cat * 0.7919) * w_cat, axis=1)
             + rng.normal(0, 1.0, n_rows))
    y = (score > np.quantile(score, 0.75)).astype(np.int8)
    if return_arrays:
        return (cat.astype(np.int32), dense, y.astype(np.float32),
                vocab_sizes.astype(np.int64))
    import pandas as pd
    df = pd.DataFrame({'label': y})
    for j in range(n_dense):
        df[f'I{j + 1}'] = dense[:, j]
    for j in range(n_cat):
        df[f'C{j + 1}'] = cat[:, j]
    return df
