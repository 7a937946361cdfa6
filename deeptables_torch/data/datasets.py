# -*- coding:utf-8 -*-
"""Synthetic dataset generators: the port's copies of the Criteo-style and
Avazu-style loaders in ``deeptables_tpu/data/datasets.py`` (the same seed
gives bit-identical arrays). pandas is imported only where a DataFrame is
built; ``_avazu_fields`` gives the Avazu-style columns as numpy arrays
without it."""

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


def _avazu_fields(n_rows=100_000, seed=31):
    """The columns of :func:`load_avazu_synthetic` as ``(fields, click)``:
    a dict of 22 int64 arrays in the DataFrame's column order and the int8
    labels."""
    rng = np.random.default_rng(seed)
    fields = {
        'hour': rng.integers(0, 24, n_rows),
        'C1': rng.integers(0, 7, n_rows),
        'banner_pos': rng.integers(0, 7, n_rows),
        'site_id': rng.integers(0, 4000, n_rows),
        'site_domain': rng.integers(0, 5000, n_rows),
        'site_category': rng.integers(0, 25, n_rows),
        'app_id': rng.integers(0, 6000, n_rows),
        'app_domain': rng.integers(0, 500, n_rows),
        'app_category': rng.integers(0, 30, n_rows),
        'device_id': (rng.zipf(1.3, n_rows) - 1) % 200_000,
        'device_ip': (rng.zipf(1.2, n_rows) - 1) % 500_000,
        'device_model': rng.integers(0, 7000, n_rows),
        'device_type': rng.integers(0, 5, n_rows),
        'device_conn_type': rng.integers(0, 5, n_rows),
        'C14': rng.integers(0, 2500, n_rows),
        'C15': rng.integers(0, 8, n_rows),
        'C16': rng.integers(0, 9, n_rows),
        'C17': rng.integers(0, 430, n_rows),
        'C18': rng.integers(0, 4, n_rows),
        'C19': rng.integers(0, 66, n_rows),
        'C20': rng.integers(0, 170, n_rows),
        'C21': rng.integers(0, 60, n_rows),
    }
    # the planted signal, weighted toward low-vocabulary fields
    score = (0.6 * (fields['banner_pos'] == 1)
             + 0.5 * np.sin(fields['hour'] * 0.55)
             + 0.45 * np.cos(fields['C18'] * 1.3)
             + 0.4 * np.sin(fields['C1'] * 0.9)
             + 0.35 * np.sin(fields['C17'] * 0.23)
             + 0.3 * np.sin(fields['site_category'] * 0.7)
             + 0.25 * np.sin(fields['site_id'] * 0.37)
             + 0.25 * np.cos(fields['app_id'] * 0.11)
             + rng.normal(0, 0.9, n_rows))
    click = (score > np.quantile(score, 0.83)).astype(np.int8)
    return fields, click


def load_avazu_synthetic(n_rows=100_000, seed=31):
    """Avazu-style CTR data: 21 categorical fields + hour, binary 'click'
    (the first column of the DataFrame)."""
    import pandas as pd
    fields, click = _avazu_fields(n_rows, seed)
    df = pd.DataFrame(fields)
    df.insert(0, 'click', click)
    return df
