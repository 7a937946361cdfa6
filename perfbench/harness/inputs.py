"""Inputs from the seed, in the layout of Criteo's display-ads logs.

The recipe of the repository's Criteo-style data: each categorical column
draws Zipf(a) ids folded into its cardinality, ``(z - 1) mod vocabulary``
(a few ids carry most rows, as in the logs); each dense column is
``log1p(max(N(2, 1.5), 0))``; a label is a Bernoulli draw from a fixed
logistic model of the row (its coefficients do not depend on the seed)."""

import numpy as np

LABEL_MODEL_SEED = 2024


def rows(rng: np.random.Generator, config, n: int, zipf_a: float):
    """``(cat int32 (n, F), dense float32 (n, n_dense))``."""
    vocab = [int(v) for v in config['vocabulary']]
    cat = np.empty((n, len(vocab)), dtype=np.int32)
    for j, v in enumerate(vocab):
        cat[:, j] = (rng.zipf(zipf_a, n) - 1) % v
    dense = np.log1p(np.maximum(
        rng.normal(2.0, 1.5, (n, int(config['dense_features']))), 0))
    return cat, dense.astype(np.float32)


def labels(rng: np.random.Generator, cat, dense):
    """float32 0/1 labels of the rows."""
    fixed = np.random.default_rng(LABEL_MODEL_SEED)
    w_cat = fixed.normal(0, 0.35, cat.shape[1])
    w_dense = fixed.normal(0, 0.45, dense.shape[1])
    score = dense @ w_dense + np.sin(cat * 0.7919) @ w_cat - 1.0
    p = 1 / (1 + np.exp(-score))
    return (rng.random(len(p)) < p).astype(np.float32)


def request_sizes(lo: int, hi: int, k: int) -> np.ndarray:
    """The serving mix's sizes: ``k`` quantiles of the log-uniform law on
    ``[lo, hi]``, the same for every seed (a seed changes their order and
    the rows, not the work)."""
    q = (np.arange(k) + 0.5) / k
    return np.round(lo * (hi / lo) ** q).astype(np.int64)
