# -*- coding:utf-8 -*-
"""Criteo-scale streaming: the native TSV parser
(``fast_ingest.CriteoTsvSource``) into the training loop (the port's copy of
``deeptables_tpu/data/criteo.py``). Packed (labels, dense, cats) chunks
become shuffled batches of a fixed shape, with one chunk of lookahead on a
worker thread. Needs numpy only: it runs on the card's machine.
"""

import concurrent.futures
from typing import Optional, Sequence

import numpy as np

from .fast_ingest import CriteoTsvSource
from ..models.metainfo import CategoricalColumn, ContinuousColumn

CAT_KEY = 'cat'
DENSE_KEY = 'input_continuous_all'


def criteo_columns(hash_buckets: Sequence[int], emb_dim: int = 16,
                   n_dense: int = 13):
    """(categorical_columns, continuous_columns) for a hashed Criteo schema."""
    cats = tuple(CategoricalColumn(f'C{i + 1}', int(b), emb_dim)
                 for i, b in enumerate(hash_buckets))
    conts = (ContinuousColumn(DENSE_KEY,
                              [f'I{i + 1}' for i in range(n_dense)]),)
    return cats, conts


class CriteoStreamLoader:
    """Batch source over Criteo TSV shards for ``DeepModel.fit``: yields
    ``(batch, y, weight, valid)`` as ``pipeline.BatchIterator`` does.

    Each chunk is shuffled on its own (``shuffle``), cut into batches of
    ``batch_size`` (its last partial batch dropped with
    ``drop_remainder``), and a batch whose length is no multiple of
    ``pad_multiple`` is padded with zero-weight rows. An epoch draws from
    ``np.random.default_rng(seed + epoch)``. Each chunk's permutation is
    drawn on the iterating thread, in the order the chunks were read; the
    worker only gathers the batches. The JAX package shuffles inside its
    pool's workers from the shared generator, so two chunks in flight can
    draw in either order; the port's batches are the JAX package's whenever
    its chunks draw in reading order."""

    def __init__(self, source: CriteoTsvSource, batch_size: int = 8192,
                 shuffle: bool = True, drop_remainder: bool = True,
                 pad_multiple: int = 1,
                 steps_per_epoch: Optional[int] = None, seed: int = 0):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.pad_multiple = max(pad_multiple, 1)
        self._steps = steps_per_epoch
        self.seed = seed
        self._epoch = 0

    @property
    def steps(self):
        """Batches an epoch: ``steps_per_epoch``, else one parsing pass over
        every shard."""
        if self._steps is None:
            total = 0
            for labels, _, _ in self.source.iter_chunks():
                total += len(labels)
            self._steps = max(total // self.batch_size, 1)
        return self._steps

    def _chunk_batches(self, chunk, idx):
        """The batches of one chunk in the row order ``idx``."""
        labels, dense, cats = chunk
        n = len(labels)
        out = []
        bs = self.batch_size
        n_full = n // bs if self.drop_remainder else -(-n // bs)
        for s in range(max(n_full, 0)):
            sel = idx[s * bs:(s + 1) * bs]
            valid = len(sel)
            pad = 0
            if valid % self.pad_multiple != 0:
                pad = self.pad_multiple - valid % self.pad_multiple
                sel = np.concatenate([sel, np.zeros(pad, sel.dtype)])
            batch = {CAT_KEY: cats[sel], DENSE_KEY: dense[sel]}
            yb = labels[sel]
            wb = None
            if pad > 0:
                wb = np.ones(len(sel), np.float32)
                wb[valid:] = 0.0
            out.append((batch, yb, wb, valid))
        return out

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            pending = None
            for chunk in self.source.iter_chunks():
                idx = np.arange(len(chunk[0]))
                if self.shuffle:
                    rng.shuffle(idx)
                fut = pool.submit(self._chunk_batches, chunk, idx)
                if pending is not None:
                    yield from pending.result()
                pending = fut
            if pending is not None:
                yield from pending.result()
