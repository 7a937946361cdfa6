# -*- coding:utf-8 -*-
"""Out-of-core streaming input pipeline: the port's copy of
``deeptables_tpu/data/streaming.py``.

Trains on datasets larger than host memory by streaming file shards: a
chunked reader over CSV/Parquet shards (or in-memory tables), a
preprocessor fitted on exact one-pass statistics (or a bounded sample), and
a loader that transforms the next chunk on a worker thread while the model
trains on the current one. With ``num_hosts`` > 1 each host reads a
disjoint subset of the files.

Chunks are named numpy columns (``data.columns.Columns``): CSV is read by
``columns.read_csv``, which types each chunk as ``pd.read_csv`` does, and
Parquet by ``columns.read_parquet`` (``data/parquet.py``), which reads a
file as ``pd.read_parquet`` does, so the module needs neither pandas,
pyarrow nor scikit-learn.
"""

import collections
import concurrent.futures
import glob as _glob
from typing import Iterator, Optional

import numpy as np

from . import columns as cl
from . import parquet, pipeline
from ..utils import dt_logging

logger = dt_logging.get_logger(__name__)


class ChunkedSource:
    """Iterate (host-sharded) CSV/Parquet files — or in-memory tables (a
    DataFrame, a dict of 1-D arrays, ``Columns``) — as ``Columns`` chunks.
    A table keeps its kinds exactly (bool, Categorical), matching what the
    in-memory fit path would see."""

    def __init__(self, paths, chunk_size: int = 100_000,
                 host_id: int = 0, num_hosts: int = 1):
        if isinstance(paths, str):
            paths = sorted(_glob.glob(paths)) or [paths]
        elif isinstance(paths, (dict, cl.Columns)) or cl.is_frame(paths):
            paths = [paths]
        self.paths = list(paths)
        if num_hosts > 1:
            # per-host disjoint file shards (multi-host data loading)
            self.paths = self.paths[host_id::num_hosts]
        self.chunk_size = chunk_size

    def iter_chunks(self) -> Iterator[cl.Columns]:
        for path in self.paths:
            if isinstance(path, str) and not path.endswith('.parquet'):
                yield from cl.read_csv(path, chunksize=self.chunk_size)
                continue
            table = cl.read_parquet(path) if isinstance(path, str) \
                else cl.as_columns(path, rename=False)
            for s in range(0, len(table), self.chunk_size):
                yield table.take(np.arange(s, min(s + self.chunk_size,
                                                  len(table))))

    def n_rows(self) -> int:
        """The rows ``iter_chunks`` yields: CSV rows counted without being
        typed, a Parquet file's from its footer, a table's rows by its
        length."""
        total = 0
        for path in self.paths:
            if isinstance(path, dict):
                total += len(cl.as_columns(path, rename=False))
            elif not isinstance(path, str):
                total += len(path)
            elif path.endswith('.parquet'):
                total += parquet.num_rows(path)
            else:
                total += cl.count_csv_rows(path)
        return total

    def sample(self, n_rows: int) -> cl.Columns:
        """First-n sample used to fit the preprocessor (bounded memory)."""
        parts = []
        total = 0
        for chunk in self.iter_chunks():
            parts.append(chunk)
            total += len(chunk)
            if total >= n_rows:
                break
        if not parts:
            raise ValueError('source produced no data')
        sample = cl.concat(parts)
        return sample.take(np.arange(min(n_rows, len(sample))))


class StreamingDataLoader:
    """Stream (batch, y, w, valid) tuples from a chunked source through a
    fitted preprocessor, with one chunk of lookahead prefetched on a worker
    thread (the analog of upstream's ThreadPoolExecutor(2) prefetch,
    ``dataset_generator.py:177``).

    Implements the same protocol as ``pipeline.BatchIterator`` (iteration +
    ``steps``), so ``DeepModel.fit`` accepts it directly as ``X``.
    """

    def __init__(self, source: ChunkedSource, preprocessor, target: str,
                 batch_size: int = 512, shuffle_chunks: bool = True,
                 shuffle_in_chunk: bool = True, drop_remainder: bool = True,
                 pad_multiple: int = 1, steps_per_epoch: Optional[int] = None,
                 seed: int = 0, fold_spec=None):
        self.source = source
        self.preprocessor = preprocessor
        self.target = target
        self.batch_size = batch_size
        self.shuffle_chunks = shuffle_chunks
        self.shuffle_in_chunk = shuffle_in_chunk
        self.drop_remainder = drop_remainder
        self.pad_multiple = pad_multiple
        self._steps_per_epoch = steps_per_epoch
        self.seed = seed
        self._epoch = 0
        # out-of-core k-fold split (the analog of upstream's Dask CV
        # index-range split, deeptable.py:416-426): ``(num_folds, fold,
        # role)`` keeps rows whose global stream position % num_folds
        # == fold ('valid') or != fold ('train').
        if fold_spec is not None:
            num_folds, fold, role = fold_spec
            if role not in ('train', 'valid'):
                raise ValueError(f'fold role must be train|valid: {role!r}')
            if not 0 <= fold < num_folds:
                raise ValueError(f'fold {fold} out of range({num_folds})')
        self.fold_spec = fold_spec

    def _fold_mask(self, n, base):
        num_folds, fold, role = self.fold_spec
        pos = np.arange(base, base + n)
        in_fold = (pos % num_folds) == fold
        return in_fold if role == 'valid' else ~in_fold

    @property
    def steps(self):
        if self._steps_per_epoch is None:
            # one counting pass (cheap: row counts only)
            total = self.source.n_rows()
            if self.fold_spec is not None:
                num_folds, _f, role = self.fold_spec
                frac = 1.0 / num_folds
                total = int(total * (frac if role == 'valid' else 1 - frac))
            self._steps_per_epoch = max(total // self.batch_size, 1)
        return self._steps_per_epoch

    def _chunk_to_batches(self, chunk: cl.Columns, shuffle_seed,
                          base_offset=0):
        if self.fold_spec is not None:
            chunk = chunk.take(np.flatnonzero(
                self._fold_mask(len(chunk), base_offset)))
            if len(chunk) == 0:
                return []
        y_raw = chunk[self.target]
        X = chunk.drop(columns=[self.target])
        X_t = self.preprocessor.transform_X(X)
        y_t = self.preprocessor.transform_y(y_raw)
        arrays = pipeline.extract_arrays(
            X_t, self.preprocessor.categorical_columns,
            self.preprocessor.continuous_columns,
            self.preprocessor.var_len_categorical_columns)
        labels = self.preprocessor.labels
        num_classes = len(labels) if labels is not None else 0
        y_arr = pipeline.prepare_labels(y_t, self.preprocessor.task,
                                        num_classes)
        it = pipeline.BatchIterator(
            arrays, y_arr, None, batch_size=self.batch_size,
            shuffle=self.shuffle_in_chunk,
            drop_remainder=self.drop_remainder,
            pad_multiple=self.pad_multiple,
            seed=shuffle_seed)
        return list(it)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        chunks = self.source.iter_chunks()

        # pipeline: transform the next chunk on a worker thread while the
        # trainer consumes batches of the current one
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            pending = None
            offset = 0
            for chunk in chunks:
                # draw the shuffle seed HERE (main thread, submission
                # order): consuming the shared Generator inside the
                # worker raced between overlapping futures, making
                # same-process epoch order nondeterministic
                seed = int(rng.integers(0, 2 ** 31))
                fut = pool.submit(self._chunk_to_batches, chunk, seed,
                                  offset)
                offset += len(chunk)
                if pending is not None:
                    for item in pending.result():
                        yield item
                pending = fut
            if pending is not None:
                for item in pending.result():
                    yield item


class ColumnStats:
    """Streaming sufficient statistics for one column (one pass).

    Exact: dtype resolution, row/non-null counts, unique values (uncapped
    for categorical-dtype columns — the embedding vocabulary needs them all
    anyway), has-NaN flag, sum/min/max of numeric values, and a
    value→count table for quantile binning.  When a numeric column's
    distinct count exceeds ``vc_cap`` the value-count table degrades to a
    bounded uniform reservoir (bottom-k sketch) and quantile bins become
    sketch-based (logged).
    """

    def __init__(self, unique_cap=2_000_000, vc_cap=200_000,
                 reservoir_size=100_000, seed=0):
        self.unique_cap = unique_cap
        self.vc_cap = vc_cap
        self.reservoir_size = reservoir_size
        self._rng = np.random.default_rng(seed)
        self.dtypes = set()
        self.string_fill = False
        self.has_nan = False
        self.uniques = set()
        self.unique_overflow = False
        self.n_nonnull_num = 0
        self.sum_ = 0.0
        self.min_ = np.inf
        self.max_ = -np.inf
        self.vc: dict = {}
        self.vc_overflow = False
        self._res_keys = None
        self._res_vals = None
        # var-len extras (filled only for configured var-len columns)
        self.tokens = None
        self.max_token_len = 0

    @property
    def resolved_dtype(self) -> str:
        if any(_is_cat_dtype(d) for d in self.dtypes):
            return 'object'
        if any(d.startswith('float') for d in self.dtypes):
            return 'float64'
        return 'int64'

    @property
    def is_categorical_dtype(self) -> bool:
        return self.resolved_dtype == 'object'

    @property
    def wants_string_fill(self) -> bool:
        """Whether the constant imputer fill must be ``''`` (string-like
        values seen) rather than ``0``.  Mirrors the in-memory rule
        (``preprocessor._imputer_wants_string_fill``): bool and
        numeric-coded Categorical chunks take the numeric fill even though
        ``resolved_dtype`` reports them as 'object'.  Falls back to the
        resolved dtype for stats pickled before this field existed."""
        return getattr(self, 'string_fill', self.resolved_dtype == 'object')

    @property
    def nunique(self) -> int:
        return len(self.uniques) if not self.unique_overflow \
            else self.unique_cap

    @property
    def mean(self) -> float:
        return self.sum_ / self.n_nonnull_num if self.n_nonnull_num else 0.0

    def update(self, col, kind: str, var_len_sep: Optional[str] = None):
        """Add one chunk's column: its values and its kind (``Columns``)."""
        is_category = kind.startswith('category[')
        self.dtypes.add('category' if is_category else kind)
        # record the imputer fill kind from the ACTUAL chunk dtype (a
        # Categorical resolves via its categories' dtype) — see
        # wants_string_fill
        base = (kind[len('category['):-1] if is_category else kind).lower()
        if base.startswith(('object', 'str')):
            self.string_fill = True
        missing = cl.isna(col)
        nonnull = col[~missing]
        if len(nonnull) < len(col):
            self.has_nan = True
        if not self.unique_overflow:
            self.uniques.update(cl.unique(nonnull))
            if len(self.uniques) > self.unique_cap \
                    and not self.is_categorical_dtype:
                # numeric high-cardinality: only the count bound is needed
                self.unique_overflow = True
                self.uniques = set()
        if var_len_sep is not None:
            if self.tokens is None:
                self.tokens = set()
            for v in cl.as_str(nonnull):
                parts = [p for p in v.split(var_len_sep) if p != '']
                self.tokens.update(parts)
                self.max_token_len = max(self.max_token_len, len(parts))
            return
        if self.is_categorical_dtype:
            return
        arr = cl.to_float(nonnull)
        arr = arr[~np.isnan(arr)]
        if arr.size:
            self.n_nonnull_num += arr.size
            self.sum_ += float(arr.sum())
            self.min_ = min(self.min_, float(arr.min()))
            self.max_ = max(self.max_, float(arr.max()))
            self._update_vc(arr)

    def _update_vc(self, arr):
        if not self.vc_overflow:
            uq, cnt = np.unique(arr, return_counts=True)
            for v, c in zip(uq, cnt):
                self.vc[v] = self.vc.get(v, 0) + int(c)
            if len(self.vc) > self.vc_cap:
                # degrade to a bounded uniform sample of the values
                vals = np.fromiter(self.vc.keys(), np.float64, len(self.vc))
                cnts = np.fromiter(self.vc.values(), np.float64, len(self.vc))
                take = self._rng.choice(
                    vals, size=self.reservoir_size, p=cnts / cnts.sum())
                self._res_keys = self._rng.random(self.reservoir_size)
                self._res_vals = take
                self.vc_overflow = True
                self.vc = {}
        else:
            keys = np.concatenate([self._res_keys,
                                   self._rng.random(arr.size)])
            vals = np.concatenate([self._res_vals, arr])
            order = np.argsort(keys)[:self.reservoir_size]
            self._res_keys, self._res_vals = keys[order], vals[order]

    def quantile_distribution(self, impute_value=None, scale=None):
        """(sorted values, counts) of the post-imputation (and optionally
        min-max scaled) distribution for quantile binning."""
        if not self.vc_overflow:
            vc = dict(self.vc)
        else:
            uq, cnt = np.unique(self._res_vals, return_counts=True)
            vc = dict(zip(uq.tolist(), cnt.tolist()))
        if impute_value is not None and getattr(self, 'n_nan', 0):
            # NaNs were replaced by the impute value during transform
            vc[impute_value] = vc.get(impute_value, 0) + self.n_nan
        values = np.array(sorted(vc), np.float64)
        counts = np.array([vc[v] for v in sorted(vc)], np.int64)
        if scale is not None:
            mn, sc = scale
            values = (values - mn) * sc
        return values, counts


def _is_cat_dtype(d: str) -> bool:
    d = d.lower()
    return d.startswith(('object', 'str', 'category', 'bool'))


class YStats:
    def __init__(self):
        self.uniques = set()
        self.n_rows = 0
        self.dtypes = set()

    def update(self, y):
        if cl.isna(y).any():
            raise ValueError('Missing values in y.')
        self.uniques.update(cl.unique(y))
        self.n_rows += len(y)
        self.dtypes.add(y.dtype.kind)


def collect_streaming_stats(source: ChunkedSource, target: str, config,
                            unique_cap=2_000_000, vc_cap=200_000,
                            reservoir_size=100_000, seed=0):
    """One pass over the stream: per-column sufficient statistics + y stats.

    Returns ``(col_stats: OrderedDict[str, ColumnStats], y_stats, n_rows)``.
    """
    var_len_seps = {}
    for v in (config.var_len_categorical_columns or ()):
        var_len_seps[v[0]] = v[1]
    col_stats = collections.OrderedDict()
    y_stats = YStats()
    n_rows = 0
    nan_counts = {}
    for chunk in source.iter_chunks():
        y_stats.update(chunk[target])
        X = chunk.drop(columns=[target])
        n_rows += len(X)
        for c in X.columns:
            st = col_stats.get(c)
            if st is None:
                st = col_stats[c] = ColumnStats(
                    unique_cap=unique_cap, vc_cap=vc_cap,
                    reservoir_size=reservoir_size, seed=seed)
            st.update(X[c], X.kinds[c], var_len_sep=var_len_seps.get(c))
            nan_counts[c] = nan_counts.get(c, 0) + int(cl.isna(X[c]).sum())
    for c, st in col_stats.items():
        st.n_nan = nan_counts.get(c, 0)
    return col_stats, y_stats, n_rows


def fit_preprocessor_streaming(preprocessor, source: ChunkedSource,
                               target: str, sample_rows: int = 500_000,
                               exact: bool = True):
    """Fit a DefaultPreprocessor over an out-of-core stream.

    ``exact=True`` (default): a one-pass statistics collection
    (:func:`collect_streaming_stats`) followed by
    :meth:`DefaultPreprocessor.fit_from_stats` — vocabularies, imputation
    means, min/max and quantile bins match an in-memory ``fit_transform``
    over the concatenated stream (quantile bins degrade to a bounded sketch
    only above ``vc_cap`` distinct values; logged), as the upstream Dask
    preprocessor's exact cluster statistics
    (``deeptables/models/preprocessor.py:518-598``).

    ``exact=False`` (or configs needing trained sub-models, i.e.
    ``apply_gbm_features``): fit on the first ``sample_rows`` rows.
    """
    if exact and not preprocessor.config.apply_gbm_features:
        col_stats, y_stats, n_rows = collect_streaming_stats(
            source, target, preprocessor.config)
        preprocessor.fit_from_stats(col_stats, y_stats, n_rows)
        return preprocessor
    if exact:
        logger.info('apply_gbm_features needs a trained GBM; falling back '
                    'to the sample-based streaming fit.')
    sample = source.sample(sample_rows)
    y = sample[target]
    X = sample.drop(columns=[target])
    preprocessor.fit_transform(X, y)
    return preprocessor
