# -*- coding:utf-8 -*-
"""Native (C++) data ingest: the port's copy of
``deeptables_tpu/data/fast_ingest.py``.

``csrc/fast_ingest.cpp`` (multithreaded Criteo-TSV and numeric-CSV parsers
writing straight into the packed batch layout) is host code, not a GPU
kernel. It is compiled at first use with the host compiler (``$CXX``, else
``g++``) into ``build/deeptables_torch/<hash>/libfast_ingest.so`` beside the
CUDA libraries of ``ops/kernels/_build.py`` (the hash covers the source,
the compiler and its flags) and loaded with ``ctypes``. Without a compiler
the parsers fall back, with a warning, to their plain Python twins
(``_parse_criteo_py``; ``columns.read_csv`` for ``parse_numeric_csv``), as
the JAX package does; ``have_native()`` says which ran.
"""

import ctypes
import glob
import io
import os
import subprocess
import threading

import numpy as np

from . import columns
from ..ops.kernels import _build
from ..ops.kernels._build import BUILD_ROOT, CSRC_DIR
from ..utils import dt_logging

logger = dt_logging.get_logger(__name__)

SOURCE = CSRC_DIR / 'fast_ingest.cpp'

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _library_path():
    return _build.host_library_path(SOURCE)


def get_library():
    """The loaded ctypes library, or None when it cannot be built."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build.build_host_library(SOURCE)))
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, 'stderr', '') or e
            logger.warning(f'native ingest unavailable ({detail}); '
                           f'falling back to Python parsing')
            _build_failed = True
            return None
        lib.parse_criteo_tsv.restype = ctypes.c_int64
        lib.parse_criteo_tsv.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.parse_numeric_csv.restype = ctypes.c_int64
        lib.parse_numeric_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        _lib = lib
    return _lib


def have_native():
    return get_library() is not None


def _n_lines(data: bytes):
    return data.count(b'\n') + (0 if data.endswith(b'\n') else 1)


def parse_criteo_tsv(data: bytes, n_dense=13, n_cat=26, hash_buckets=None,
                     n_threads=None):
    """Parse Criteo-format TSV bytes → (labels f32 (N,), dense f32
    (N, n_dense) log1p-transformed, cats int32 (N, n_cat) hashed).

    Uses the native multithreaded parser when available."""
    if hash_buckets is None:
        hash_buckets = [100_000] * n_cat
    hash_buckets = np.ascontiguousarray(hash_buckets, np.int64)
    if hash_buckets.shape != (n_cat,) or (hash_buckets < 1).any():
        raise ValueError(f'hash_buckets must be {n_cat} positive sizes, got '
                         f'{hash_buckets.tolist()}')
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    lib = get_library()
    if lib is None:
        return _parse_criteo_py(data, n_dense, n_cat, hash_buckets)
    n_lines = _n_lines(data)
    labels = np.zeros(n_lines, np.float32)
    dense = np.zeros((n_lines, n_dense), np.float32)
    cats = np.zeros((n_lines, n_cat), np.int32)
    rows = lib.parse_criteo_tsv(
        data, len(data), n_dense, n_cat,
        hash_buckets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_threads,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cats.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_lines)
    return labels[:rows], dense[:rows], cats[:rows]


def _fnv1a(token: bytes) -> int:
    h = 1469598103934665603
    for b in token:
        h ^= b
        h = (h * 1099511628211) % (1 << 64)
    return h


def _parse_criteo_py(data, n_dense, n_cat, hash_buckets):
    """The plain twin of the native parser (the same fields, hashes and
    log1p)."""
    rows = [ln for ln in data.split(b'\n') if ln.strip()]
    n = len(rows)
    labels = np.zeros(n, np.float32)
    dense = np.zeros((n, n_dense), np.float32)
    cats = np.zeros((n, n_cat), np.int32)
    for i, ln in enumerate(rows):
        parts = ln.rstrip(b'\r').split(b'\t')
        if parts and parts[0]:
            try:
                labels[i] = float(parts[0])
            except ValueError:
                pass
        for j in range(n_dense):
            k = 1 + j
            if k < len(parts) and parts[k]:
                try:
                    dense[i, j] = np.log1p(max(float(parts[k]), 0.0))
                except ValueError:
                    pass
        for j in range(n_cat):
            k = 1 + n_dense + j
            if k < len(parts) and parts[k]:
                cats[i, j] = _fnv1a(parts[k]) % int(hash_buckets[j])
    return labels, dense, cats


def parse_numeric_csv(data: bytes, n_cols: int, skip_header=True,
                      n_threads=None):
    """Parse a numeric CSV → float32 (N, n_cols) matrix (without the native
    library: ``columns.read_csv``, typed as ``pd.read_csv`` types it)."""
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    lib = get_library()
    if lib is not None:
        n_lines = _n_lines(data)
        out = np.zeros((n_lines, n_cols), np.float32)
        rows = lib.parse_numeric_csv(data, len(data), n_cols,
                                     1 if skip_header else 0, n_threads,
                                     out.ctypes.data_as(
                                         ctypes.POINTER(ctypes.c_float)),
                                     n_lines)
        return out[:rows]
    table = columns.read_csv(io.StringIO(data.decode('utf-8'), newline=''),
                             header=0 if skip_header else None)
    return columns.to_2d(table, np.float32)


class CriteoTsvSource:
    """Streaming source over Criteo-format TSV shards, native-parsed,
    yielding packed (labels, dense, cats) chunks. Each chunk is read
    ``chunk_bytes`` at a time and cut at its last newline; the partial line
    after it is carried into the next read. With ``num_hosts`` > 1 a host
    reads every ``num_hosts``-th file from ``host_id``."""

    def __init__(self, paths, n_dense=13, n_cat=26, hash_buckets=None,
                 chunk_bytes=64 << 20, host_id=0, num_hosts=1):
        if isinstance(paths, str):
            paths = sorted(glob.glob(paths)) or [paths]
        self.paths = list(paths)[host_id::num_hosts]
        self.n_dense = n_dense
        self.n_cat = n_cat
        self.hash_buckets = hash_buckets
        self.chunk_bytes = chunk_bytes

    def _parse(self, data):
        return parse_criteo_tsv(data, self.n_dense, self.n_cat,
                                self.hash_buckets)

    def iter_chunks(self):
        for path in self.paths:
            with open(path, 'rb') as f:
                carry = b''
                while True:
                    block = f.read(self.chunk_bytes)
                    if not block:
                        if carry.strip():
                            yield self._parse(carry)
                        break
                    block = carry + block
                    cut = block.rfind(b'\n')
                    if cut < 0:
                        carry = block
                        continue
                    carry = block[cut + 1:]
                    yield self._parse(block[:cut + 1])
