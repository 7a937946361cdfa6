# -*- coding:utf-8 -*-
"""The host's CSV read rate on the shards of ``chip_smoke.py``'s
``stream_csv`` phase (four 50,000-row shards of ``load_criteo_synthetic``
in the Criteo layout, read in 25,000-row chunks). No device is used.

It times, on the CPU, one JSON line each:

- ``reader``: a chunked read of the shards by ``pandas.read_csv`` (where
  pandas imports), by ``columns.read_csv`` over a path, and by
  ``columns.read_csv`` over a text file object, which reads through the
  standard library's ``csv`` alone; each also split only, not typed;
- ``stream``: ``ChunkedSource``'s chunked read and the exact statistics
  pass (``collect_streaming_stats``) of the ``deeptables_torch`` package
  under each ``--tree`` (this checkout's, then the others), each in a
  process of its own.

Run from the root of a checkout; ``--tree`` compares another checkout's
streaming code on the same shards:

    python -m deeptables_torch.tools.csv_read_rate
    python -m deeptables_torch.tools.csv_read_rate --tree ../parent
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def _rate(name, seconds, rows, nbytes, **extra):
    return {'name': name, 's': seconds, 'rows_per_s': rows / seconds,
            'mb_per_s': nbytes / seconds / 1e6, **extra}


def _best(fn, repeats):
    """The least seconds of ``repeats`` calls of ``fn``, and its result."""
    best = None
    for _ in range(repeats):
        t = time.perf_counter()
        out = fn()
        s = time.perf_counter() - t
        best = s if best is None else min(best, s)
    return best, out


def time_readers(paths, chunk, repeats):
    from deeptables_torch.data import columns
    rows = columns.count_csv_rows
    n = sum(rows(p) for p in paths)
    nbytes = sum(os.path.getsize(p) for p in paths)

    def ours(opener, typed=True):
        def run():
            count = 0
            for p in paths:
                if not typed:
                    _names, blocks = columns._field_blocks(opener(p), 0)
                    count += sum(len(b[0]) for b in blocks)
                    continue
                for c in columns.read_csv(opener(p), chunksize=chunk):
                    count += len(c)
            return count
        return run

    def text(p):
        return open(p, newline='', encoding='utf-8')

    runs = {'numpy_splitter': ours(str), 'csv_module': ours(text),
            'numpy_splitter_split_only': ours(str, typed=False),
            'csv_module_split_only': ours(text, typed=False)}
    try:
        import pandas as pd

        def pandas_read():
            return sum(len(c) for p in paths
                       for c in pd.read_csv(p, chunksize=chunk))
        runs = {'pandas_read_csv': pandas_read, **runs}
    except ImportError:
        pass
    out = []
    for name, fn in runs.items():
        s, count = _best(fn, repeats)
        if count != n:
            raise AssertionError(f'{name} read {count} rows of {n}')
        out.append(_rate(name, s, n, nbytes))
    return out


def time_stream(paths, chunk, repeats):
    """``ChunkedSource``'s read and the statistics pass of the
    ``deeptables_torch`` that imports first on ``sys.path``."""
    import deeptables_torch
    from deeptables_torch.data.streaming import (ChunkedSource,
                                                 collect_streaming_stats)
    from deeptables_torch.models.config import ModelConfig
    nbytes = sum(os.path.getsize(p) for p in paths)
    config = ModelConfig(categorical_columns=[f'C{j}' for j in range(1, 27)])
    source = ChunkedSource(paths, chunk_size=chunk)
    read_s, n = _best(lambda: sum(len(c) for c in source.iter_chunks()),
                      repeats)
    stats_s, (_cols, _y, stats_n) = _best(
        lambda: collect_streaming_stats(source, 'label', config), repeats)
    if stats_n != n:
        raise AssertionError(f'the stats pass saw {stats_n} rows of {n}')
    tree = str(Path(deeptables_torch.__file__).resolve().parents[1])
    return [_rate('chunked_source', read_s, n, nbytes, tree=tree),
            _rate('stats_pass', stats_s, n, nbytes, tree=tree)]


def write_shards(tmp):
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from deeptables_torch.data.datasets import load_criteo_synthetic
    paths, _s = chip_smoke.write_stream_csv(tmp, load_criteo_synthetic)
    return paths['train'], chip_smoke.STREAM_CSV_CHUNK


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tree', action='append', default=[],
                        help='another checkout whose streaming code is '
                             'timed on the same shards')
    parser.add_argument('--repeats', type=int, default=3,
                        help='timed runs of each read; the least is kept')
    parser.add_argument('--worker', nargs=2, metavar=('SHARDS', 'CHUNK'),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        paths = json.loads(args.worker[0])
        for line in time_stream(paths, int(args.worker[1]), args.repeats):
            print(json.dumps({'stream': line}), flush=True)
        return 0
    with tempfile.TemporaryDirectory(prefix='csv_read_rate_') as tmp:
        paths, chunk = write_shards(tmp)
        print(json.dumps({'shards': len(paths), 'chunk': chunk,
                          'cpus': os.cpu_count(),
                          'numpy': np.__version__}), flush=True)
        for line in time_readers(paths, chunk, args.repeats):
            print(json.dumps({'reader': line}), flush=True)
        for tree in [str(ROOT)] + args.tree:
            # the tree's package first on the path, this file by its path
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [str(Path(tree).resolve())]
                + [p for p in os.environ.get('PYTHONPATH', '').split(
                    os.pathsep) if p]))
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            '--worker', json.dumps(paths), str(chunk),
                            '--repeats', str(args.repeats)],
                           env=env, check=True, cwd=tmp)
    return 0


if __name__ == '__main__':
    sys.exit(main())
