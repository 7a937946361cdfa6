# -*- coding:utf-8 -*-
"""The port's native ingest (``deeptables_torch/data/fast_ingest.py`` over
``deeptables_torch/csrc/fast_ingest.cpp``) against the JAX package's, on
the CPU. Parsing is held exactly equal: both parsers run the same integer
hashing and the same double-precision ``log1p`` rounded once to float32,
natively and in their Python twins."""

import numpy as np
import pytest

from deeptables_tpu.data import fast_ingest as jax_fi
from deeptables_torch.data import fast_ingest as fi

BUCKETS = [1000 + 7 * i for i in range(26)]


def _tsv(n, seed, n_dense=13, n_cat=26, newline='\n', last_newline=True):
    """Criteo-format lines: a label, ``n_dense`` integers (10% blank, some
    negative), ``n_cat`` tokens of 8 hex digits (10% blank); every 7th line
    cut short after a random field."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        dense = ['' if rng.random() < 0.1 else str(rng.integers(-50, 5000))
                 for _ in range(n_dense)]
        cats = ['' if rng.random() < 0.1
                else format(int(rng.integers(0, 2 ** 32)), '08x')
                for _ in range(n_cat)]
        fields = [str(rng.integers(0, 2))] + dense + cats
        if i % 7 == 3:
            fields = fields[:rng.integers(1, len(fields))]
        lines.append('\t'.join(fields))
    text = newline.join(lines) + (newline if last_newline else '')
    return text.encode()


EDGE = (b'1\t\t2\t-7\t\tab12cd34\n'        # blank fields, a negative int
        b'0\t5\n'                           # fields missing at the end
        b'1\t3\t-1\t4\t\t\tdeadbeef\r\n'   # \r\n
        b'\t9\t9\t9\t00000000\t1\t2\n'     # a blank label
        b'1\t12\t0\t4\tcafef00d\tffffffff\t0123abcd')  # no final \n


def _assert_parsed_equal(got, expected):
    for a, b, name in zip(got, expected, ('labels', 'dense', 'cats')):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_native_library_builds_in_the_ports_build_tree():
    assert fi.have_native()
    path = fi._library_path()
    assert path.is_file() and path.parent.parent == fi.BUILD_ROOT
    assert 'deeptables_tpu' not in str(path)


@pytest.mark.parametrize('case', ['edge', 'lines', 'crlf', 'no_final_nl'])
def test_parse_criteo_tsv_matches_jax_exactly(case):
    if case == 'edge':
        data, n_dense, n_cat, buckets = EDGE, 3, 3, [11, 1 << 20, 97]
    else:
        data = _tsv(300, seed=len(case), newline='\r\n' if case == 'crlf'
                    else '\n', last_newline=case != 'no_final_nl')
        n_dense, n_cat, buckets = 13, 26, BUCKETS
    expected = jax_fi.parse_criteo_tsv(data, n_dense, n_cat, buckets)
    port_native = fi.parse_criteo_tsv(data, n_dense, n_cat, buckets)
    _assert_parsed_equal(port_native, expected)
    # the Python twins agree with each other and with the native parser
    hb = np.asarray(buckets, np.int64)
    port_py = fi._parse_criteo_py(data, n_dense, n_cat, hb)
    _assert_parsed_equal(port_py, jax_fi._parse_criteo_py(data, n_dense,
                                                          n_cat, hb))
    _assert_parsed_equal(port_py, expected)
    assert len(expected[0]) == data.count(b'\n') + (not data.endswith(b'\n'))


def test_parse_criteo_tsv_edge_values():
    labels, dense, cats = fi.parse_criteo_tsv(EDGE, 3, 3, [11, 1 << 20, 97])
    assert labels.tolist() == [1, 0, 1, 0, 1]
    np.testing.assert_array_equal(dense[0], np.log1p([0., 2., 0.]).astype(
        np.float32))  # blank and negative inputs read 0
    assert (dense[1, 1:] == 0).all() and (cats[1] == 0).all()
    assert cats[0, 0] == 0 and cats[0, 2] == 0  # blank, missing tokens
    assert cats[0, 1] == fi._fnv1a(b'ab12cd34') % (1 << 20)
    assert cats[2, 2] == fi._fnv1a(b'deadbeef') % 97  # '\r' stripped
    assert fi._fnv1a(b'deadbeef') == jax_fi._fnv1a(b'deadbeef')


def test_parse_criteo_tsv_refuses_bad_buckets():
    with pytest.raises(ValueError, match='hash_buckets'):
        fi.parse_criteo_tsv(EDGE, 3, 3, [11, 0, 97])
    with pytest.raises(ValueError, match='hash_buckets'):
        fi.parse_criteo_tsv(EDGE, 3, 3, [11, 97])


@pytest.mark.parametrize('native', [True, False])
@pytest.mark.parametrize('skip_header', [True, False])
def test_parse_numeric_csv_matches_jax(native, skip_header, monkeypatch):
    data = b'a,b,c\n1,2.5,3\n4,,6\n-1.25e3,7\r\n8,9' if skip_header \
        else b'1,2.5,3\n4,,6\n-1.25e3,7,0.5\n'
    if not native:
        # the pandas fallback of both packages
        monkeypatch.setattr(fi, 'get_library', lambda: None)
        monkeypatch.setattr(jax_fi, 'get_library', lambda: None)
        data = data.replace(b'\r', b'')
    got = fi.parse_numeric_csv(data, 3, skip_header=skip_header)
    expected = jax_fi.parse_numeric_csv(data, 3, skip_header=skip_header)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.nan_to_num(got),
                                  np.nan_to_num(expected))


def test_parse_criteo_tsv_falls_back_to_python(monkeypatch):
    data = _tsv(40, seed=3)
    monkeypatch.setattr(fi, 'get_library', lambda: None)
    _assert_parsed_equal(fi.parse_criteo_tsv(data, hash_buckets=BUCKETS),
                         jax_fi.parse_criteo_tsv(data, hash_buckets=BUCKETS))


def _shards(tmp_path, sizes, last_newline=True):
    paths = []
    for i, n in enumerate(sizes):
        p = tmp_path / f'day_{i}.tsv'
        p.write_bytes(_tsv(n, seed=10 + i, last_newline=last_newline))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize('chunk_bytes', [50, 1024, 4099, 1 << 20])
@pytest.mark.parametrize('last_newline', [True, False])
def test_criteo_tsv_source_chunks_match_jax(tmp_path, chunk_bytes,
                                            last_newline):
    paths = _shards(tmp_path, (120, 75), last_newline)
    port = list(fi.CriteoTsvSource(paths, hash_buckets=BUCKETS,
                                   chunk_bytes=chunk_bytes).iter_chunks())
    ref = list(jax_fi.CriteoTsvSource(paths, hash_buckets=BUCKETS,
                                      chunk_bytes=chunk_bytes).iter_chunks())
    assert len(port) == len(ref)
    if chunk_bytes < 1 << 20:
        assert len(port) > 2  # chunk boundaries and carried lines crossed
    for a, b in zip(port, ref):
        _assert_parsed_equal(a, b)
    assert sum(len(c[0]) for c in port) == 195


@pytest.mark.parametrize('num_hosts', [1, 2, 3])
def test_criteo_tsv_source_host_shards_match_jax(tmp_path, num_hosts):
    paths = _shards(tmp_path, (10, 11, 12, 13, 14))
    pattern = str(tmp_path / 'day_*.tsv')
    seen = []
    for host in range(num_hosts):
        port = fi.CriteoTsvSource(pattern, hash_buckets=BUCKETS,
                                  host_id=host, num_hosts=num_hosts)
        ref = jax_fi.CriteoTsvSource(pattern, hash_buckets=BUCKETS,
                                     host_id=host, num_hosts=num_hosts)
        assert port.paths == ref.paths
        seen += port.paths
        for a, b in zip(port.iter_chunks(), ref.iter_chunks()):
            _assert_parsed_equal(a, b)
    assert sorted(seen) == sorted(paths)
