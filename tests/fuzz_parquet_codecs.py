# -*- coding:utf-8 -*-
"""Fuzz the native BROTLI decoder (``deeptables_torch/csrc/parquet_codecs.cpp``)
under AddressSanitizer and UndefinedBehaviorSanitizer.

Pages are BROTLI streams pyarrow writes at every level from a corpus
(text, dictionary words, columns of numbers, random bytes), then cut
short, with bytes or bits changed, or given a smaller or larger output
buffer than their size. A program that includes the decoder's source is
built with ``-fsanitize=address,undefined`` and decodes every page into a
buffer of exactly the stated size; any sanitizer report fails the run.
Not part of the test suite (it takes a minute); run it on a host with g++
and pyarrow:

    python tests/fuzz_parquet_codecs.py --pages 6000 --seed 0

It prints one JSON line: the pages decoded, how many decoded and how many
were refused, and whether a sanitizer reported.
"""

import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / 'deeptables_torch' / 'csrc' / 'parquet_codecs.cpp'
DICTIONARY = REPO / 'deeptables_torch' / 'csrc' / 'brotli_dictionary.zlib'

RUNNER = r'''
#include "parquet_codecs.cpp"
#include <cstdlib>
#include <fstream>
#include <iterator>
#include <vector>

int main(int argc, char** argv) {
    std::ifstream d(argv[1], std::ios::binary);
    std::vector<uint8_t> words((std::istreambuf_iterator<char>(d)), {});
    if (pq_brotli_set_dictionary(words.data(), (int64_t)words.size()) != 0)
        return 2;
    std::ifstream in(argv[2], std::ios::binary);
    std::vector<uint8_t> all((std::istreambuf_iterator<char>(in)), {});
    size_t at = 0, ok = 0, refused = 0;
    char err[256];
    while (at + 16 <= all.size()) {
        uint64_t cap, len;
        std::memcpy(&cap, &all[at], 8);
        std::memcpy(&len, &all[at + 8], 8);
        at += 16;
        // exactly sized heap buffers, so that any overrun is reported
        uint8_t* src = (uint8_t*)std::malloc(len ? len : 1);
        uint8_t* dst = (uint8_t*)std::malloc(cap ? cap : 1);
        std::memcpy(src, &all[at], len);
        at += len;
        int64_t got = pq_brotli_decompress(src, (int64_t)len, dst,
                                           (int64_t)cap, err, sizeof(err));
        if (got < 0) ++refused; else ++ok;
        std::free(src);
        std::free(dst);
    }
    std::printf("%zu %zu\n", ok, refused);
    return 0;
}
'''


def corpus(rs):
    words = zlib.decompress(DICTIONARY.read_bytes())
    text = b' '.join(words[i:i + rs.randint(4, 12)]
                     for i in rs.randint(0, len(words) - 12, 3000))
    return [
        text, text.upper(), b'abc' * 2000,
        ' '.join(f'word{v}' for v in rs.randint(0, 500, 2000)).encode(),
        rs.randint(0, 40, 5000).astype('<i4').tobytes(),
        rs.randn(3000).astype('<f8').tobytes(), rs.bytes(6000),
        'ünïcödé — “quotes” ÀÉÎ'.encode() * 200, b'x']


def pages(n, seed):
    """(capacity, page) pairs: streams, changed and cut short."""
    import pyarrow as pa
    rs = np.random.RandomState(seed)
    streams = [(len(raw), pa.Codec('brotli', compression_level=level)
                .compress(raw, asbytes=True))
               for raw in corpus(rs) for level in range(12)]
    out = []
    while len(out) < n:
        size, page = streams[rs.randint(len(streams))]
        kind = rs.randint(5)
        if kind == 0:
            page = page[:rs.randint(0, len(page))]
        elif kind == 1:
            bad = bytearray(page)
            for _ in range(rs.randint(1, 5)):
                bad[rs.randint(len(bad))] ^= rs.randint(1, 256)
            page = bytes(bad)
        elif kind == 2:
            bad = bytearray(page)
            i = rs.randint(len(bad) * 8)
            bad[i // 8] ^= 1 << (i % 8)
            page = bytes(bad)
        elif kind == 3:
            page = page[:1] + rs.bytes(rs.randint(0, 200))
        cap = size if kind != 4 else max(0, size + rs.choice([-1, -7, 7]))
        out.append((cap, page))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--pages', type=int, default=6000)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    with tempfile.TemporaryDirectory(prefix='fuzz_codecs_') as tmp:
        runner = Path(tmp) / 'runner.cpp'
        runner.write_text(RUNNER)
        exe = Path(tmp) / 'runner'
        subprocess.run([os.environ.get('CXX', 'g++'), '-std=c++17', '-O1',
                        '-g', '-fsanitize=address,undefined',
                        '-fno-sanitize-recover=all', f'-I{SOURCE.parent}',
                        str(runner), '-o', str(exe)], check=True)
        words = Path(tmp) / 'dictionary.bin'
        words.write_bytes(zlib.decompress(DICTIONARY.read_bytes()))
        data = Path(tmp) / 'pages.bin'
        todo = pages(args.pages, args.seed)
        with open(data, 'wb') as f:
            for cap, page in todo:
                f.write(struct.pack('<QQ', cap, len(page)) + page)
        proc = subprocess.run([str(exe), str(words), str(data)],
                              capture_output=True, text=True)
    report = 'Sanitizer' in proc.stderr or 'runtime error' in proc.stderr
    ok, refused = (map(int, proc.stdout.split()) if proc.returncode == 0
                   else (0, 0))
    print(json.dumps({'pages': len(todo), 'decoded': ok, 'refused': refused,
                      'returncode': proc.returncode,
                      'sanitizer_report': report}))
    if report or proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
