# -*- coding:utf-8 -*-
"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``deeptables_torch/csrc/*.cu`` becomes a shared library of its own with
a plain C interface, compiled for Hopper (``sm_90a``) into
``build/deeptables_torch/<hash>/lib<name>.so`` at the root of the checkout.
The hash covers every source, header and flag, so an edited source builds
anew and an unchanged one loads from the cache. All sources that need a
build compile at once, one ``nvcc`` process each; the compiler's report
(registers, shared memory, spills from ``-Xptxas -v``) is kept beside each
library as ``lib<name>.log``.

Nothing here runs at import: the first kernel launch calls :func:`library`.
A build that fails raises with the compiler's output.

The host C++ sources (``csrc/*.cpp``: the native ingest parsers, the GBM
tree grower) are built by :func:`build_host_library` with ``$CXX`` (else
``g++``) into ``build/deeptables_torch/<hash>/lib<name>.so`` the same way,
the hash covering the source, the compiler and its flags.
"""

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_ROOT = PACKAGE_DIR.parent / 'build' / 'deeptables_torch'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [Path(home) / 'bin' / 'nvcc'] if home else []
    on_path = shutil.which('nvcc')
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        'nvcc was not found (looked in $CUDA_HOME/bin, PATH and the '
        'default toolkit location); the CUDA toolkit is needed to build '
        'the kernels of deeptables_torch.')


def sources():
    return sorted(CSRC_DIR.glob('*.cu'))


def build_dir() -> Path:
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob('*.cu')) + sorted(CSRC_DIR.glob('*.cuh')):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet; return the directory.

    A library is written under a temporary name and renamed into place, so
    a process that loads it never sees a half-written file."""
    with _lock:
        out_dir = build_dir()
        todo = [src for src in sources()
                if not (out_dir / f'lib{src.stem}.so').is_file()]
        if not todo:
            return out_dir
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        jobs = []
        for src in todo:
            tmp = out_dir / f'lib{src.stem}.so.{os.getpid()}.tmp'
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, tmp, proc))
        failures = []
        for src, tmp, proc in jobs:
            log, _ = proc.communicate()
            (out_dir / f'lib{src.stem}.log').write_text(log)
            if proc.returncode != 0:
                failures.append(f'{src.name} (exit {proc.returncode}):\n{log}')
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out_dir / f'lib{src.stem}.so')
        if failures:
            raise RuntimeError('nvcc failed to build '
                               + '\n'.join(failures))
        return out_dir


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    path = build_all() / f'lib{name}.so'
    if not path.is_file():
        raise FileNotFoundError(f'no CUDA source csrc/{name}.cu to build')
    return ctypes.CDLL(str(path))


HOST_CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-pthread')


def host_compiler():
    return shlex.split(os.environ.get('CXX') or 'g++')


def host_library_path(source: Path, flags=HOST_CXX_FLAGS) -> Path:
    """Where :func:`build_host_library` puts the library of ``source``."""
    digest = hashlib.sha256(' '.join(host_compiler() + list(flags)).encode())
    digest.update(source.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / f'lib{source.stem}.so'


def build_host_library(source: Path, flags=HOST_CXX_FLAGS) -> Path:
    """Compile a host C++ source unless its library exists; return the
    library's path. It is written under a temporary name and renamed into
    place, so a process that loads it never sees a half-written file. A
    failed compile raises ``subprocess.CalledProcessError`` (its ``stderr``
    holds the compiler's message); a missing compiler ``OSError``."""
    out = host_library_path(source, flags)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = host_compiler() + list(flags) + [str(source), '-o', str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out
