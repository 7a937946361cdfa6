# -*- coding:utf-8 -*-
"""Filesystem abstraction (the port's copy of ``deeptables_tpu/utils/fs.py``).

Upstream deeptables re-exports hypernets' fs object (utils/__init__.py:6) so
models can persist to non-local filesystems (s3/hdfs) with a tempfile
staging hop (deepmodel.py:175-221).  This shim provides the same surface
(`open/exists/makedirs/sep/local root`) over the local filesystem, and
transparently upgrades to ``fsspec`` when a URL-style path is used and
fsspec is importable.
"""

import builtins
import os

sep = os.sep


def _is_url(path: str) -> bool:
    return '://' in str(path)


def _fsspec_fs(path):
    import fsspec
    return fsspec.core.url_to_fs(path)[0]


def open(path, mode='rb', **kwargs):  # noqa: A001 - mirror fs.open
    if _is_url(path):
        import fsspec
        return fsspec.open(path, mode, **kwargs).open()
    if 'w' in mode or 'a' in mode:
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
    return builtins.open(path, mode, **kwargs)


def exists(path) -> bool:
    if _is_url(path):
        return _fsspec_fs(path).exists(path)
    return os.path.exists(path)


def makedirs(path, exist_ok=True):
    if _is_url(path):
        return _fsspec_fs(path).makedirs(path, exist_ok=exist_ok)
    os.makedirs(path, exist_ok=exist_ok)


def listdir(path):
    if _is_url(path):
        return _fsspec_fs(path).ls(path)
    return os.listdir(path)


def remove(path):
    if _is_url(path):
        return _fsspec_fs(path).rm(path)
    os.remove(path)
