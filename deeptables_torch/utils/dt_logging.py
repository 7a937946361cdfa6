# -*- coding:utf-8 -*-
"""Project logger factory (counterpart of ``deeptables_tpu/utils/dt_logging.py``).

Loggers live under ``deeptables_torch``; the level comes from
``DEEPTABLES_LOG_LEVEL`` (default INFO). Unlike the JAX package, this module
does not replace the process-wide logger class."""

import logging
import os

_FMT = '%(asctime)s %(levelname)s %(name)s: %(message)s'
_ROOT = 'deeptables_torch'


def _configure_root():
    root = logging.getLogger(_ROOT)
    if root.handlers:
        return
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(_FMT))
    root.addHandler(handler)
    level = os.environ.get('DEEPTABLES_LOG_LEVEL', 'INFO').upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False


def get_logger(name=None):
    _configure_root()
    if name is None:
        name = _ROOT
    elif not name.startswith(_ROOT):
        name = f'{_ROOT}.{name}'
    return logging.getLogger(name)
