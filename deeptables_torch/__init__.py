# -*- coding:utf-8 -*-
"""deeptables_torch: the PyTorch/CUDA port of deeptables_tpu for NVIDIA Hopper.

The package mirrors ``deeptables_tpu``'s module tree and names. It imports
torch, numpy and the standard library only; every TPU (Pallas) kernel on a
ported path is a CUDA C++ kernel under ``csrc/``, built with ``nvcc`` at its
first launch (``ops/kernels/_build.py``).

Exports are lazy: importing the package imports no submodule and never builds
or loads a kernel.
"""

import importlib

from ._version import __version__

_EXPORTS = {
    'CategoricalColumn': 'models.metainfo',
    'ContinuousColumn': 'models.metainfo',
    'VarLenCategoricalColumn': 'models.metainfo',
    'ModelConfig': 'models.config',
    'DeepModel': 'models.deepmodel',
    'DeepTabularModel': 'models.deepmodel',
    'DeepTable': 'models.deeptable',
    'ModelSet': 'models.modelset',
    'make_experiment': 'models',
    'Predictor': 'serving',
}

__all__ = ['__version__', *_EXPORTS]


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f'.{_EXPORTS[name]}', __name__)
        return getattr(module, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
