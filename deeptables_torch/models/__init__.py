# -*- coding:utf-8 -*-
import importlib

from .config import ModelConfig
from .metainfo import (CategoricalColumn, ContinuousColumn,
                       VarLenCategoricalColumn)
from .deepmodel import DeepModel, DeepTabularModel, IgnoreCaseDict, ModelDesc
from . import deepnets
from .deepnets import register_custom_objects, register_nets

# loaded on first use: the estimator layer (the preprocessor, DeepTable,
# ModelSet) sits above the model's path, which imports none of it
_LAZY = {'AbstractPreprocessor': 'preprocessor',
         'DefaultPreprocessor': 'preprocessor',
         'DeepTable': 'deeptable',
         'ModelInfo': 'modelset',
         'ModelSet': 'modelset'}


def make_experiment(*args, **kwargs):
    """The AutoML experiment (``models/hyper_dt.py``), imported on first
    use."""
    from .hyper_dt import make_experiment as _make_experiment
    return _make_experiment(*args, **kwargs)


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f'.{_LAZY[name]}', __name__)
        return getattr(module, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
