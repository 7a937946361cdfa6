# -*- coding:utf-8 -*-
from .config import ModelConfig
from .metainfo import (CategoricalColumn, ContinuousColumn,
                       VarLenCategoricalColumn)
from .deepmodel import DeepModel, DeepTabularModel, IgnoreCaseDict, ModelDesc
from . import deepnets
from .deepnets import register_nets
