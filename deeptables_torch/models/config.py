# -*- coding:utf-8 -*-
"""Single immutable configuration object for the whole pipeline.

The port's copy of ``deeptables_tpu/models/config.py``: the same field names
and defaults, so a config written for the JAX package carries over unchanged.
``distribute_strategy`` (a ``parallel.DataParallel``,
``parallel.DataAndModelParallel`` or another strategy of
``parallel/mesh.py``, a name, or None) and ``embedding_device_strategy``
are read by ``DeepModel``: data parallelism runs over the
``torch.distributed`` process group, and under a model axis larger than 1
``'sharded'`` and ``'sharded_a2a'`` row-shard the categorical tables over
it (``parallel/sharded_embedding.py``). ``embedding_a2a_capacity_factor``
is the capacity of ``'sharded_a2a'``'s exchange (None: exact).
``train_steps_per_dispatch`` (steps a TPU dispatch) is accepted and not
read.
``nets`` is normalized through the port's own ``deepnets.get_nets``.
``autoint_params`` takes one key the JAX package lacks: ``num_units``, the
output width (``num_heads·d_head``) of every interacting layer, absent or
None for the input width as the JAX package builds them
(``ops/interactions.MultiheadAttention``).
"""

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional

from ..utils import consts


def _default_dnn_params():
    return {
        'hidden_units': ((128, 0, False), (64, 0, False)),
        'activation': 'relu',
    }


def _default_autoint_params():
    return {
        'num_attention': 3,
        'num_heads': 1,
        'dropout_rate': 0,
        'use_residual': True,
    }


def _default_fgcnn_params():
    return {
        'fg_filters': (14, 16),
        'fg_heights': (7, 7),
        'fg_pool_heights': (2, 2),
        'fg_new_feat_filters': (2, 2),
    }


def _default_fibinet_params():
    return {
        'senet_pooling_op': 'mean',
        'senet_reduction_ratio': 3,
        'bilinear_type': 'field_interaction',
    }


def _default_cross_params():
    return {'num_cross_layer': 4}


def _default_pnn_params():
    return {'outer_product_kernel_type': 'mat'}


def _default_afm_params():
    return {'attention_factor': 4, 'dropout_rate': 0}


def _default_cin_params():
    return {
        'cross_layer_size': (128, 128),
        'activation': 'relu',
        'use_residual': False,
        'use_bias': False,
        'direct': False,
        'reduce_D': False,
    }


@dataclass(frozen=True)
class ModelConfig:
    name: str = 'conf-1'
    nets: Any = ('dnn_nets',)
    categorical_columns: Any = 'auto'
    exclude_columns: Any = ()
    task: str = consts.TASK_AUTO
    pos_label: Any = None
    metrics: Any = ('accuracy',)
    auto_categorize: bool = False
    cat_exponent: float = 0.5
    cat_remain_numeric: bool = True
    auto_encode_label: bool = True
    auto_imputation: bool = True
    auto_scale: bool = False
    auto_discrete: bool = False
    auto_discard_unique: bool = True
    apply_gbm_features: bool = False
    gbm_params: dict = field(default_factory=dict)
    gbm_feature_type: str = consts.GBM_FEATURE_TYPE_EMB  # embedding/dense
    fixed_embedding_dim: bool = True
    embeddings_output_dim: int = 4
    embeddings_initializer: Any = 'uniform'
    embeddings_regularizer: Any = None
    embeddings_activity_regularizer: Any = None
    dense_dropout: float = 0
    embedding_dropout: float = 0.3
    stacking_op: str = consts.STACKING_OP_ADD
    output_use_bias: bool = True
    apply_class_weight: bool = False
    optimizer: Any = 'auto'
    loss: Any = 'auto'
    dnn_params: dict = field(default_factory=_default_dnn_params)
    autoint_params: dict = field(default_factory=_default_autoint_params)
    fgcnn_params: dict = field(default_factory=_default_fgcnn_params)
    fibinet_params: dict = field(default_factory=_default_fibinet_params)
    cross_params: dict = field(default_factory=_default_cross_params)
    pnn_params: dict = field(default_factory=_default_pnn_params)
    afm_params: dict = field(default_factory=_default_afm_params)
    cin_params: dict = field(default_factory=_default_cin_params)
    home_dir: Optional[str] = None
    monitor_metric: Optional[str] = None
    earlystopping_patience: int = 1
    earlystopping_mode: str = 'auto'  # auto, min, max
    gpu_usage_strategy: Optional[str] = None
    distribute_strategy: Any = None
    var_len_categorical_columns: Any = None
    # normalize raw continuous inputs before any net sees them
    dense_batch_norm: bool = True
    embedding_device_strategy: str = 'replicated'
    embedding_a2a_capacity_factor: Any = None
    dtype_policy: str = 'float32'  # 'float32' | 'bfloat16'
    learning_rate: float = 0.001
    seed: int = 9527
    train_metrics_sample_limit: Optional[int] = 200_000
    train_steps_per_dispatch: int = 8

    def __post_init__(self):
        var_len = self.var_len_categorical_columns
        if var_len is not None and len(var_len) > 0:
            for v in var_len:
                if not isinstance(v, (tuple, list)) or len(v) != 3:
                    raise ValueError('Var len column config should be a tuple 3.')
                _name = v[0]
                if self.exclude_columns is not None and _name in self.exclude_columns:
                    raise ValueError(
                        f"Var len column {_name} can not put in 'exclude_columns'")
                if isinstance(self.categorical_columns, list) \
                        and _name in self.categorical_columns:
                    raise ValueError(
                        f"Var len column {_name} can not put in 'categorical_columns'")

        from . import deepnets
        object.__setattr__(self, 'nets', tuple(deepnets.get_nets(self.nets)))

        if self.home_dir is None \
                and os.environ.get(consts.ENV_DEEPTABLES_HOME) is not None:
            object.__setattr__(self, 'home_dir',
                               os.environ.get(consts.ENV_DEEPTABLES_HOME))

    def _replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    def __hash__(self):
        return self.name.__hash__()

    @property
    def first_metric_name(self):
        if self.metrics is None or len(self.metrics) <= 0:
            raise ValueError('`metrics` is none or empty.')
        first_metric = self.metrics[0]
        if isinstance(first_metric, str):
            return first_metric
        if hasattr(first_metric, 'name') and isinstance(first_metric.name, str):
            return first_metric.name
        if callable(first_metric):
            return first_metric.__name__
        raise ValueError('`metric` must be string or callable object.')

    def signature_fields(self):
        """Fields that determine the preprocessing output: the key of the
        preprocessor's fit cache."""
        return (self.auto_imputation, self.auto_encode_label,
                self.auto_discrete, self.apply_gbm_features, self.task,
                self.cat_exponent,
                tuple(self.exclude_columns)
                if self.exclude_columns is not None else None,
                tuple(self.categorical_columns)
                if isinstance(self.categorical_columns, (list, tuple))
                else self.categorical_columns,
                self.auto_categorize, self.cat_remain_numeric,
                self.auto_discard_unique, repr(sorted(self.gbm_params.items())),
                self.gbm_feature_type, self.fixed_embedding_dim,
                self.embeddings_output_dim)
