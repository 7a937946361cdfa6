# -*- coding:utf-8 -*-
"""Framework-wide constants: the port's own copy of the names it uses from
``deeptables_tpu/utils/consts.py`` (same values, so configs and layer names
carry over unchanged)."""

TASK_AUTO = 'auto'
TASK_BINARY = 'binary'
TASK_MULTICLASS = 'multiclass'
TASK_REGRESSION = 'regression'
TASK_MULTILABEL = 'multilabel'

INPUT_PREFIX_CAT = 'cat_'
INPUT_PREFIX_NUM = 'input_continuous_'
LAYER_PREFIX_EMBEDDING = 'emb_'

LAYER_NAME_BN_DENSE_ALL = 'bn_dense_all'

DATATYPE_PREDICT_CLASS = 'int32'

MODEL_SELECT_MODE_MIN = 'min'
MODEL_SELECT_MODE_MAX = 'max'
MODEL_SELECT_MODE_AUTO = 'auto'

METRIC_NAME_AUC = 'AUC'

MODEL_SELECTOR_CURRENT = 'current'
MODEL_SELECTOR_BEST = 'best'
MODEL_SELECTOR_ALL = 'all'

EMBEDDING_OUT_DIM_DEFAULT = 4

GBM_FEATURE_TYPE_EMB = 'embedding'
GBM_FEATURE_TYPE_DENSE = 'dense'

STACKING_OP_CONCAT = 'concat'
STACKING_OP_ADD = 'add'

ENV_DEEPTABLES_HOME = 'DEEPTABLES_HOME'

# Metric names whose "higher is better" (model selection / early stopping).
METRICS_BIGGER_IS_BETTER = frozenset({
    'auc', 'acc', 'accuracy', 'precision', 'recall', 'f1', 'r2',
    'val_auc', 'val_acc', 'val_accuracy', 'val_precision', 'val_recall',
    'val_f1', 'val_r2',
})
