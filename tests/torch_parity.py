# -*- coding:utf-8 -*-
"""Shared set-up for the port's parity tests (tests/test_torch_*.py): the
same schema, config, weights and inputs for a JAX ``DeepModel`` and its
counterpart in ``deeptables_torch``. Inputs and the BatchNorm statistics
come from numpy seeds; the port's weights are bridged from JAX."""

import jax
import numpy as np
import torch

from deeptables_tpu.data.datasets import load_criteo_synthetic
from deeptables_tpu.models import (CategoricalColumn, ContinuousColumn,
                                   DeepModel, ModelConfig,
                                   VarLenCategoricalColumn)
from deeptables_tpu.ops.embedding import plan_groups
from deeptables_torch import bridge
from deeptables_torch.models import CategoricalColumn as TCategoricalColumn
from deeptables_torch.models import ContinuousColumn as TContinuousColumn
from deeptables_torch.models import DeepModel as TDeepModel
from deeptables_torch.models import ModelConfig as TModelConfig
from deeptables_torch.models import \
    VarLenCategoricalColumn as TVarLenCategoricalColumn

torch.set_num_threads(1)  # the suite runs several xdist workers

DEEPFM = ['linear', 'fm_nets', 'dnn_nets']
XDEEPFM = ['linear', 'cin_nets', 'dnn_nets']
AUTOINT = ['autoint_nets']
HIDDEN = ((64, 0, False), (32, 0, False))
# the xDeepFM schemas' CIN, cut from (128, 128) to (8, 4)
CIN_PARAMS = {'cross_layer_size': (8, 4), 'activation': 'relu'}
# the AutoInt schemas' attention, cut from 3 blocks to 2 (2 heads, as the
# avazu configuration)
AUTOINT_PARAMS = {'num_attention': 2, 'num_heads': 2, 'dropout_rate': 0,
                  'use_residual': True}


def _criteo_vocabs():
    return [int(v) + 1 for v in
            load_criteo_synthetic(n_rows=1, return_arrays=True)[3]]


# name → (vocabulary sizes, embedding widths, dense columns, nets). The
# non-ascending schemas make the TPU plan reorder the fields; the bench
# schema is the criteo one of bench.py (26 columns at D=16, 13 dense); the
# mixed one has two width groups. The xdeepfm_* schemas run xDeepFM with
# CIN_PARAMS (or the cin_params given to Case); the autoint_* schemas run
# AutoInt alone with AUTOINT_PARAMS (updated by autoint_params), no dense
# columns, as the avazu configuration (its first vocabularies, 24, 7, 7,
# 4000, cut).
SCHEMAS = {
    'nonascending_d16': ([50, 7, 300, 20], [16] * 4, 3, DEEPFM),
    'nonascending_d8': ([50, 7, 300, 20, 9], [8] * 5, 3, DEEPFM),
    'bench': (_criteo_vocabs(), [16] * 26, 13, DEEPFM),
    'mixed_widths': ([50, 7, 300, 20], [8, 16, 8, 16], 3, ['dnn_nets']),
    'xdeepfm_nonascending_d8': ([50, 7, 300, 20, 9], [8] * 5, 3, XDEEPFM),
    'xdeepfm_nonascending_d16': ([50, 7, 300, 20], [16] * 4, 3, XDEEPFM),
    'autoint_nonascending_d8': ([24, 7, 7, 400, 30], [8] * 5, 0, AUTOINT),
    'autoint_nonascending_d16': ([24, 7, 300, 9], [16] * 4, 0, AUTOINT),
    'autoint_dnn_d8': ([24, 7, 7, 400, 30], [8] * 5, 2,
                       ['autoint_nets', 'dnn_nets']),
    # Wide&Deep+DCN on the adult schema of benchmarks/bench_models.py:
    # 8 columns, JAX field order [6, 5, 4, 2, 0, 3, 1, 7], 6 dense
    'adult_widedeep_dcn': ([9, 16, 7, 15, 6, 5, 2, 42], [16] * 8, 6,
                           ['linear', 'dnn_nets', 'dcn_nets']),
    # DeepFM on a hashed Criteo TSV schema (data.criteo.criteo_columns):
    # the buckets are the vocabularies, cut from [100_000] * 7 + [8192] * 19
    # to 5 columns
    'criteo_tsv': ([97, 64, 256, 31, 128], [8] * 5, 4, DEEPFM),
}


class Case:
    """One schema and dtype policy, built in both packages. ``task`` and
    ``num_classes`` pick the head; ``config`` updates both packages'
    ``ModelConfig`` (a loss, an optimizer, regularizers, metrics)."""

    def __init__(self, schema, dtype_policy='float32', seed=0,
                 cin_params=None, autoint_params=None, task='binary',
                 num_classes=2, nets=None, var_len=(), jit_init=False,
                 **config):
        """``nets`` replaces the schema's nets; ``var_len`` adds var-len
        columns, ``(name, vocabulary_size, dim, pooling, max_len)`` each;
        ``jit_init`` draws the JAX weights under ``jax.jit`` (the same
        initializers, compiled once instead of op by op)."""
        vocabs, dims, n_dense, schema_nets = SCHEMAS[schema]
        nets = schema_nets if nets is None else list(nets)
        self.vocabs, self.dims, self.nets = vocabs, dims, nets
        self.task, self.num_classes = task, num_classes
        kwargs = dict(nets=nets, metrics=['AUC'], task=task,
                      embedding_dropout=0,
                      dnn_params={'hidden_units': HIDDEN,
                                  'activation': 'relu'},
                      dtype_policy=dtype_policy)
        kwargs.update(config)
        if any('cin_nets' in n for n in nets if isinstance(n, str)):
            kwargs['cin_params'] = dict(CIN_PARAMS, **(cin_params or {}))
        if 'autoint_nets' in nets:
            kwargs['autoint_params'] = dict(AUTOINT_PARAMS,
                                            **(autoint_params or {}))
        dense_names = [f'I{i + 1}' for i in range(n_dense)]
        self.jax_cats = tuple(CategoricalColumn(f'C{i + 1}', v, d)
                              for i, (v, d) in enumerate(zip(vocabs, dims)))
        self.jax_conts = (ContinuousColumn('input_continuous_all',
                                           dense_names),) if n_dense else ()
        self.port_cats = tuple(TCategoricalColumn(f'C{i + 1}', v, d)
                               for i, (v, d) in enumerate(zip(vocabs, dims)))
        self.port_conts = (TContinuousColumn('input_continuous_all',
                                             dense_names),) if n_dense else ()
        self.var_len = tuple(var_len)
        self.jax_vars, self.port_vars = [], []
        for name, voc, dim, pooling, max_len in self.var_len:
            for cls, cols in ((VarLenCategoricalColumn, self.jax_vars),
                              (TVarLenCategoricalColumn, self.port_vars)):
                col = cls(name, voc, dim, pooling_strategy=pooling)
                col.max_elements_length = max_len
                cols.append(col)
        self.jax_config = ModelConfig(**kwargs)
        self.port_config = TModelConfig(**kwargs)

        self.jax_model = DeepModel(task, num_classes, self.jax_config,
                                   self.jax_cats, self.jax_conts,
                                   var_categorical_len_columns=self.jax_vars)
        if jit_init:
            self.jax_model.variables = jit_init_variables(self.jax_model)
        self.jax_model.build()
        randomize_batch_norm(self.jax_model.variables, seed)
        zero_padding_rows(self.jax_model.variables, vocabs, dims,
                          self.var_len)
        self.variables = jax.device_get(self.jax_model.variables)
        self.state_dict = bridge.state_dict_from_flax(
            self.variables, self.port_cats, self.port_conts, self.port_config,
            self.port_vars)

    def port_model(self):
        """A port DeepModel on the CPU holding the bridged weights."""
        model = TDeepModel(self.task, self.num_classes, self.port_config,
                           self.port_cats, self.port_conts,
                           var_categorical_len_columns=self.port_vars,
                           device='cpu')
        model.build().load_state_dict(self.state_dict, strict=True)
        return model

    def batch(self, n, seed=1):
        rng = np.random.default_rng(seed)
        cat = np.stack([rng.integers(0, v, n) for v in self.vocabs], axis=1)
        batch = {'cat': cat.astype(np.int32)}
        if self.jax_conts:
            dense = rng.normal(0.5, 1.5, (n, self.jax_conts[0].input_dim))
            batch['input_continuous_all'] = dense.astype(np.float32)
        for name, voc, _, _, max_len in self.var_len:
            # tokens 1.. then padding 0; the first row has no token
            lengths = rng.integers(0, max_len + 1, n)
            lengths[0] = 0
            ids = rng.integers(1, voc, (n, max_len))
            ids[np.arange(max_len)[None] >= lengths[:, None]] = 0
            batch[name] = ids.astype(np.int32)
        return batch

    def labels(self, n, seed=2):
        """Labels of the case's task: 0/1, class ids, reals or (n, C)
        0/1."""
        rng = np.random.default_rng(seed)
        if self.task == 'multiclass':
            return rng.integers(0, self.num_classes, n).astype(np.int32)
        if self.task == 'multilabel':
            return (rng.uniform(size=(n, self.num_classes)) < 0.4).astype(
                np.float32)
        if self.task == 'regression':
            return rng.normal(1.0, 2.0, n).astype(np.float32)
        return rng.integers(0, 2, n).astype(np.float32)

    def dataframe(self, n, seed=1):
        """``batch(n, seed)`` as a preprocessed DataFrame, one column per
        categorical and dense input."""
        import pandas as pd
        batch = self.batch(n, seed)
        columns = {c.name: batch['cat'][:, i]
                   for i, c in enumerate(self.port_cats)}
        for group in self.port_conts:
            columns.update({name: batch[group.name][:, i]
                            for i, name in enumerate(group.column_names)})
        return pd.DataFrame(columns)

    def field_order(self):
        """JAX stacked field position → column, from the JAX package's own
        plan (not the bridge's copy of it)."""
        plan = plan_groups([int(v) for v in self.vocabs], self.dims)
        if len(plan) == 1:
            return list(plan[0][1])
        return list(range(len(self.vocabs)))


def jit_init_variables(model):
    """``DeepModel.build``'s variables, its ``module.init`` under
    ``jax.jit``."""
    from flax.core import unfreeze
    module = model._build_module()
    rng = jax.random.PRNGKey(model.config.seed)
    init = jax.jit(lambda batch: module.init(
        {'params': rng, 'dropout': jax.random.fold_in(rng, 1)}, batch,
        training=True))
    variables = unfreeze(init(model._dummy_batch()))
    variables.setdefault('batch_stats', {})
    return variables


def randomize_batch_norm(variables, seed):
    """Random scale/bias/mean/var for every BatchNorm (nested ones too,
    such as ``autoint_attention_0/batch_normalize``), so that eval-mode
    BatchNorm is no identity."""
    rng = np.random.default_rng(seed)

    def visit(stats_tree, params_tree):
        for name, stats in stats_tree.items():
            params = params_tree[name]
            if 'mean' not in stats:
                visit(stats, params)
                continue
            n = stats['mean'].shape[0]
            stats['mean'] = rng.normal(0., 0.5, n).astype(np.float32)
            stats['var'] = rng.uniform(0.5, 2.0, n).astype(np.float32)
            params['scale'] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            params['bias'] = rng.normal(0., 0.2, n).astype(np.float32)
    visit(variables.get('batch_stats', {}), variables['params'])


def zero_padding_rows(variables, vocabs, dims, var_len=()):
    """Zero the rows of the JAX package's lane-packed embedding tables that
    no column reads (alignment padding, which its initializer fills), the
    var-len tables' too. The port keeps the vocabularies' rows only, so a
    weight penalty or a per-tensor norm (LAMB) agrees between the two only
    without them; those rows get no gradient and no decay, so they stay
    zero."""
    for name, voc, dim, _, _ in var_len:
        node = variables['params'][f'emb_{name}']
        table = np.array(node['embeddings'], np.float32)
        table.reshape(-1, dim)[voc:] = 0
        node['embeddings'] = jax.numpy.asarray(table)
    tables = variables['params'].get('emb_categorical_vars_all')
    if tables is None:
        return
    for dim, cols, offsets in bridge.flax_plan(vocabs, dims):
        name = f'embeddings_d{dim}'
        table = np.array(tables[name], np.float32)
        logical = table.reshape(-1, dim)
        keep = np.zeros(len(logical), bool)
        for col, offset in zip(cols, offsets):
            keep[offset:offset + vocabs[col]] = True
        logical[~keep] = 0
        tables[name] = jax.numpy.asarray(table)


def to_column_order(a, order, block):
    """Leading ``len(order)·block`` entries of the last axis, from JAX field
    order to column order."""
    a = np.asarray(a)
    n = len(order) * block
    head = a[..., :n].reshape(a.shape[:-1] + (len(order), block))
    out = np.empty_like(head)
    out[..., np.asarray(order), :] = head
    return np.concatenate([out.reshape(a.shape[:-1] + (n,)), a[..., n:]],
                          axis=-1)


def assert_batches_equal(port, ref):
    """Two loaders' ``(batch, y, weight, valid)`` tuples, one epoch each,
    exactly equal (a streaming loader of the port against the JAX
    package's)."""
    port, ref = list(port), list(ref)
    assert len(port) == len(ref) > 0
    for (b, y, w, v), (rb, ry, rw, rv) in zip(port, ref):
        assert v == rv and sorted(b) == sorted(rb)
        for k in rb:
            assert b[k].dtype == rb[k].dtype
            np.testing.assert_array_equal(b[k], rb[k], err_msg=k)
        np.testing.assert_array_equal(y, ry)
        assert (w is None) == (rw is None)
        if rw is not None:
            np.testing.assert_array_equal(w, rw)
