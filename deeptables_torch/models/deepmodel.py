# -*- coding:utf-8 -*-
"""Model assembly and inference (counterpart of
``deeptables_tpu/models/deepmodel.py``).

- ``DeepTabularModel`` is the config-driven network as an ``nn.Module``,
  built once from the column schema. ``forward`` returns ``(logits, taps)``
  where ``taps`` holds named intermediate activations, as the flax module
  does. Its submodules carry the flax names (``emb_categorical_vars_all``,
  ``bn_concat_emb_dense``, ``linear_logit``, ``dnn_dense_1``,
  ``task_output``, …), so the ``state_dict`` keys read like the flax tree.
- ``DeepModel`` holds one on a device: ``fit`` (the train step is forward,
  weighted loss, backward and the optimizer's update; BatchNorm statistics
  move in the training forward), ``evaluate``, ``predict``, ``apply``,
  ``save``/``load`` and ``release``. Dropout masks come from a
  ``torch.Generator`` that the model owns on its device, seeded from
  ``config.seed + 13`` at the start of ``fit`` as the JAX package seeds its
  dropout key. The training loss adds the embedding regularizers'
  penalties, and a stateful loss (GHMC) carries its state from step to
  step in ``DeepModel.loss_state``.

``dtype_policy='bfloat16'`` casts the embeddings and the dense inputs to
bfloat16, as the JAX package does; every Dense and BatchNorm keeps float32
parameters and promotes its input to float32 (flax's promotion), so the
bfloat16 part of DeepFM is the embeddings, their flat view, the linear
net's per-field sums and FM. xDeepFM's CIN reads the bfloat16 embeddings
and keeps its layer outputs in float32, as the JAX package does. AutoInt's
projections run in their input's type (flax ``Dense(dtype=x.dtype)``), so
its first attention block runs in bfloat16 and, after that block's
BatchNorm promotes to float32, the later blocks in float32. Logits are
float32.
"""

import collections
import inspect
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from . import deepnets
from .callbacks import Callback, History
from ..data import pipeline, split
from ..ops import losses as losses_lib
from ..ops import metrics as metrics_lib
from ..ops import optimizers as optimizers_lib
from ..ops import regularizers as regularizers_lib
from ..ops.embedding import EmbeddingList, MultiColumnEmbedding, \
    VarLenColumnEmbedding, flatten_embeddings, flax_field_order, \
    var_len_width
from ..ops.layers import BatchNorm, Dense, dropout
from ..parallel import mesh as mesh_lib
from ..parallel import sharded_embedding
from ..utils import consts, dt_logging
from ..utils.device import resolve_device
from ..utils.profiling import annotate, iterate

logger = dt_logging.get_logger(__name__)


class DeepTabularModel(nn.Module):
    """The config-driven composed network: inputs → fused embeddings →
    flatten/concat (+BN) → per-net outputs → logit stacking → task head."""

    def __init__(self, config, task: str, num_classes: int,
                 categorical_columns: Tuple, continuous_columns: Tuple,
                 var_len_categorical_columns: Any = None, sharding=None):
        """``sharding``: a ``parallel.sharded_embedding.TableSharding`` that
        row-shards the categorical tables over a model axis, or None."""
        super().__init__()
        # parameters are drawn on the CPU from config.seed, then moved, so a
        # model has the same weights on every device
        generator = torch.Generator().manual_seed(config.seed)
        self.config = config
        self.task = task
        self.num_classes = num_classes
        self.categorical_columns = tuple(categorical_columns or ())
        self.continuous_columns = tuple(continuous_columns or ())
        self.var_len_categorical_columns = tuple(
            var_len_categorical_columns or ())
        self.compute_dtype = torch.bfloat16 \
            if config.dtype_policy == 'bfloat16' else torch.float32
        self.activity_regularizer = regularizers_lib.get_regularizer(
            config.embeddings_activity_regularizer)
        desc = ModelDesc()

        # ---- embeddings ----
        input_dims = tuple(int(c.vocabulary_size)
                           for c in self.categorical_columns)
        output_dims = tuple(int(c.embeddings_output_dim)
                            for c in self.categorical_columns)
        if self.categorical_columns:
            self.add_module(
                consts.LAYER_PREFIX_EMBEDDING + 'categorical_vars_all',
                MultiColumnEmbedding(
                    input_dims, output_dims,
                    dropout_rate=config.embedding_dropout,
                    embeddings_initializer=config.embeddings_initializer,
                    generator=generator, sharding=sharding))
            desc.set_embeddings(list(input_dims), list(output_dims),
                                config.embedding_dropout)
        var_widths = []
        for col in self.var_len_categorical_columns:
            self.add_module(
                consts.LAYER_PREFIX_EMBEDDING + col.name,
                VarLenColumnEmbedding(
                    col.vocabulary_size, col.embeddings_output_dim,
                    dropout_rate=config.embedding_dropout,
                    pooling_strategy=col.pooling_strategy,
                    embeddings_initializer=config.embeddings_initializer,
                    generator=generator))
            var_widths.append(var_len_width(col))
            desc.add_input(col.name, col.max_elements_length)
        widths = list(output_dims) + var_widths
        # the nets that read the fields in the JAX package's order get them
        # permuted by this (None where it is column order)
        order = flax_field_order(input_dims, output_dims, var_widths)
        self._field_order = None if order == sorted(order) else order
        self.register_buffer(
            'field_order', None if self._field_order is None
            else torch.tensor(order), persistent=False)

        # ---- dense (continuous) inputs ----
        dense_dim = sum(int(g.input_dim) for g in self.continuous_columns)
        for g in self.continuous_columns:
            desc.add_input(g.name, g.input_dim)
        if self.continuous_columns and config.dense_batch_norm:
            self.add_module(consts.LAYER_NAME_BN_DENSE_ALL,
                            BatchNorm(dense_dim))
        desc.set_dense(config.dense_dropout, config.dense_batch_norm)

        # ---- flatten/concat + BN ----
        flatten_dim = sum(widths)
        concat_dim = flatten_dim + dense_dim
        if concat_dim == 0:
            raise ValueError('No input layer exists.')
        self.bn_concat_emb_dense = BatchNorm(concat_dim)
        desc.set_concat_embed_dense((None, concat_dim))

        # ---- nets; their layers join this module's flat scope ----
        inputs = deepnets.NetInputs(
            n_fields=len(widths),
            emb_dim=widths[0] if len(set(widths)) == 1 else None,
            flatten_dim=flatten_dim, dense_dim=dense_dim,
            concat_dim=concat_dim)
        desc.nets = list(config.nets)
        desc.stacking = config.stacking_op
        nets = []
        for name in config.nets:
            net = deepnets.get(name)(inputs, config, desc, generator)
            if net is not None:
                self._register_layers(net)
                nets.append((name, net))
        if not nets:
            raise ValueError(f'Unexpected logit output. nets={config.nets}')
        # a plain list: the nets are not submodules, their layers are
        self._nets = nets
        self._net_spans = {name: f'deeptables.model.net.{name}'
                           for name, _ in nets}

        # ---- logit stacking ----
        if len(nets) > 1:
            for name, net in nets:
                if net.output_dim > 1:
                    self.add_module(f'dense_logit_{name}',
                                    Dense(net.output_dim, 1, use_bias=False,
                                          generator=generator))
            if config.stacking_op == consts.STACKING_OP_ADD:
                stacked_dim = 1
            elif config.stacking_op == consts.STACKING_OP_CONCAT:
                stacked_dim = len(nets)
            else:
                raise ValueError(
                    f'Unsupported stacking_op:{config.stacking_op}.')
        else:
            stacked_dim = nets[0][1].output_dim

        # ---- task head; logits out ----
        if task in (consts.TASK_BINARY, consts.TASK_REGRESSION):
            output_dim = 1
        elif task in (consts.TASK_MULTICLASS, consts.TASK_MULTILABEL):
            if not num_classes:
                raise ValueError(
                    '"num_classes" value must be provided for multi-class task.')
            output_dim = num_classes
        else:
            raise ValueError(f'Unknown task type:{task}')
        self.task_output = Dense(stacked_dim, output_dim,
                                 use_bias=config.output_use_bias,
                                 generator=generator)
        desc.set_output(task, (None, output_dim), config.output_use_bias)
        self.model_desc = desc

    def _register_layers(self, net: nn.Module):
        """Register the net's layers here under their own names, the flat
        scope in which flax names them: each leaf module, and each module
        that holds parameters of its own (``cin_layer``) or is a flax scope
        (``autoint_attention_{i}``) with its children inside it, as flax
        nests them."""
        scopes = []
        for path, layer in net.named_modules():
            if not path or any(path.startswith(s + '.') for s in scopes):
                continue
            if any(True for _ in layer.children()) and not any(
                    True for _ in layer.parameters(recurse=False)) \
                    and not getattr(layer, 'flax_scope', False):
                continue
            scopes.append(path)
            name = path.rsplit('.', 1)[-1]
            if name in self._modules:
                raise ValueError(f'Duplicate layer name {name!r} among nets.')
            self.add_module(name, layer)

    def _with_var_len(self, embeddings, batch, training, generator):
        """The categorical fields and then each var-len column's pooled
        field; stacked as the JAX package stacks them: onto the categorical
        fields when every width agrees."""
        var_embs = [getattr(self, consts.LAYER_PREFIX_EMBEDDING + c.name)(
            batch[c.name], training=training, generator=generator)
            for c in self.var_len_categorical_columns]
        items = list(embeddings) + var_embs
        stacked = embeddings.stacked
        if stacked is not None and all(
                e.shape[-1] == stacked.shape[-1] for e in var_embs):
            stacked = torch.cat([stacked] + var_embs, dim=1)
        else:
            stacked = torch.cat(items, dim=1) \
                if len({e.shape[-1] for e in items}) == 1 else None
        return EmbeddingList(items, stacked=stacked)

    def _in_flax_order(self, embeddings):
        """The fields in the JAX package's stacking order."""
        if self._field_order is None:
            return embeddings
        return EmbeddingList(
            [embeddings[i] for i in self._field_order],
            stacked=embeddings.stacked.index_select(1, self.field_order))

    def forward(self, batch: Dict[str, torch.Tensor], training: bool = False,
                generator: Optional[torch.Generator] = None):
        """``training=True`` applies dropout (masks from ``generator``, on
        the batch's device) and BatchNorm with batch statistics, which also
        moves BatchNorm's running statistics, and taps the activity
        regularizer's penalty over the float32 embedding outputs as
        ``__embeddings_activity_reg__`` (only in training: nothing else
        reads it). Its parts run in the spans ``model.embedding``,
        ``model.dense``, ``model.net.<name>`` and ``model.head``."""
        ctx = deepnets.TraceContext(training, generator)

        with annotate('deeptables.model.embedding'):
            embeddings = self._embeddings(batch, training, generator, ctx)

        with annotate('deeptables.model.dense'):
            dense_layer = self._dense(batch, training, generator)
            flatten_emb_layer = flatten_embeddings(embeddings)
            if flatten_emb_layer is not None:
                ctx.tap('flatten_embeddings', flatten_emb_layer)
            parts = [p for p in (flatten_emb_layer, dense_layer)
                     if p is not None]
            concat_emb_dense = parts[0] if len(parts) == 1 \
                else torch.cat(parts, dim=-1)
            concat_emb_dense = self.bn_concat_emb_dense(concat_emb_dense,
                                                        training=training)
            ctx.tap('concat_embedding_dense', concat_emb_dense)

        outs = collections.OrderedDict()
        flax_ordered = None
        for name, net in self._nets:
            with annotate(self._net_spans[name]):
                net_embeddings = embeddings
                if getattr(net, 'fields_in_flax_order', False):
                    if flax_ordered is None:
                        flax_ordered = self._in_flax_order(embeddings)
                    net_embeddings = flax_ordered
                out = net(net_embeddings, flatten_emb_layer, dense_layer,
                          concat_emb_dense, ctx)
            outs[name] = out
            ctx.tap(f'{name}_out', out)

        with annotate('deeptables.model.head'):
            logits = self._head(outs)
        ctx.tap('task_output', logits)
        return logits, ctx.taps

    def _embeddings(self, batch, training, generator, ctx):
        """The fields' embeddings (the categorical columns', then each
        var-len column's) in the compute type, and the activity
        regularizer's tap."""
        embeddings = EmbeddingList()
        if self.categorical_columns:
            emb_layer = getattr(
                self, consts.LAYER_PREFIX_EMBEDDING + 'categorical_vars_all')
            embeddings = emb_layer(batch[pipeline.CAT_KEY], training=training,
                                   generator=generator)
        if self.var_len_categorical_columns:
            embeddings = self._with_var_len(embeddings, batch, training,
                                            generator)
        if training and self.activity_regularizer is not None \
                and len(embeddings) > 0:
            ctx.tap('__embeddings_activity_reg__', sum(
                self.activity_regularizer(e.float()) for e in embeddings))
        if self.compute_dtype != torch.float32 and len(embeddings) > 0:
            stacked = embeddings.stacked
            embeddings = EmbeddingList(
                [e.to(self.compute_dtype) for e in embeddings],
                stacked=None if stacked is None
                else stacked.to(self.compute_dtype))
        return embeddings

    def _dense(self, batch, training, generator):
        """The dense inputs concatenated in the compute type, dropped out
        in training and batch-normalised (``dense_batch_norm``), or None."""
        if not self.continuous_columns:
            return None
        groups = [batch[g.name].to(self.compute_dtype)
                  for g in self.continuous_columns]
        dense_layer = groups[0] if len(groups) == 1 \
            else torch.cat(groups, dim=-1)
        if training:  # flax 'dropout_dense_input'
            dense_layer = dropout(dense_layer, self.config.dense_dropout,
                                  generator)
        if self.config.dense_batch_norm:
            dense_layer = getattr(self, consts.LAYER_NAME_BN_DENSE_ALL)(
                dense_layer, training=training)
        return dense_layer

    def _head(self, outs):
        """The nets' outputs stacked (``stacking_op``) into the task
        head's logits."""
        if len(outs) > 1:
            logits_list = []
            for name, out in outs.items():
                if out.dim() > 2:
                    out = out.reshape(out.shape[0], -1)
                if out.shape[-1] > 1:
                    out = getattr(self, f'dense_logit_{name}')(out)
                logits_list.append(out)
            if self.config.stacking_op == consts.STACKING_OP_ADD:
                x = sum(logits_list)
            else:
                x = torch.cat(logits_list, dim=-1)
        else:
            (out,) = outs.values()
            x = out.reshape(out.shape[0], -1) if out.dim() > 2 else out
        return self.task_output(x.float())


def probas_from_logits(logits: torch.Tensor, task: str) -> torch.Tensor:
    if task == consts.TASK_REGRESSION:
        return logits
    if task == consts.TASK_MULTICLASS:
        return torch.softmax(logits, dim=-1)
    return torch.sigmoid(logits)  # binary & multilabel


def _sanitize_config_for_pickle(config):
    """The config without what cannot be pickled: no distribution strategy,
    ``dnn_params['custom_dnn_fn']`` by its name (registered in the
    custom-object registry, which a loading process must fill again), and
    metrics, loss and optimizer by name when they are callables that do not
    pickle. Custom nets are in ``config.nets`` by name already."""
    cfg = config._replace(distribute_strategy=None)
    params = dict(cfg.dnn_params)
    fn = params.get('custom_dnn_fn')
    if callable(fn):
        deepnets.register_custom_objects(fn)
        params['custom_dnn_fn'] = fn.__name__
        cfg = cfg._replace(dnn_params=params)
    try:
        pickle.dumps(cfg)
        return cfg
    except (pickle.PicklingError, AttributeError, TypeError):
        pass
    metrics = tuple(
        m if isinstance(m, str) else getattr(m, '__name__', 'metric')
        for m in (cfg.metrics or ()))
    loss = cfg.loss if isinstance(cfg.loss, str) else \
        getattr(cfg.loss, '__name__', 'auto')
    optimizer = cfg.optimizer if isinstance(cfg.optimizer, str) else 'auto'
    return cfg._replace(metrics=metrics, loss=loss, optimizer=optimizer)


def _resolve_optimizer(optimizer, learning_rate, params):
    """The optimizer of a name, with the update rule of its ``optax``
    namesake at optax's defaults: ``'auto'``/``'adam'`` → Adam (betas
    0.9/0.999, eps 1e-8 outside the square root); ``'adamw'`` → AdamW
    (decoupled weight decay 1e-4); ``'sgd'`` → SGD without momentum;
    ``'rmsprop'``, ``'adagrad'``, ``'lamb'`` → the port's own
    (``ops/optimizers.py``). In place of an optax transformation the port
    takes a ``torch.optim.Optimizer`` subclass (built with
    ``lr=learning_rate``) or a callable ``params → Optimizer``."""
    if isinstance(optimizer, str):
        name = optimizer.lower()
        table = {
            'auto': lambda p, lr: torch.optim.Adam(
                p, lr=lr, betas=(0.9, 0.999), eps=1e-8),
            'adamw': lambda p, lr: torch.optim.AdamW(
                p, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4),
            'sgd': lambda p, lr: torch.optim.SGD(p, lr=lr),
            'rmsprop': optimizers_lib.RMSprop,
            'adagrad': optimizers_lib.Adagrad,
            'lamb': optimizers_lib.Lamb,
        }
        table['adam'] = table['auto']
        if name not in table:
            raise ValueError(f'Unknown optimizer: {optimizer!r}')
        return table[name](params, lr=learning_rate)
    if isinstance(optimizer, type) and \
            issubclass(optimizer, torch.optim.Optimizer):
        return optimizer(params, lr=learning_rate)
    if callable(optimizer):
        built = optimizer(params)
        if isinstance(built, torch.optim.Optimizer):
            return built
    raise ValueError(f'Cannot interpret optimizer: {optimizer!r}')


# the first key of a model file the port writes; a file without it (a JAX
# package's .dt file among them) is refused
SAVE_FORMAT = 'deeptables_torch.DeepModel/1'


class _ModelFileUnpickler(pickle.Unpickler):
    """Refuses the JAX package's classes: unpickling a JAX ``.dt`` file
    would import ``deeptables_tpu`` (and JAX)."""

    def find_class(self, module, name):
        if module.split('.')[0] == 'deeptables_tpu':
            raise ValueError(
                'this is a model file of the JAX package (deeptables_tpu), '
                'which the port does not read; carry its variables over with '
                'deeptables_torch.bridge.state_dict_from_flax in a process '
                'that has JAX.')
        return super().find_class(module, name)


def _read_model_file(filepath) -> dict:
    with open(filepath, 'rb') as f:
        payload = _ModelFileUnpickler(f).load()
    if not isinstance(payload, dict) or payload.get('format') != SAVE_FORMAT:
        raise ValueError(f'{filepath} is not a deeptables_torch model file.')
    return payload


class DeepModel:
    """A ``DeepTabularModel`` on a device, with the training and inference
    entry points.

    ``device=None`` runs on the current CUDA device and raises without one;
    ``device='cpu'`` runs the plain PyTorch path. ``model_file`` loads a
    file written by :meth:`save` (its task, classes and columns win over the
    arguments, as in the JAX package)."""

    def __init__(self, task, num_classes, config, categorical_columns,
                 continuous_columns, model_file=None,
                 var_categorical_len_columns=None, custom_objects=None,
                 device=None):
        # before any build: a loaded model resolves its custom nets and
        # custom_dnn_fn by name through the registry
        deepnets.register_custom_objects(custom_objects)
        self.device = resolve_device(device)
        self.task = task
        self.num_classes = num_classes
        self.config = config
        self.categorical_columns = tuple(categorical_columns or ())
        self.continuous_columns = tuple(continuous_columns or ())
        self.var_len_categorical_columns = \
            tuple(var_categorical_len_columns or ())
        self.model_desc = ModelDesc()
        self.stop_training = False
        self.module: Optional[DeepTabularModel] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        # a stateful loss's state (GHMC's bin counts) on the model's device,
        # made by the first fit
        self.loss_state: Optional[torch.Tensor] = None
        # draws the dropout masks of training; made by fit
        self.generator: Optional[torch.Generator] = None
        # the train steps run so far: the number each step's span carries
        self.steps_trained = 0
        self._strategy = None
        if model_file is not None:
            self._load_weights(model_file)

    @property
    def strategy(self) -> mesh_lib.DistributionStrategy:
        """``config.distribute_strategy`` resolved (``parallel.mesh``)."""
        if self._strategy is None:
            self._strategy = mesh_lib.get_strategy(
                self.config.distribute_strategy)
        return self._strategy

    def build(self) -> DeepTabularModel:
        """Initialize the parameters from ``config.seed`` (idempotent)."""
        if self.module is None:
            module = DeepTabularModel(
                self.config, self.task, self.num_classes,
                self.categorical_columns, self.continuous_columns,
                self.var_len_categorical_columns,
                sharding=sharded_embedding.table_sharding(self.config,
                                                          self.strategy))
            self.module = module.to(self.device).eval()
            self.model_desc = module.model_desc
            logger.info(str(self.model_desc))
        return self.module

    def _loss_fn(self):
        loss = self.config.loss
        if loss == 'auto':
            loss = losses_lib.auto_loss_name(self.task, self.num_classes)
            self.model_desc.loss = loss
        return losses_lib.get_loss(loss)

    # ------------------------------------------------------------------
    # snapshot protocol used by EarlyStopping
    # ------------------------------------------------------------------
    def get_state_snapshot(self) -> Dict[str, torch.Tensor]:
        """A copy of every parameter and BatchNorm statistic (the optimizer
        updates the live tensors in place, so a reference would move)."""
        return {k: v.detach().clone()
                for k, v in self.build().state_dict().items()}

    def set_state_snapshot(self, snapshot: Dict[str, torch.Tensor]):
        self.build().load_state_dict(snapshot)

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch → tensors on the model's device, ids checked first."""
        with annotate('deeptables.input.check_ids'):
            if pipeline.CAT_KEY in batch:
                pipeline.check_categorical_ids(batch[pipeline.CAT_KEY],
                                               self.categorical_columns)
            for col in self.var_len_categorical_columns:
                if col.name in batch:
                    pipeline.check_var_len_ids(batch[col.name], col)
        return self._copy_in(batch)

    def _copy_in(self, arrays: Dict[str, Optional[np.ndarray]]):
        """Host arrays (None stays None) → tensors on the model's device, in
        the span ``input.copy`` that counts the bytes copied."""
        with annotate('deeptables.input.copy', bytes=sum(
                v.nbytes for v in arrays.values() if v is not None)):
            return {k: None if v is None else torch.from_numpy(
                np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def _sharded_embedding(self):
        """The categorical embedding layer when it holds row-sharded
        tables, else None."""
        layer = getattr(self.build(), consts.LAYER_PREFIX_EMBEDDING +
                        'categorical_vars_all', None)
        return layer if layer is not None and layer.sharded_rows else None

    def forward_batch(self, batch: Dict[str, np.ndarray]):
        """One inference forward over a host batch → (logits, taps) on the
        device.

        With row-sharded tables it is a collective: every rank passes the
        same batch and gets the same result. Each data shard takes its rows
        of the batch, a remainder padded to the data shards with zeros as
        the JAX package pads it, and the logits and taps are gathered over
        the data axis."""
        module = self.build()
        shard = self.strategy.shard \
            if self._sharded_embedding() is not None else None
        with torch.inference_mode():
            if shard is None:
                return module(self.to_device(batch), training=False)
            n = len(next(iter(batch.values())))
            pad = -n % shard.size
            rows = shard.rows(n + pad)
            local = {k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])[rows]
                for k, v in batch.items()}
            logits, taps = module(self.to_device(local), training=False)
            return (mesh_lib.all_gather_rows(logits, shard)[:n],
                    {k: mesh_lib.all_gather_rows(v, shard)[:n]
                     for k, v in taps.items()})

    def _predict_logits(self, arrays, n, batch_size, want_taps=None):
        it = pipeline.BatchIterator(arrays, None, None, batch_size=batch_size,
                                    shuffle=False, drop_remainder=False)
        chunks = []
        tap_chunks = {k: [] for k in (want_taps or [])}
        for batch, _, _, valid in it:
            logits, taps = self.forward_batch(batch)
            chunks.append(logits[:valid])
            for k in tap_chunks:
                if k not in taps:
                    raise ValueError(f'No layer found in the model:{k}')
                tap_chunks[k].append(taps[k][:valid])
        # one device→host copy after the loop, not one per batch
        logits = torch.cat(chunks)[:n].cpu().numpy()
        if want_taps is not None:
            return logits, {k: torch.cat(v)[:n].float().cpu().numpy()
                            for k, v in tap_chunks.items()}
        return logits

    @staticmethod
    def _is_batch_loader(X):
        """A loader of ``(batch, y, weight, valid)`` tuples with ``steps``
        (``pipeline.BatchIterator``, a streaming loader). The attributes are
        looked up without being evaluated: a streaming loader's ``steps``
        reads every shard."""
        def has(name):
            try:
                inspect.getattr_static(X, name)
            except AttributeError:
                return False
            return True
        return has('steps') and has('__iter__') and not has('iloc')

    def _loader_logits(self, loader):
        """One pass over a batch loader → (logits, y) host arrays."""
        logits_parts, y_parts = [], []
        for batch, yb, _wb, valid in loader:
            logits, _ = self.forward_batch(batch)
            logits_parts.append(logits[:valid])
            if yb is not None:
                y_parts.append(np.asarray(yb)[:valid])
        logits = torch.cat(logits_parts).cpu().numpy()
        y = np.concatenate(y_parts) if y_parts else None
        return logits, y

    def _arrays(self, X):
        """Packed arrays from a dict of arrays or preprocessed columns
        (``data.columns.Columns`` or a DataFrame)."""
        if isinstance(X, dict):
            return X, len(next(iter(X.values())))
        arrays = pipeline.extract_arrays(
            X, self.categorical_columns, self.continuous_columns,
            self.var_len_categorical_columns)
        return arrays, len(X)

    def predict(self, X, batch_size=128, verbose=0):
        """Probabilities (or regression values) for packed arrays,
        preprocessed columns or a batch loader."""
        logger.info('Performing predictions...')
        if self._is_batch_loader(X):
            logits, _ = self._loader_logits(X)
        else:
            arrays, n = self._arrays(X)
            logits = self._predict_logits(arrays, n, batch_size)
        return probas_from_logits(torch.from_numpy(logits), self.task).numpy()

    def apply(self, X, output_layers=[], concat_outputs=False, batch_size=128,
              verbose=0, transformer=None):
        """Fetch named intermediate activations (taps) as float32 arrays."""
        if len(output_layers) <= 0:
            raise ValueError('"output_layers" at least 1 element.')
        arrays, n = self._arrays(X)
        _, taps = self._predict_logits(arrays, n, batch_size,
                                       want_taps=list(output_layers))
        outputs = [taps[k] for k in output_layers]
        outputs = [o.reshape(o.shape[0], -1) if o.ndim > 2 else o
                   for o in outputs]
        if len(outputs) > 1 and concat_outputs:
            outputs = np.concatenate(outputs, axis=-1)
        elif len(outputs) == 1:
            outputs = outputs[0]

        if transformer is None:
            return outputs
        if isinstance(outputs, list):
            return [transformer.fit_transform(o) for o in outputs]
        return transformer.fit_transform(outputs)


    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def embedding_weight_penalty(self, sharded: Optional[bool] = None
                                 ) -> Optional[torch.Tensor]:
        """``config.embeddings_regularizer`` over every parameter of the
        embedding layers (``emb_*``), or None without one (or without such
        a parameter). The port's tables hold the vocabularies' rows only;
        a row-sharded table's zero padding rows add nothing. ``sharded``
        True takes this rank's row-sharded tables only, False the others,
        None all."""
        reg = regularizers_lib.get_regularizer(
            self.config.embeddings_regularizer)
        if reg is None:
            return None
        terms = [reg(p) for name, p in self.build().named_parameters()
                 if name.startswith(consts.LAYER_PREFIX_EMBEDDING)
                 and (sharded is None or sharded == hasattr(
                     p, 'row_sharding'))]
        return sum(terms) if terms else None

    def training_loss(self, inputs: Dict[str, torch.Tensor], y, w, loss_fn,
                      weight_share: Optional[float] = None):
        """The training forward (it moves BatchNorm's running statistics)
        and its loss: the task loss (a stateful one reads
        ``self.loss_state``), plus the embedding activity penalty and the
        embedding weight penalty. Returns (loss, logits, the loss's new
        state or None).

        ``weight_share``: this rank's share of the global batch's weight (Σw
        of its rows over the batch's, or its rows over the batch's without
        weights) in a data-parallel step, whose ranks' losses add up to the
        global batch's: the task loss, a weighted mean over the rank's rows,
        is scaled by it (a loss that returns its rank's share already, GHMC,
        ``rank_share``, is not); the activity penalty, a sum over the rows,
        is the rank's part; the weight penalty counts on the ranks of data
        shard 0 only (a row-sharded table's penalty is its shard's)."""
        loss, shard_penalty, logits, new_state = self._training_loss_parts(
            inputs, y, w, loss_fn, weight_share)
        if shard_penalty is not None and self._penalty_on_rank(weight_share):
            loss = loss + shard_penalty
        return loss, logits, new_state

    def _penalty_on_rank(self, weight_share) -> bool:
        return weight_share is None or self.strategy.mesh.data_index == 0

    def _training_loss_parts(self, inputs, y, w, loss_fn, weight_share):
        """``training_loss`` in parts: (the loss without the row-sharded
        tables' weight penalty, that penalty of this rank's shards or None,
        logits, the loss's new state or None). Without row-sharded tables
        the first part is the whole loss. The loss and the penalties run
        in the span ``step.loss``."""
        logits, taps = self.module(inputs, training=True,
                                   generator=self.generator)
        with annotate('deeptables.step.loss'):
            new_state = None
            if getattr(loss_fn, 'stateful', False):
                loss, new_state = loss_fn(logits, y, w,
                                          state=self.loss_state)
            else:
                loss = loss_fn(logits, y, w)
            if weight_share is not None \
                    and not getattr(loss_fn, 'rank_share', False):
                loss = loss * weight_share
            if '__embeddings_activity_reg__' in taps:
                loss = loss + taps['__embeddings_activity_reg__']
            sharded = self._sharded_embedding() is not None
            penalty = self.embedding_weight_penalty(
                sharded=False if sharded else None)
            if penalty is not None and self._penalty_on_rank(weight_share):
                loss = loss + penalty
            shard_penalty = self.embedding_weight_penalty(sharded=True) \
                if sharded else None
        return loss, shard_penalty, logits, new_state

    def _train_step(self, batch: Dict[str, np.ndarray], yb: np.ndarray,
                    wb: Optional[np.ndarray], loss_fn):
        """One step on a host batch: ``training_loss``, backward, the
        optimizer's update and the loss's new state. Returns (loss, logits)
        on the device.

        Under a data-parallel strategy the host batch is the global one:
        this rank takes its rows, runs the step as its shard
        (``parallel.mesh.row_shard``: BatchNorm, dropout and GHMC see the
        global batch), sums the gradients over the ranks (one
        ``all_reduce`` a tensor, in parameter order) before the update, and
        returns the global batch's loss and logits. With a model axis, rank
        (d, m) takes data shard d's rows, the sums run over the data axis,
        and the row-sharded tables' weight penalty is summed over the model
        axis into the loss returned.

        The step runs in the span ``step`` (its number, from 1 over the
        model's life, and its rows), its parts in ``input.*``,
        ``step.forward`` (the model's spans and ``step.loss``),
        ``step.backward``, ``step.all_reduce``,
        ``step.optimizer`` (the update, then the gradients dropped) and
        ``step.loss_state`` (``utils.profiling.annotate``)."""
        self.steps_trained += 1
        with annotate('deeptables.step', step=self.steps_trained,
                      rows=len(yb)):
            return self._step(batch, yb, wb, loss_fn)

    def _step(self, batch, yb, wb, loss_fn):
        shard = self.strategy.shard
        share = None
        if shard is not None:
            rows = shard.rows(len(yb))
            if wb is None:
                share = (rows.stop - rows.start) / len(yb)
            else:
                total = float(np.sum(wb, dtype=np.float64))
                share = float(np.sum(wb[rows], dtype=np.float64)) / total \
                    if total > 0 else 0.
                wb = wb[rows]
            batch = {k: v[rows] for k, v in batch.items()}
            yb = yb[rows]
        inputs = self.to_device(batch)
        labels = self._copy_in({'y': yb, 'w': wb})
        with annotate('deeptables.step.forward'), mesh_lib.row_shard(shard):
            loss, shard_penalty, logits, new_state = \
                self._training_loss_parts(inputs, labels['y'], labels['w'],
                                          loss_fn, share)
        with annotate('deeptables.step.backward'):
            if shard_penalty is not None and self._penalty_on_rank(share):
                (loss + shard_penalty).backward()
            else:
                loss.backward()
        if shard is not None:
            with annotate('deeptables.step.all_reduce'):
                mesh_lib.all_reduce_gradients(self.module.parameters(),
                                              shard)
        with annotate('deeptables.step.optimizer'):
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        with annotate('deeptables.step.loss_state'):
            if new_state is not None:
                self.loss_state = new_state.detach()
            loss, logits = loss.detach(), logits.detach()
        if shard is not None:
            with annotate('deeptables.step.all_reduce'):
                torch.distributed.all_reduce(loss, group=shard.group)
                logits = mesh_lib.all_gather_rows(logits, shard)
        if shard_penalty is not None:
            with annotate('deeptables.step.all_reduce'):
                shard_penalty = shard_penalty.detach()
                torch.distributed.all_reduce(
                    shard_penalty, group=self.strategy.model_axis.group)
                loss = loss + shard_penalty
        return loss, logits

    def _split_validation(self, X, y, validation_split, validation_data):
        if validation_data is not None:
            if len(validation_data) != 2:
                raise ValueError(
                    f'Unexpected validation_data length, expected 2 but '
                    f'{len(validation_data)}.')
            return X, validation_data[0], y, validation_data[1]
        stratify = None
        if self.task in (consts.TASK_BINARY, consts.TASK_MULTICLASS):
            _, counts = np.unique(np.asarray(y), return_counts=True)
            if counts.min() >= 2:
                stratify = np.asarray(y)
        return split.train_test_split(X, y, test_size=validation_split,
                                      random_state=self.config.seed,
                                      stratify=stratify)

    def fit(self, X=None, y=None, batch_size=128, epochs=1, verbose=1,
            callbacks=None, validation_split=0.2, validation_data=None,
            shuffle=True, class_weight=None, sample_weight=None,
            initial_epoch=0, steps_per_epoch=None, validation_steps=None,
            validation_freq=1, max_queue_size=10, workers=1,
            use_multiprocessing=False):
        """Train on packed arrays (a dict) or preprocessed columns, as
        the JAX ``DeepModel.fit``: the same validation split (numpy, the rows
        scikit-learn would pick), batches, callbacks and ``logs`` keys
        (``loss``, the training metrics, ``val_loss``, ``val_<metric>``).
        A batch loader as ``X`` (``y`` None; ``validation_data`` a loader
        or None) trains out of core (``_fit_from_loader``). Returns the
        ``History`` callback, its ``history`` an ``IgnoreCaseDict``."""
        if batch_size is None:
            batch_size = 128
        if y is None and self._is_batch_loader(X):
            return self._fit_from_loader(
                X, validation_data, epochs=epochs, verbose=verbose,
                callbacks=callbacks, initial_epoch=initial_epoch,
                steps_per_epoch=steps_per_epoch)
        X, X_val, y, y_val = self._split_validation(
            X, y, validation_split, validation_data)
        arrays, _ = self._arrays(X)
        y_arr = pipeline.prepare_labels(y, self.task, self.num_classes)
        val_arrays, _ = self._arrays(X_val)
        y_val_arr = pipeline.prepare_labels(y_val, self.task, self.num_classes)
        weights = None
        if sample_weight is not None:
            weights = np.asarray(sample_weight, np.float32)
        elif class_weight:
            weights = pipeline.class_weight_to_sample_weight(y_arr,
                                                             class_weight)

        loss_fn, metric_specs, history, cbs = self._begin_fit(callbacks)
        # data-parallel batches divide the data shards; a batch of the whole
        # (smaller) data is padded to a multiple of them with zero weights,
        # which leave the loss but count in BatchNorm's statistics, as the
        # JAX package's padded batch does
        shards = self.strategy.num_data_shards
        if batch_size % shards != 0:
            batch_size = max(shards, (batch_size // shards) * shards)
            logger.warning(f'batch_size adjusted to {batch_size} to divide '
                           f'{shards} data shards.')
        it = pipeline.BatchIterator(arrays, y_arr, weights,
                                    batch_size=batch_size, shuffle=shuffle,
                                    drop_remainder=True, seed=self.config.seed,
                                    pad_multiple=shards)
        steps = steps_per_epoch or it.steps
        metric_cap = self.config.train_metrics_sample_limit
        logger.info('training...')
        t_start = time.time()
        for epoch in range(initial_epoch, epochs):
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            epoch_losses, train_logits, train_ys = [], [], []
            metric_examples = 0
            for step, (batch, yb, wb, _valid) in enumerate(
                    iterate('deeptables.fit.batch', it), 1):
                loss, logits = self._train_step(batch, yb, wb, loss_fn)
                epoch_losses.append(loss)
                if metric_cap is None or metric_examples < metric_cap:
                    # device logits; one host copy for the epoch below
                    train_logits.append(logits)
                    train_ys.append(yb)
                    metric_examples += len(yb)
                if step >= steps:
                    break

            with annotate('deeptables.fit.train_metrics'):
                logs = {'loss': float(torch.stack(epoch_losses).mean())}
                if train_logits:
                    tp = probas_from_logits(torch.cat(train_logits),
                                            self.task).cpu().numpy()
                    self._add_metrics(logs, metric_specs,
                                      np.concatenate(train_ys), tp)

            if (epoch + 1) % validation_freq == 0:
                with annotate('deeptables.fit.validation'):
                    val_logits = torch.from_numpy(self._predict_logits(
                        val_arrays, len(y_val_arr), batch_size))
                    val_probas = probas_from_logits(val_logits,
                                                    self.task).numpy()
                    logs['val_loss'] = float(loss_fn(
                        val_logits, torch.from_numpy(y_val_arr)))
                    self._add_metrics(logs, metric_specs, y_val_arr,
                                      val_probas, 'val_')

            if verbose and self.strategy.is_chief:
                msg = ' - '.join(f'{k}: {v:.4f}' for k, v in logs.items())
                logger.info(f'Epoch {epoch + 1}/{epochs} - {msg}')
            for cb in cbs:
                cb.on_epoch_end(epoch, logs)
            if self.stop_training:
                break

        for cb in cbs:
            cb.on_train_end()
        logger.info(f'Training finished in {time.time() - t_start:.2f}s.')
        history.history = IgnoreCaseDict(history.history)
        return history

    @staticmethod
    def _add_metrics(logs, metric_specs, y, probas, prefix=''):
        """``<prefix><metric>`` of each metric into ``logs``; a metric that
        raises is logged and left out."""
        for name, fn in metric_specs:
            try:
                logs[prefix + name] = float(fn(y, probas))
            except Exception as e:  # a user metric must not end fit
                what = 'val metric' if prefix else 'metric'
                logger.warning(f'{what} {name} failed: {e}')

    def make_optimizer(self) -> torch.optim.Optimizer:
        """The optimizer of ``config.optimizer`` over the module's
        parameters: made once, then kept across fits (and checkpointed with
        the model, ``utils/checkpoint.py``)."""
        if self.optimizer is None:
            self.optimizer = _resolve_optimizer(
                self.config.optimizer, self.config.learning_rate,
                self.build().parameters())
            self.model_desc.optimizer = type(self.optimizer).__name__
        return self.optimizer

    def initial_loss_state(self) -> Optional[torch.Tensor]:
        """A stateful loss's state (made at its initial value on the
        model's device, then kept across fits), or None."""
        loss_fn = self._loss_fn()
        if getattr(loss_fn, 'stateful', False) and self.loss_state is None:
            self.loss_state = loss_fn.init_state().to(self.device)
        return self.loss_state

    def _begin_fit(self, callbacks):
        """What every ``fit`` starts with: the module, the loss (and its
        state, kept across fits), the optimizer (kept across fits), the
        dropout generator from ``config.seed + 13``, the metrics and the
        callbacks, told that training begins. Returns (loss_fn,
        metric_specs, history, callbacks)."""
        module = self.build()
        # the process group matches the strategy, and the embedding
        # strategy is known
        self.strategy.validate(self.config.embedding_device_strategy)
        loss_fn = self._loss_fn()
        self.initial_loss_state()
        self.make_optimizer()
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.config.seed + 13)
        metric_specs = [metrics_lib.get_metric(m) for m in self.config.metrics]

        history = History()
        history.set_model(self)
        cbs: List[Callback] = [history]
        for cb in (callbacks or []):
            cb.set_model(self)
            cbs.append(cb)
        self.stop_training = False
        for cb in cbs:
            cb.on_train_begin()
        return loss_fn, metric_specs, history, cbs

    def _fit_from_loader(self, train_loader, val_loader=None, epochs=1,
                         verbose=1, callbacks=None, initial_epoch=0,
                         steps_per_epoch=None):
        """The epoch loop over a batch loader (out-of-core training: a
        ``CriteoStreamLoader``, a ``StreamingDataLoader`` or any loader of
        ``(batch, y, weight, valid)`` tuples), as the JAX package's
        ``_fit_from_loader``: every batch one step, padded rows by their
        zero weights; an epoch's ``loss`` the mean of its step losses and
        no training metrics; ``val_loss`` and ``val_<metric>`` over
        ``val_loader`` after every epoch; at most ``steps_per_epoch`` steps
        an epoch.

        The JAX package takes its first batch to trace the model, which
        starts one iteration of the loader (and so advances a streaming
        loader's epoch: its epoch ``e`` trains on the shuffle of
        ``seed + e + 1``); the port starts and closes one iteration in the
        same way, so that its batches are the JAX package's. The JAX
        package's ``train_steps_per_dispatch`` stacks steps into one
        ``lax.scan``, the same math as one step a batch (its own tests hold
        the two within rtol 1e-6); eager PyTorch runs one step a batch."""
        it = iter(train_loader)
        next(it)
        if hasattr(it, 'close'):
            it.close()
        loss_fn, metric_specs, history, cbs = self._begin_fit(callbacks)
        logger.info('training...')
        t_start = time.time()
        for epoch in range(initial_epoch, epochs):
            for cb in cbs:
                cb.on_epoch_begin(epoch)
            losses = []
            for batch, yb, wb, _valid in iterate('deeptables.fit.batch',
                                                 train_loader):
                loss, _ = self._train_step(batch, yb, wb, loss_fn)
                losses.append(loss)
                if steps_per_epoch and len(losses) >= steps_per_epoch:
                    break
            with annotate('deeptables.fit.train_metrics'):
                logs = {'loss': float(torch.stack(losses).mean())}

            if val_loader is not None:
                with annotate('deeptables.fit.validation'):
                    val_logits, val_y = self._loader_logits(val_loader)
                    val_logits = torch.from_numpy(val_logits)
                    val_probas = probas_from_logits(val_logits,
                                                    self.task).numpy()
                    logs['val_loss'] = float(loss_fn(
                        val_logits, torch.from_numpy(val_y)))
                    self._add_metrics(logs, metric_specs, val_y, val_probas,
                                      'val_')

            if verbose and self.strategy.is_chief:
                msg = ' - '.join(f'{k}: {v:.4f}' for k, v in logs.items())
                logger.info(f'Epoch {epoch + 1}/{epochs} - {msg}')
            for cb in cbs:
                cb.on_epoch_end(epoch, logs)
            if self.stop_training:
                break

        for cb in cbs:
            cb.on_train_end()
        logger.info(f'Training finished in {time.time() - t_start:.2f}s.')
        history.history = IgnoreCaseDict(history.history)
        return history

    def evaluate(self, X_test, y_test=None, batch_size=256, verbose=0,
                 return_dict=True):
        """Loss and ``config.metrics`` over packed arrays, columns, or a
        batch loader that yields labels (``y_test`` None)."""
        logger.info('Performing evaluation...')
        loss_fn = self._loss_fn()
        if self._is_batch_loader(X_test):
            logits, y_arr = self._loader_logits(X_test)
            if y_arr is None:
                raise ValueError('evaluate over a batch loader needs one that '
                                 'yields labels.')
        else:
            y_arr = pipeline.prepare_labels(y_test, self.task,
                                            self.num_classes)
            arrays, _ = self._arrays(X_test)
            logits = self._predict_logits(arrays, len(y_arr), batch_size)
        logits = torch.from_numpy(logits)
        proba = probas_from_logits(logits, self.task).numpy()
        result = {'loss': float(loss_fn(logits, torch.from_numpy(
            np.asarray(y_arr, np.float32))))}
        result.update(metrics_lib.compute_metrics(
            self.config.metrics, y_arr, proba, self.task))
        if return_dict:
            return IgnoreCaseDict(result)
        return [result['loss']] + [v for k, v in result.items() if k != 'loss']

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's ``state_dict`` with every row-sharded table whole
        (gathered over the model axis, without its padding rows: a
        collective then); the ``state_dict`` of the replicated model."""
        state = self.build().state_dict()
        layer = self._sharded_embedding()
        if layer is not None:
            prefix = consts.LAYER_PREFIX_EMBEDDING + 'categorical_vars_all.'
            state.update({prefix + k: v
                          for k, v in layer.full_tables().items()})
        return state

    def save(self, filepath):
        """A pickle (protocol 4) of the schema, the config and the
        ``state_dict`` as numpy arrays; it loads on any device. Under a
        data-parallel strategy rank 0 writes it (the ranks hold the same
        parameters) and the others write nothing. Row-sharded tables are
        gathered over the model axis first, whole and without their
        padding rows, so every rank calls it and the file loads in one
        process unchanged."""
        state = self.full_state_dict()
        if not self.strategy.is_chief:
            return
        payload = {
            'format': SAVE_FORMAT,
            'meta': {
                'task': self.task,
                'num_classes': self.num_classes,
                'config': _sanitize_config_for_pickle(self.config),
                'categorical_columns': self.categorical_columns,
                'continuous_columns': self.continuous_columns,
                'var_len_categorical_columns':
                    self.var_len_categorical_columns,
            },
            'state_dict': {k: v.detach().cpu().numpy()
                           for k, v in state.items()},
        }
        with open(filepath, 'wb') as f:
            pickle.dump(payload, f, protocol=4)

    def _load_state(self, state_dict: Dict[str, np.ndarray]):
        self.build().load_state_dict(
            {k: torch.from_numpy(v) for k, v in state_dict.items()})

    def _load_weights(self, filepath):
        payload = _read_model_file(filepath)
        meta = payload['meta']
        self.task = meta['task']
        self.num_classes = meta['num_classes']
        self.categorical_columns = tuple(meta['categorical_columns'])
        self.continuous_columns = tuple(meta['continuous_columns'])
        self.var_len_categorical_columns = \
            tuple(meta['var_len_categorical_columns'])
        self.module = None
        self._load_state(payload['state_dict'])

    @staticmethod
    def load(filepath, config=None, custom_objects=None, device=None):
        """A ``DeepModel`` from a file written by :meth:`save`, on
        ``device`` (default: the current CUDA device)."""
        payload = _read_model_file(filepath)
        meta = payload['meta']
        dm = DeepModel(meta['task'], meta['num_classes'],
                       config or meta['config'],
                       meta['categorical_columns'],
                       meta['continuous_columns'],
                       var_categorical_len_columns=meta[
                           'var_len_categorical_columns'],
                       custom_objects=custom_objects, device=device)
        dm._load_state(payload['state_dict'])
        return dm

    def release(self):
        """Drop the module, the optimizer state, the loss's state and the
        generator, and give their device memory back."""
        self.module = None
        self.optimizer = None
        self.loss_state = None
        self.generator = None
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

class ModelDesc:
    """Human-readable model description. Shapes carry ``None`` for the
    batch axis: the torch module is built from the schema, not traced on a
    sample batch."""

    def __init__(self):
        self.inputs = []
        self.embeddings = None
        self.dense = None
        self.concat_embed_dense = None
        self.nets = []
        self.nets_info = []
        self.stacking = None
        self.output = None
        self.loss = None
        self.optimizer = None
        self._counters = {}

    def next_num(self, name):
        """0, 1, 2, … on successive calls for one ``name``: the numbers of
        the FGCNN (``'fgcnn'``) and FiBiNet (``'senet'``) layers of this
        model, in build order, as the JAX package numbers them per trace."""
        self._counters[name] = self._counters.get(name, -1) + 1
        return self._counters[name]

    def add_input(self, name, num_columns):
        self.inputs.append(f'{name}: ({num_columns})')

    def set_embeddings(self, input_dims, output_dims, embedding_dropout):
        self.embeddings = (f'input_dims: {input_dims}\n'
                           f'output_dims: {output_dims}\n'
                           f'dropout: {embedding_dropout}')

    def set_dense(self, dense_dropout, use_batchnormalization):
        self.dense = (f'dropout: {dense_dropout}\n'
                      f'batch_normalization: {use_batchnormalization}')

    def set_concat_embed_dense(self, output_shape):
        self.concat_embed_dense = f'shape: {output_shape}'

    def add_net(self, name, input_shape, output_shape):
        self.nets_info.append(
            f'{name}: input_shape {input_shape}, output_shape {output_shape}')

    def set_output(self, activation, output_shape, use_bias):
        self.output = (f'activation: {activation}, output_shape: '
                       f'{output_shape}, use_bias: {use_bias}')

    def nets_desc(self):
        return '\n'.join(self.nets_info)

    def __str__(self):
        return (f'>>>>>>>>>>>>>>>>>>>>>> Model Desc <<<<<<<<<<<<<<<<<<<<<<<\n'
                f'inputs: {self.inputs}\n'
                f'embeddings:\n{self.embeddings}\n'
                f'dense: {self.dense}\n'
                f'concat_embed_dense: {self.concat_embed_dense}\n'
                f'nets: {self.nets}\n'
                f'{self.nets_desc()}\n'
                f'stacking_op: {self.stacking}\n'
                f'output: {self.output}\n'
                f'loss: {self.loss}\n'
                f'optimizer: {self.optimizer}\n')


class IgnoreCaseDict(collections.UserDict):
    """Case-insensitive str-keyed dict (a copy of the JAX package's)."""

    def __init__(self, inputs: Union[dict, collections.UserDict] = None):
        if isinstance(inputs, collections.UserDict):
            super().__init__(inputs.data)
        else:
            super().__init__(inputs)
        for k in list(self.data):
            if not isinstance(k, str):
                raise KeyError(f'Key should be str but is {k}')
        self.data.update({k.lower(): self.data[k] for k in list(self.data)})

    def __contains__(self, item):
        if not isinstance(item, str):
            raise KeyError(f'Key should be str but is {item}')
        return item.lower() in self.data

    def __setitem__(self, item, value):
        if not isinstance(item, str):
            raise KeyError(f'Key should be str but is {item}')
        self.data[item.lower()] = value

    def __getitem__(self, item):
        if not isinstance(item, str):
            raise KeyError(f'Key should be str but is {item}')
        return self.data[item.lower()]
