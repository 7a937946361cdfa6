# -*- coding:utf-8 -*-
"""Model assembly and inference (counterpart of
``deeptables_tpu/models/deepmodel.py``).

- ``DeepTabularModel`` is the config-driven network as an ``nn.Module``,
  built once from the column schema. ``forward`` returns ``(logits, taps)``
  where ``taps`` holds named intermediate activations, as the flax module
  does. Its submodules carry the flax names (``emb_categorical_vars_all``,
  ``bn_concat_emb_dense``, ``linear_logit``, ``dnn_dense_1``,
  ``task_output``, …), so the ``state_dict`` keys read like the flax tree.
- ``DeepModel`` holds one on a device and serves ``predict`` and ``apply``.
  Training (``fit``, ``evaluate``, ``save``, ``load``) comes with the
  training slice.

``dtype_policy='bfloat16'`` casts the embeddings and the dense inputs to
bfloat16, as the JAX package does; every Dense and BatchNorm keeps float32
parameters and promotes its input to float32 (flax's promotion), so the
bfloat16 part of DeepFM is the embeddings, their flat view, the linear
net's per-field sums and FM. Logits are float32.
"""

import collections
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import deepnets
from ..data import pipeline
from ..ops.embedding import EmbeddingList, MultiColumnEmbedding, \
    flatten_embeddings
from ..ops.layers import BatchNorm, Dense
from ..utils import consts, dt_logging
from ..utils.device import resolve_device

logger = dt_logging.get_logger(__name__)


class DeepTabularModel(nn.Module):
    """The config-driven composed network: inputs → fused embeddings →
    flatten/concat (+BN) → per-net outputs → logit stacking → task head."""

    def __init__(self, config, task: str, num_classes: int,
                 categorical_columns: Tuple, continuous_columns: Tuple,
                 var_len_categorical_columns: Any = None):
        super().__init__()
        if var_len_categorical_columns:
            raise NotImplementedError(
                'var-len categorical embeddings: remaining-towers slice')
        if config.embeddings_activity_regularizer is not None:
            raise NotImplementedError(
                'embeddings_activity_regularizer: training slice')
        # parameters are drawn on the CPU from config.seed, then moved, so a
        # model has the same weights on every device
        generator = torch.Generator().manual_seed(config.seed)
        self.config = config
        self.task = task
        self.num_classes = num_classes
        self.categorical_columns = tuple(categorical_columns or ())
        self.continuous_columns = tuple(continuous_columns or ())
        self.compute_dtype = torch.bfloat16 \
            if config.dtype_policy == 'bfloat16' else torch.float32
        desc = ModelDesc()

        # ---- embeddings ----
        output_dims = tuple(int(c.embeddings_output_dim)
                            for c in self.categorical_columns)
        if self.categorical_columns:
            input_dims = tuple(int(c.vocabulary_size)
                               for c in self.categorical_columns)
            self.add_module(
                consts.LAYER_PREFIX_EMBEDDING + 'categorical_vars_all',
                MultiColumnEmbedding(
                    input_dims, output_dims,
                    dropout_rate=config.embedding_dropout,
                    embeddings_initializer=config.embeddings_initializer,
                    generator=generator))
            desc.set_embeddings(list(input_dims), list(output_dims),
                                config.embedding_dropout)

        # ---- dense (continuous) inputs ----
        dense_dim = sum(int(g.input_dim) for g in self.continuous_columns)
        for g in self.continuous_columns:
            desc.add_input(g.name, g.input_dim)
        if self.continuous_columns and config.dense_batch_norm:
            self.add_module(consts.LAYER_NAME_BN_DENSE_ALL,
                            BatchNorm(dense_dim))
        desc.set_dense(config.dense_dropout, config.dense_batch_norm)

        # ---- flatten/concat + BN ----
        flatten_dim = sum(output_dims)
        concat_dim = flatten_dim + dense_dim
        if concat_dim == 0:
            raise ValueError('No input layer exists.')
        self.bn_concat_emb_dense = BatchNorm(concat_dim)
        desc.set_concat_embed_dense((None, concat_dim))

        # ---- nets; their layers join this module's flat scope ----
        inputs = deepnets.NetInputs(
            n_fields=len(output_dims),
            emb_dim=output_dims[0] if len(set(output_dims)) == 1 else None,
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
        """Register the net's leaf layers here under their own names, the
        flat scope in which flax names them."""
        for path, layer in net.named_modules():
            if not path or any(True for _ in layer.children()):
                continue
            name = path.rsplit('.', 1)[-1]
            if name in self._modules:
                raise ValueError(f'Duplicate layer name {name!r} among nets.')
            self.add_module(name, layer)

    def forward(self, batch: Dict[str, torch.Tensor], training: bool = False):
        if training:
            raise NotImplementedError('training forward: training slice')
        ctx = deepnets.TraceContext(training)

        embeddings = EmbeddingList()
        if self.categorical_columns:
            emb_layer = getattr(
                self, consts.LAYER_PREFIX_EMBEDDING + 'categorical_vars_all')
            embeddings = emb_layer(batch[pipeline.CAT_KEY], training=training)
        if self.compute_dtype != torch.float32 and len(embeddings) > 0:
            stacked = embeddings.stacked
            embeddings = EmbeddingList(
                [e.to(self.compute_dtype) for e in embeddings],
                stacked=None if stacked is None
                else stacked.to(self.compute_dtype))

        dense_layer = None
        if self.continuous_columns:
            groups = [batch[g.name].to(self.compute_dtype)
                      for g in self.continuous_columns]
            dense_layer = groups[0] if len(groups) == 1 \
                else torch.cat(groups, dim=-1)
            if self.config.dense_batch_norm:
                dense_layer = getattr(self, consts.LAYER_NAME_BN_DENSE_ALL)(
                    dense_layer, training=training)

        flatten_emb_layer = flatten_embeddings(embeddings)
        if flatten_emb_layer is not None:
            ctx.tap('flatten_embeddings', flatten_emb_layer)
        parts = [p for p in (flatten_emb_layer, dense_layer) if p is not None]
        concat_emb_dense = parts[0] if len(parts) == 1 \
            else torch.cat(parts, dim=-1)
        concat_emb_dense = self.bn_concat_emb_dense(concat_emb_dense,
                                                    training=training)
        ctx.tap('concat_embedding_dense', concat_emb_dense)

        outs = collections.OrderedDict()
        for name, net in self._nets:
            out = net(embeddings, flatten_emb_layer, dense_layer,
                      concat_emb_dense, ctx)
            outs[name] = out
            ctx.tap(f'{name}_out', out)

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

        logits = self.task_output(x.float())
        ctx.tap('task_output', logits)
        return logits, ctx.taps


def probas_from_logits(logits: torch.Tensor, task: str) -> torch.Tensor:
    if task == consts.TASK_REGRESSION:
        return logits
    if task == consts.TASK_MULTICLASS:
        return torch.softmax(logits, dim=-1)
    return torch.sigmoid(logits)  # binary & multilabel


class DeepModel:
    """A ``DeepTabularModel`` on a device, with the inference entry points.

    ``device=None`` runs on the current CUDA device and raises without one;
    ``device='cpu'`` runs the plain PyTorch path."""

    def __init__(self, task, num_classes, config, categorical_columns,
                 continuous_columns, model_file=None,
                 var_categorical_len_columns=None, custom_objects=None,
                 device=None):
        if model_file is not None:
            raise NotImplementedError('DeepModel.load: training slice')
        if custom_objects:
            raise NotImplementedError('custom objects: remaining-towers slice')
        self.device = resolve_device(device)
        self.task = task
        self.num_classes = num_classes
        self.config = config
        self.categorical_columns = tuple(categorical_columns or ())
        self.continuous_columns = tuple(continuous_columns or ())
        self.var_len_categorical_columns = \
            tuple(var_categorical_len_columns or ())
        self.model_desc = ModelDesc()
        self.module: Optional[DeepTabularModel] = None

    def build(self) -> DeepTabularModel:
        """Initialize the parameters from ``config.seed`` (idempotent)."""
        if self.module is None:
            module = DeepTabularModel(
                self.config, self.task, self.num_classes,
                self.categorical_columns, self.continuous_columns,
                self.var_len_categorical_columns)
            self.module = module.to(self.device).eval()
            self.model_desc = module.model_desc
            logger.info(str(self.model_desc))
        return self.module

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch → tensors on the model's device, ids checked first."""
        if pipeline.CAT_KEY in batch:
            pipeline.check_categorical_ids(batch[pipeline.CAT_KEY],
                                           self.categorical_columns)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def forward_batch(self, batch: Dict[str, np.ndarray]):
        """One inference forward over a host batch → (logits, taps) on the
        device."""
        module = self.build()
        with torch.inference_mode():
            return module(self.to_device(batch), training=False)

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
        (``pipeline.BatchIterator``, a streaming loader)."""
        return hasattr(X, 'steps') and hasattr(X, '__iter__') \
            and not hasattr(X, 'iloc')

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
        """Packed arrays from a dict of arrays or a preprocessed DataFrame."""
        if isinstance(X, dict):
            return X, len(next(iter(X.values())))
        arrays = pipeline.extract_arrays(
            X, self.categorical_columns, self.continuous_columns,
            self.var_len_categorical_columns)
        return arrays, len(X)

    def predict(self, X, batch_size=128, verbose=0):
        """Probabilities (or regression values) for packed arrays, a
        preprocessed DataFrame or a batch loader."""
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
