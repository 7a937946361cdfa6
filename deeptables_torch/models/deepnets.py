# -*- coding:utf-8 -*-
"""Network zoo: net builders, presets and registry (counterpart of
``deeptables_tpu/models/deepnets.py``).

flax builds parameters inline on the first call; torch cannot. So a builder
here takes the shapes of the model's inputs (``NetInputs``) and returns an
``nn.Module``, constructed once, whose ``forward(embeddings,
flatten_emb_layer, dense_layer, concat_emb_dense, ctx)`` computes the net's
output. A builder returns None where the net does not apply (no embedding
fields for FM), as the JAX builder returns None. The net's layers carry the
flax names (``linear_logit``, ``dnn_dense_1``, ``fm_layer``, …), and
``DeepTabularModel`` registers them in one flat scope, as flax does.

Ported: ``linear``, ``fm_nets``, ``cin_nets``, ``autoint_nets``,
``dnn_nets`` and the shared ``dnn``. The other builders raise
``NotImplementedError`` naming the slice that ports them.
"""

import inspect
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops.embedding import concat_embeddings
from ..ops.initializers import get_activation
from ..ops import layers
from ..ops.interactions import CIN, FM, MultiheadAttention
from ..ops.layers import BatchNorm, Dense

WideDeep = ['linear', 'dnn_nets']
DeepFM = ['linear', 'fm_nets', 'dnn_nets']
xDeepFM = ['linear', 'cin_nets', 'dnn_nets']
AutoInt = ['autoint_nets']
DCN = ['dcn_nets']
FGCNN = ['fgcnn_dnn_nets']
FiBiNet = ['fibi_dnn_nets']
PNN = ['pnn_nets']
AFM = ['afm_nets']


class NetInputs(NamedTuple):
    """Feature widths of the four inputs every net receives."""
    n_fields: int  # embedding fields F (0 without categorical columns)
    emb_dim: Optional[int]  # D when every field has one width, else None
    flatten_dim: int  # width of flatten_emb_layer
    dense_dim: int  # width of dense_layer
    concat_dim: int  # width of concat_emb_dense


class TraceContext:
    """Per-forward state shared between the model and its nets: the
    ``training`` flag, the ``torch.Generator`` that draws dropout masks in
    training, and the taps (named intermediate activations)."""

    def __init__(self, training=False, generator=None):
        self.training = training
        self.generator = generator
        self.taps = {}

    def tap(self, name, tensor):
        self.taps[name] = tensor


def _check_one_width(inputs, net):
    if inputs.n_fields > 1 and inputs.emb_dim is None:
        raise ValueError(f'{net} needs embeddings of one width '
                         f'(fixed_embedding_dim=True).')


class LinearNet(nn.Module):
    output_dim = 1

    def __init__(self, in_features, generator=None):
        super().__init__()
        self.linear_logit = Dense(in_features, 1, use_bias=False,
                                  generator=generator)

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        parts = []
        ce = concat_embeddings(embeddings)
        if ce is not None:
            parts.append(ce.sum(dim=-1))  # (B, F), in the embeddings' type
        if dense_layer is not None:
            parts.append(dense_layer)
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        return self.linear_logit(x)


class FMNet(nn.Module):
    output_dim = 1

    def __init__(self):
        super().__init__()
        self.fm_layer = FM()

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        return self.fm_layer(concat_embeddings(embeddings),
                             training=ctx.training)


class CINNet(nn.Module):
    output_dim = 1

    def __init__(self, n_fields, dim, params, generator=None):
        super().__init__()
        self.cin_layer = CIN(n_fields, dim, params, generator=generator)

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        return self.cin_layer(concat_embeddings(embeddings),
                              training=ctx.training)


class AutoIntNet(nn.Module):
    """``num_attention`` stacked ``MultiheadAttention`` blocks named
    ``autoint_attention_{i}``; the output (B, F, U) flattened to
    (B, F·U)."""

    def __init__(self, n_fields, dim, params, generator=None):
        super().__init__()
        self.num_attention = int(params['num_attention'])
        for i in range(self.num_attention):
            self.add_module(f'autoint_attention_{i}', MultiheadAttention(
                dim, params, generator=generator))
        self.output_dim = n_fields * dim

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        output = concat_embeddings(embeddings)
        for i in range(self.num_attention):
            output = getattr(self, f'autoint_attention_{i}')(
                output, training=ctx.training, generator=ctx.generator)
        return output.reshape(output.shape[0], -1)


class Dnn(nn.Module):
    """The shared MLP: Dense → [BatchNorm] → activation → [Dropout] per
    hidden layer. Each Dense output is tapped under its layer name (e.g.
    'dnn_dense_1')."""

    def __init__(self, in_features, params, cellname='dnn', generator=None):
        super().__init__()
        if params.get('custom_dnn_fn') is not None:
            raise NotImplementedError(
                'custom_dnn_fn: remaining-towers slice')
        hidden_units = params.get('hidden_units',
                                  ((128, 0, True), (64, 0, False)))
        if len(hidden_units) <= 0:
            raise ValueError(
                '[hidden_units] must be a list of tuple([units],[dropout_rate],'
                '[use_bn]) and at least one tuple.')
        self.activation = get_activation(params.get('activation', 'relu'))
        kernel_init = params.get('kernel_initializer', 'he_uniform')
        self._layers = []
        width = in_features
        for index, (units, dropout, batch_norm) in enumerate(hidden_units, 1):
            name = f'{cellname}_dense_{index}'
            self.add_module(name, Dense(width, units, use_bias=not batch_norm,
                                        kernel_init=kernel_init,
                                        generator=generator))
            bn_name = None
            if batch_norm:
                bn_name = f'{cellname}_bn_{index}'
                self.add_module(bn_name, BatchNorm(units))
            self._layers.append((name, bn_name, dropout))
            width = units
        self.output_dim = width

    def forward(self, x, ctx):
        for name, bn_name, dropout in self._layers:
            x = getattr(self, name)(x)
            ctx.tap(name, x)
            if bn_name is not None:
                x = getattr(self, bn_name)(x, training=ctx.training)
            x = self.activation(x)
            if ctx.training:
                x = layers.dropout(x, dropout, ctx.generator)
        return x


class DnnNet(nn.Module):
    def __init__(self, mlp: Dnn):
        super().__init__()
        self.mlp = mlp
        self.output_dim = mlp.output_dim

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        return self.mlp(concat_emb_dense, ctx)


def dnn(in_features, params, cellname='dnn', generator=None):
    """Shared MLP builder."""
    return Dnn(in_features, params, cellname=cellname, generator=generator)


def linear(inputs: NetInputs, config, model_desc, generator=None):
    """Linear (order-1) interactions: one logit from the per-field sums of
    the embeddings and the dense inputs."""
    _check_one_width(inputs, 'linear')
    in_features = inputs.n_fields + inputs.dense_dim
    if in_features == 0:
        raise ValueError('No input layer exists.')
    model_desc.add_net('linear', (None, in_features), (None, 1))
    return LinearNet(in_features, generator=generator)


def fm_nets(inputs: NetInputs, config, model_desc, generator=None):
    """FM pairwise (order-2) interactions."""
    if inputs.n_fields == 0:
        model_desc.add_net('fm', None, None)
        return None
    _check_one_width(inputs, 'fm_nets')
    model_desc.add_net('fm', (None, inputs.n_fields, inputs.emb_dim),
                       (None, 1))
    return FMNet()


def cin_nets(inputs: NetInputs, config, model_desc, generator=None):
    """Compressed Interaction Network (xDeepFM) over the stacked
    embeddings."""
    if inputs.n_fields == 0:
        model_desc.add_net('cin', None, None)
        return None
    _check_one_width(inputs, 'cin_nets')
    model_desc.add_net('cin', (None, inputs.n_fields, inputs.emb_dim),
                       (None, 1))
    return CINNet(inputs.n_fields, inputs.emb_dim, config.cin_params,
                  generator=generator)


def autoint_nets(inputs: NetInputs, config, model_desc, generator=None):
    """AutoInt self-attention stack over the stacked embeddings."""
    if inputs.n_fields == 0:
        model_desc.add_net('autoint', None, None)
        return None
    _check_one_width(inputs, 'autoint_nets')
    net = AutoIntNet(inputs.n_fields, inputs.emb_dim, config.autoint_params,
                     generator=generator)
    model_desc.add_net('autoint', (None, inputs.n_fields, inputs.emb_dim),
                       (None, net.output_dim))
    return net


def dnn_nets(inputs: NetInputs, config, model_desc, generator=None):
    """MLP over the concatenated inputs."""
    net = DnnNet(dnn(inputs.concat_dim, config.dnn_params,
                     generator=generator))
    model_desc.add_net('dnn', (None, inputs.concat_dim),
                       (None, net.output_dim))
    return net


def _not_ported(name, slice_name):
    def builder(inputs: NetInputs, config, model_desc, generator=None):
        raise NotImplementedError(
            f'{name} is not ported to deeptables_torch yet: it comes with '
            f'the {slice_name} slice.')
    builder.__name__ = name
    return builder


_BUILTIN = {
    'linear': linear,
    'cin_nets': cin_nets,
    'fm_nets': fm_nets,
    'afm_nets': _not_ported('afm_nets', 'remaining-towers'),
    'opnn_nets': _not_ported('opnn_nets', 'remaining-towers'),
    'ipnn_nets': _not_ported('ipnn_nets', 'remaining-towers'),
    'pnn_nets': _not_ported('pnn_nets', 'remaining-towers'),
    'dnn_nets': dnn_nets,
    'cross_nets': _not_ported('cross_nets', 'Wide&Deep+DCN'),
    'cross_dnn_nets': _not_ported('cross_dnn_nets', 'Wide&Deep+DCN'),
    'dcn_nets': _not_ported('dcn_nets', 'Wide&Deep+DCN'),
    'autoint_nets': autoint_nets,
    'fg_nets': _not_ported('fg_nets', 'remaining-towers'),
    'fgcnn_cin_nets': _not_ported('fgcnn_cin_nets', 'remaining-towers'),
    'fgcnn_fm_nets': _not_ported('fgcnn_fm_nets', 'remaining-towers'),
    'fgcnn_afm_nets': _not_ported('fgcnn_afm_nets', 'remaining-towers'),
    'fgcnn_ipnn_nets': _not_ported('fgcnn_ipnn_nets', 'remaining-towers'),
    'fgcnn_dnn_nets': _not_ported('fgcnn_dnn_nets', 'remaining-towers'),
    'fibi_nets': _not_ported('fibi_nets', 'remaining-towers'),
    'fibi_dnn_nets': _not_ported('fibi_dnn_nets', 'remaining-towers'),
}

custom_nets = {}


def get(identifier):
    """Resolve a net name or builder callable."""
    if identifier is None:
        raise ValueError('identifier can not be none.')
    if isinstance(identifier, str):
        fn = custom_nets.get(identifier) or _BUILTIN.get(identifier)
        if fn is None:
            raise ValueError(f'Unknown nets function: {identifier!r}.')
        return fn
    elif callable(identifier):
        register_nets(identifier)
        return identifier
    raise TypeError(
        f'Could not interpret nets function identifier: {identifier!r}')


def get_nets(nets):
    """Normalize a mixed list of names/callables into names
    (order-preserving de-duplication)."""
    str_nets = []
    seen = set()
    for net in nets:
        name = net if isinstance(net, str) else register_nets(net)
        if name not in seen:
            seen.add(name)
            str_nets.append(name)
    return str_nets


def register_nets(nets_fn):
    """Register a custom net builder; its signature must match ``linear``'s:
    ``(inputs, config, model_desc, generator=None)`` returning an
    ``nn.Module`` (or None) with the net ``forward`` described above and an
    ``output_dim``."""
    if not callable(nets_fn):
        raise ValueError('nets_fn must be a valid callable function.')
    if inspect.signature(nets_fn) != inspect.signature(linear):
        raise ValueError(
            f'Signature of nets_fn is invalid, expect '
            f'{inspect.signature(linear)} but {inspect.signature(nets_fn)}')
    custom_nets[nets_fn.__name__] = nets_fn
    return nets_fn.__name__
