# -*- coding:utf-8 -*-
"""Network zoo: net builders, presets and registry (counterpart of
``deeptables_tpu/models/deepnets.py``).

flax builds parameters inline on the first call; torch cannot. So a builder
here takes the shapes of the model's inputs (``NetInputs``) and returns an
``nn.Module``, constructed once, whose ``forward(embeddings,
flatten_emb_layer, dense_layer, concat_emb_dense, ctx)`` computes the net's
output. A builder returns None where the net does not apply (no embedding
fields for FM, fewer than two for the pair products), as the JAX builder
returns None. The net's layers carry the flax names (``linear_logit``,
``dnn_dense_1``, ``fm_layer``, ``fgcnn_0_stage_0``, …), and
``DeepTabularModel`` registers them in one flat scope, as flax does. The
FGCNN and FiBiNet layers are numbered per model in build order
(``ModelDesc.next_num``), as the JAX package numbers them per trace.

The JAX package stacks the embedding fields in its own order (its plan's,
``ops.embedding.flax_field_order``), not in column order. The nets whose
function depends on that order (the pair products, AFM, FGCNN, FiBiNet)
set ``fields_in_flax_order``, and the model hands them the fields in the
JAX package's order, so that their pairs, convolutions, weights and
outputs match the JAX package's one to one. Every other net reads the
fields in column order, and the weight bridge permutes its weights.

All 20 builders of the JAX package are here, with ``custom_dnn_fn``, the
``custom_dnn_D_A_D_B`` variant and the custom-object registry that saved
models resolve their custom callables through.
"""

import inspect
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops.embedding import concat_embeddings
from ..ops.initializers import get_activation
from ..ops import layers
from ..ops import interactions
from ..ops.interactions import (CIN, FM, SENET, BilinearInteraction, Cross,
                                InnerProduct, MultiheadAttention,
                                OuterProduct)
from ..ops.layers import BatchNorm, Dense
from ..utils.profiling import annotate

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
    (B, F·U). Block 0 reads the embeddings (width D), each later block the
    one before it; every block outputs U = ``autoint_params['num_units']``
    (None: D). Each block's forward is the span ``deeptables.autoint.block``
    (counts: ``block``, ``fields``, ``heads``, ``d_head``, ``units_in``,
    ``units_out``)."""

    def __init__(self, n_fields, dim, params, generator=None):
        super().__init__()
        self.num_attention = int(params['num_attention'])
        width, self.block_spans = dim, []
        for i in range(self.num_attention):
            block = MultiheadAttention(width, params, generator=generator)
            self.add_module(f'autoint_attention_{i}', block)
            self.block_spans.append(dict(
                block=i, fields=n_fields, heads=block.num_heads,
                d_head=block.num_units // block.num_heads,
                units_in=width, units_out=block.num_units))
            width = block.num_units
        self.output_dim = n_fields * width

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        output = concat_embeddings(embeddings)
        for i in range(self.num_attention):
            with annotate('deeptables.autoint.block', **self.block_spans[i]):
                output = getattr(self, f'autoint_attention_{i}')(
                    output, training=ctx.training, generator=ctx.generator)
        return output.reshape(output.shape[0], -1)


class CrossNet(nn.Module):
    """``Cross`` over ``concat_emb_dense`` (column order)."""

    def __init__(self, n, params, generator=None):
        super().__init__()
        self.cross_layer = Cross(n, params, generator=generator)
        self.output_dim = n

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        return self.cross_layer(concat_emb_dense, training=ctx.training)


class CrossDnnNet(nn.Module):
    def __init__(self, n, params, mlp, generator=None):
        super().__init__()
        self.cross_dnn_layer = Cross(n, params, generator=generator)
        self.mlp = mlp
        self.output_dim = mlp.output_dim

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        cross = self.cross_dnn_layer(concat_emb_dense, training=ctx.training)
        return self.mlp(cross, ctx)


class DcnNet(nn.Module):
    def __init__(self, n, params, mlp, generator=None):
        super().__init__()
        self.dcn_cross_layer = Cross(n, params, generator=generator)
        self.mlp = mlp
        self.output_dim = n + mlp.output_dim

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        cross = self.dcn_cross_layer(concat_emb_dense, training=ctx.training)
        return torch.cat([cross, self.mlp(concat_emb_dense, ctx)], dim=-1)


class ProductDnnNet(nn.Module):
    """PNN: the product layers' outputs (pairs in the JAX package's field
    order) and ``concat_emb_dense``, concatenated, through the MLP."""

    fields_in_flax_order = True

    def __init__(self, products, mlp):
        super().__init__()
        for name, layer in products:
            self.add_module(name, layer)
        self._products = [name for name, _ in products]
        self.mlp = mlp
        self.output_dim = mlp.output_dim

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        parts = [getattr(self, name)(embeddings, training=ctx.training)
                 for name in self._products]
        x = torch.cat([p.float() for p in parts] + [concat_emb_dense],
                      dim=-1)
        return self.mlp(x, ctx)


class AFMNet(nn.Module):
    output_dim = 1
    fields_in_flax_order = True

    def __init__(self, n_fields, dim, params, generator=None):
        super().__init__()
        self.afm_layer = interactions.AFM(n_fields, dim, params,
                                          generator=generator)

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        return self.afm_layer(embeddings, training=ctx.training,
                              generator=ctx.generator)


class FeatureGeneration(nn.Module):
    """fg_nets' FGCNN stages, ``fgcnn_{idx}_stage_{s}``, over the stacked
    fields in the JAX package's order: (B, F, E) → (B, F_out, E) float32,
    each stage's new features and then the fields themselves."""

    def __init__(self, idx, n_fields, dim, params, generator=None):
        super().__init__()
        fields, channels = n_fields, 1
        self._stages = []
        self.n_fields_out = n_fields
        for stage, (filters, height, pool, new_filters) in enumerate(zip(
                params.get('fg_filters', (14, 16)),
                params.get('fg_heights', (7, 7)),
                params.get('fg_pool_heights', (2, 2)),
                params.get('fg_new_feat_filters', (2, 2)))):
            name = f'fgcnn_{idx}_stage_{stage}'
            self.add_module(name, interactions.FGCNN(
                fields, dim, channels, filters, height, new_filters, pool,
                generator=generator))
            self._stages.append(name)
            self.n_fields_out += fields * new_filters
            fields, channels = math.ceil(fields / pool), filters

    def forward(self, x, training=False):
        h, new_features = x[..., None], []
        for name in self._stages:
            h, new = getattr(self, name)(h, training=training)
            new_features.append(new)
        return torch.cat(new_features + [x.float()], dim=1)


class FgNet(nn.Module):
    """``fg_nets``: the FGCNN output (B, F_out, E) itself. Its subclasses,
    the ``fgcnn_*`` nets, put a head on it (:meth:`head`)."""

    fields_in_flax_order = True

    def __init__(self, fg: FeatureGeneration, dim):
        super().__init__()
        self.fg = fg
        self.output_dim = fg.n_fields_out * dim

    def head(self, fg_output, dense_layer, ctx):
        return fg_output

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        fg_output = self.fg(concat_embeddings(embeddings),
                            training=ctx.training)
        return self.head(fg_output, dense_layer, ctx)


class FgcnnCinNet(FgNet):
    def __init__(self, fg, dim, params, generator=None):
        super().__init__(fg, dim)
        self.fgcnn_cin_layer = CIN(fg.n_fields_out, dim, params,
                                   generator=generator)
        self.output_dim = 1

    def head(self, fg_output, dense_layer, ctx):
        return self.fgcnn_cin_layer(fg_output, training=ctx.training)


class FgcnnFmNet(FgNet):
    def __init__(self, fg, dim):
        super().__init__(fg, dim)
        self.fm_fgcnn_layer = FM()
        self.output_dim = 1

    def head(self, fg_output, dense_layer, ctx):
        return self.fm_fgcnn_layer(fg_output, training=ctx.training)


class FgcnnAfmNet(FgNet):
    def __init__(self, fg, dim, params, generator=None):
        super().__init__(fg, dim)
        self.fgcnn_afm_layer = interactions.AFM(fg.n_fields_out, dim,
                                                params, generator=generator)
        self.output_dim = 1

    def head(self, fg_output, dense_layer, ctx):
        return self.fgcnn_afm_layer(fg_output, training=ctx.training,
                                    generator=ctx.generator)


class FgcnnIpnnNet(FgNet):
    """The FGCNN output flattened, its pairs' inner products and the dense
    inputs, through the MLP."""

    def __init__(self, fg, dim, mlp):
        super().__init__(fg, dim)
        self.fgcnn_inner_product_layer = InnerProduct(fg.n_fields_out)
        self.mlp = mlp
        self.output_dim = mlp.output_dim

    def head(self, fg_output, dense_layer, ctx):
        ip = self.fgcnn_inner_product_layer(fg_output, training=ctx.training)
        flat = fg_output.reshape(fg_output.shape[0], -1)
        return self.mlp(_flat_with_dense(torch.cat([flat, ip], dim=-1),
                                         dense_layer), ctx)


class FgcnnDnnNet(FgNet):
    def __init__(self, fg, dim, mlp):
        super().__init__(fg, dim)
        self.mlp = mlp
        self.output_dim = mlp.output_dim

    def head(self, fg_output, dense_layer, ctx):
        return self.mlp(_flat_with_dense(fg_output, dense_layer), ctx)


def _flat_with_dense(x, dense_layer):
    parts = [x.reshape(x.shape[0], -1)]
    if dense_layer is not None:
        parts.append(dense_layer.float())
    return torch.cat(parts, dim=-1)


class BilinearNet(nn.Module):
    """fibi_nets: ``senet_layer_{idx}``, then ``senet_bilinear_layer_{idx}``
    over its output and ``embedding_bilinear_layer_{idx}`` over the
    fields (in the JAX package's order): (B, 2P, D) float32. With ``mlp``
    (fibi_dnn_nets), that flattened beside the dense inputs through the
    MLP."""

    fields_in_flax_order = True

    def __init__(self, idx, n_fields, dim, params, mlp=None,
                 generator=None):
        super().__init__()
        self.idx = idx
        bilinear_type = params.get('bilinear_type', 'field_interaction')
        self.add_module(f'senet_layer_{idx}', SENET(
            n_fields, params.get('senet_pooling_op', 'mean'),
            params.get('senet_reduction_ratio', 3), generator=generator))
        for name in ('senet_bilinear_layer', 'embedding_bilinear_layer'):
            self.add_module(f'{name}_{idx}', BilinearInteraction(
                n_fields, dim, bilinear_type, generator=generator))
        self.mlp = mlp
        n_pairs = n_fields * (n_fields - 1) // 2
        self.fibi_dim = 2 * n_pairs * dim
        self.output_dim = self.fibi_dim if mlp is None else mlp.output_dim

    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        x = concat_embeddings(embeddings)
        i = self.idx
        senet = getattr(self, f'senet_layer_{i}')(x, training=ctx.training)
        out = torch.cat([
            getattr(self, f'senet_bilinear_layer_{i}')(senet),
            getattr(self, f'embedding_bilinear_layer_{i}')(x)], dim=1)
        if self.mlp is None:
            return out
        return self.mlp(_flat_with_dense(out, dense_layer), ctx)


class Dnn(nn.Module):
    """The shared MLP: Dense → [BatchNorm] → activation → [Dropout] per
    hidden layer. Each Dense output is tapped under its layer name (e.g.
    'dnn_dense_1').

    ``order='D_A_D_B'`` is ``custom_dnn_D_A_D_B``'s variant: Dense (with a
    bias) → activation (tapped) → [Dropout] → [BatchNorm]."""

    def __init__(self, in_features, params, cellname='dnn', generator=None,
                 order='D_B_A_D'):
        super().__init__()
        hidden_units = params.get('hidden_units',
                                  ((128, 0, True), (64, 0, False)))
        if len(hidden_units) <= 0:
            raise ValueError(
                '[hidden_units] must be a list of tuple([units],[dropout_rate],'
                '[use_bn]) and at least one tuple.')
        self.activation = get_activation(params.get('activation', 'relu'))
        self.bn_last = order == 'D_A_D_B'
        kernel_init = params.get('kernel_initializer', 'he_uniform')
        self._layers = []
        width = in_features
        for index, (units, dropout, batch_norm) in enumerate(hidden_units, 1):
            name = f'{cellname}_dense_{index}'
            self.add_module(name, Dense(
                width, units, use_bias=self.bn_last or not batch_norm,
                kernel_init=kernel_init, generator=generator))
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
            if self.bn_last:
                x = self.activation(x)
                ctx.tap(name, x)
                if ctx.training:
                    x = layers.dropout(x, dropout, ctx.generator)
                if bn_name is not None:
                    x = getattr(self, bn_name)(x, training=ctx.training)
                continue
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
    """Shared MLP builder. ``params['custom_dnn_fn']`` (a callable, or the
    name it was saved by, resolved through the custom-object registry)
    builds the MLP in its place: ``fn(in_features, params, cellname,
    generator=None)`` returns an ``nn.Module`` with ``output_dim`` whose
    ``forward(x, ctx)`` computes it; it is called with the cell name
    ``cellname + '_custom'``, as the JAX package calls its custom DNN."""
    custom_dnn_fn = params.get('custom_dnn_fn')
    if isinstance(custom_dnn_fn, str):
        custom_dnn_fn = get_custom_object(custom_dnn_fn)
    if custom_dnn_fn is not None:
        return custom_dnn_fn(in_features, params, cellname + '_custom',
                             generator=generator)
    return Dnn(in_features, params, cellname=cellname, generator=generator)


def custom_dnn_D_A_D_B(in_features, params, cellname='dnn_D_A_D_B',
                       generator=None):
    """The Dense → activation → Dropout → BatchNorm MLP, a ``custom_dnn_fn``
    (its layers ``{cellname}_dense_{i}``, ``{cellname}_bn_{i}``)."""
    return Dnn(in_features, params, cellname=cellname, generator=generator,
               order='D_A_D_B')


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


def _pairs(n_fields):
    return n_fields * (n_fields - 1) // 2


def afm_nets(inputs: NetInputs, config, model_desc, generator=None):
    """Attentional FM over the field pairs."""
    if inputs.n_fields < 2:
        return None
    _check_one_width(inputs, 'afm_nets')
    model_desc.add_net('afm', f'list({inputs.n_fields})', (None, 1))
    return AFMNet(inputs.n_fields, inputs.emb_dim, config.afm_params,
                  generator=generator)


def _product_dnn(inputs, config, model_desc, generator, cellname, kinds):
    """ipnn/opnn/pnn: the product layers ``kinds`` ((flax name, 'inner' or
    'outer')) and the MLP over them and ``concat_emb_dense``."""
    if inputs.n_fields < 2:
        return None
    _check_one_width(inputs, f'{cellname}_nets')
    P = _pairs(inputs.n_fields)
    products = []
    for name, kind in kinds:
        if kind == 'inner':
            layer = InnerProduct(inputs.n_fields)
        else:
            layer = OuterProduct(inputs.n_fields, inputs.emb_dim,
                                 config.pnn_params, generator=generator)
        products.append((name, layer))
        model_desc.add_net(f'{cellname}-{kind}_product',
                           f'list({inputs.n_fields})', (None, P))
    width = len(kinds) * P + inputs.concat_dim
    mlp = dnn(width, config.dnn_params, cellname=cellname,
              generator=generator)
    model_desc.add_net(f'{cellname}-dnn', (None, width),
                       (None, mlp.output_dim))
    return ProductDnnNet(products, mlp)


def opnn_nets(inputs: NetInputs, config, model_desc, generator=None):
    """OuterProduct + DNN."""
    return _product_dnn(inputs, config, model_desc, generator, 'opnn',
                        [('outer_product_layer', 'outer')])


def ipnn_nets(inputs: NetInputs, config, model_desc, generator=None):
    """InnerProduct + DNN."""
    return _product_dnn(inputs, config, model_desc, generator, 'ipnn',
                        [('inner_product_layer', 'inner')])


def pnn_nets(inputs: NetInputs, config, model_desc, generator=None):
    """Inner + outer product + DNN."""
    return _product_dnn(inputs, config, model_desc, generator, 'pnn',
                        [('pnn_inner_product_layer', 'inner'),
                         ('pnn_outer_product_layer', 'outer')])


def cross_nets(inputs: NetInputs, config, model_desc, generator=None):
    """DCN cross layers over ``concat_emb_dense``."""
    n = inputs.concat_dim
    model_desc.add_net('cross', (None, n), (None, n))
    return CrossNet(n, config.cross_params, generator=generator)


def cross_dnn_nets(inputs: NetInputs, config, model_desc, generator=None):
    """Cross → DNN."""
    n = inputs.concat_dim
    model_desc.add_net('cross_dnn-cross', (None, n), (None, n))
    mlp = dnn(n, config.dnn_params, cellname='cross_dnn',
              generator=generator)
    model_desc.add_net('cross_dnn-dnn', (None, n), (None, mlp.output_dim))
    return CrossDnnNet(n, config.cross_params, mlp, generator=generator)


def dcn_nets(inputs: NetInputs, config, model_desc, generator=None):
    """Cross ∥ DNN, concatenated."""
    n = inputs.concat_dim
    model_desc.add_net('dcn-widecross', (None, n), (None, n))
    mlp = dnn(n, config.dnn_params, cellname='dcn', generator=generator)
    model_desc.add_net('dcn-dnn2', (None, n), (None, mlp.output_dim))
    net = DcnNet(n, config.cross_params, mlp, generator=generator)
    model_desc.add_net('dcn', (None, n), (None, net.output_dim))
    return net


def _feature_generation(inputs, config, model_desc, generator):
    """fg_nets' stages (their number taken from the model's count whether
    or not the net applies, as the JAX package counts), or None without
    embedding fields."""
    idx = model_desc.next_num('fgcnn')
    if inputs.n_fields == 0:
        model_desc.add_net('fgcnn', None, None)
        return None
    _check_one_width(inputs, 'fg_nets')
    fg = FeatureGeneration(idx, inputs.n_fields, inputs.emb_dim,
                           config.fgcnn_params, generator=generator)
    model_desc.add_net('fg', (None, inputs.n_fields, inputs.emb_dim),
                       (None, fg.n_fields_out, inputs.emb_dim))
    return fg


def fg_nets(inputs: NetInputs, config, model_desc, generator=None):
    """FGCNN feature generation: new features and the fields, (B, F', E)."""
    fg = _feature_generation(inputs, config, model_desc, generator)
    return None if fg is None else FgNet(fg, inputs.emb_dim)


def fgcnn_cin_nets(inputs: NetInputs, config, model_desc, generator=None):
    """FGCNN → CIN."""
    fg = _feature_generation(inputs, config, model_desc, generator)
    if fg is None:
        return None
    model_desc.add_net('fgcnn-cin', (None, fg.n_fields_out, inputs.emb_dim),
                       (None, 1))
    return FgcnnCinNet(fg, inputs.emb_dim, config.cin_params,
                       generator=generator)


def fgcnn_fm_nets(inputs: NetInputs, config, model_desc, generator=None):
    """FGCNN → FM."""
    fg = _feature_generation(inputs, config, model_desc, generator)
    if fg is None:
        return None
    model_desc.add_net('fgcnn-fm', (None, fg.n_fields_out, inputs.emb_dim),
                       (None, 1))
    return FgcnnFmNet(fg, inputs.emb_dim)


def fgcnn_afm_nets(inputs: NetInputs, config, model_desc, generator=None):
    """FGCNN → AFM."""
    fg = _feature_generation(inputs, config, model_desc, generator)
    if fg is None:
        return None
    model_desc.add_net('fgcnn-afm', (None, fg.n_fields_out, inputs.emb_dim),
                       (None, 1))
    return FgcnnAfmNet(fg, inputs.emb_dim, config.afm_params,
                       generator=generator)


def fgcnn_ipnn_nets(inputs: NetInputs, config, model_desc, generator=None):
    """FGCNN → InnerProduct + DNN."""
    fg = _feature_generation(inputs, config, model_desc, generator)
    if fg is None:
        return None
    F = fg.n_fields_out
    mlp = dnn(F * inputs.emb_dim + _pairs(F) + inputs.dense_dim,
              config.dnn_params, cellname='fgcnn_ipnn', generator=generator)
    model_desc.add_net('fgcnn-ipnn', (None, F, inputs.emb_dim),
                       (None, mlp.output_dim))
    return FgcnnIpnnNet(fg, inputs.emb_dim, mlp)


def fgcnn_dnn_nets(inputs: NetInputs, config, model_desc, generator=None):
    """FGCNN → DNN."""
    fg = _feature_generation(inputs, config, model_desc, generator)
    if fg is None:
        return None
    F = fg.n_fields_out
    mlp = dnn(F * inputs.emb_dim + inputs.dense_dim, config.dnn_params,
              cellname='fgcnn_dnn', generator=generator)
    model_desc.add_net('fgcnn-dnn', (None, F, inputs.emb_dim),
                       (None, mlp.output_dim))
    return FgcnnDnnNet(fg, inputs.emb_dim, mlp)


def _fibi(inputs, config, model_desc, generator, with_dnn):
    idx = model_desc.next_num('senet')
    if inputs.n_fields == 0:
        model_desc.add_net('fibi', None, None)
        return None
    _check_one_width(inputs, 'fibi_nets')
    F, D = inputs.n_fields, inputs.emb_dim
    fibi_shape = (None, 2 * _pairs(F), D)
    model_desc.add_net('fibi', (None, F, D), fibi_shape)
    mlp = None
    if with_dnn:
        mlp = dnn(2 * _pairs(F) * D + inputs.dense_dim, config.dnn_params,
                  cellname='fibi_dnn', generator=generator)
        model_desc.add_net('fibi-dnn', fibi_shape, (None, mlp.output_dim))
    return BilinearNet(idx, F, D, config.fibinet_params, mlp=mlp,
                   generator=generator)


def fibi_nets(inputs: NetInputs, config, model_desc, generator=None):
    """FiBiNet SENET + bilinear interactions, (B, 2P, D)."""
    return _fibi(inputs, config, model_desc, generator, with_dnn=False)


def fibi_dnn_nets(inputs: NetInputs, config, model_desc, generator=None):
    """FiBiNet → DNN."""
    if inputs.n_fields <= 1:
        return None
    return _fibi(inputs, config, model_desc, generator, with_dnn=True)


_BUILTIN = {
    'linear': linear,
    'cin_nets': cin_nets,
    'fm_nets': fm_nets,
    'afm_nets': afm_nets,
    'opnn_nets': opnn_nets,
    'ipnn_nets': ipnn_nets,
    'pnn_nets': pnn_nets,
    'dnn_nets': dnn_nets,
    'cross_nets': cross_nets,
    'cross_dnn_nets': cross_dnn_nets,
    'dcn_nets': dcn_nets,
    'autoint_nets': autoint_nets,
    'fg_nets': fg_nets,
    'fgcnn_cin_nets': fgcnn_cin_nets,
    'fgcnn_fm_nets': fgcnn_fm_nets,
    'fgcnn_afm_nets': fgcnn_afm_nets,
    'fgcnn_ipnn_nets': fgcnn_ipnn_nets,
    'fgcnn_dnn_nets': fgcnn_dnn_nets,
    'fibi_nets': fibi_nets,
    'fibi_dnn_nets': fibi_dnn_nets,
}

custom_nets = {}


def get(identifier):
    """Resolve a net name or builder callable."""
    if identifier is None:
        raise ValueError('identifier can not be none.')
    if isinstance(identifier, str):
        fn = custom_nets.get(identifier) or _BUILTIN.get(identifier) \
            or dt_custom_objects.get(identifier)
        if fn is None:
            raise ValueError(
                f'Unknown nets function: {identifier!r}. If this model was '
                f'saved with a custom net, re-register it with '
                f'register_custom_objects(...) or pass custom_objects= to '
                f'load().')
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


def _parameters(fn):
    """A signature's parameters by name, kind and default (annotations
    aside)."""
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


def register_nets(nets_fn):
    """Register a custom net builder; its parameters must be ``linear``'s:
    ``(inputs, config, model_desc, generator=None)``, returning an
    ``nn.Module`` (or None) with the net ``forward`` described above and an
    ``output_dim``."""
    if not callable(nets_fn):
        raise ValueError('nets_fn must be a valid callable function.')
    if _parameters(nets_fn) != _parameters(linear):
        raise ValueError(
            f'Signature of nets_fn is invalid, expect '
            f'{inspect.signature(linear)} but {inspect.signature(nets_fn)}')
    custom_nets[nets_fn.__name__] = nets_fn
    return nets_fn.__name__


# Custom objects of saved models: a model whose config holds custom
# callables (net builders in ``config.nets``, ``dnn_params['custom_dnn_fn']``)
# is saved with their names; loading resolves each name here and raises when
# it was not registered again.
dt_custom_objects = {}


def register_custom_objects(objects):
    """Register custom callables so that saved models can resolve them at
    load time.

    ``objects`` may be a dict ``{name: callable}``, a single callable, or an
    iterable of callables (named by ``__name__``). A callable whose
    signature is the net builders' is registered as a net too."""
    if objects is None:
        return
    if callable(objects):
        objects = [objects]
    items = objects.items() if isinstance(objects, dict) else \
        [(getattr(o, '__name__', None), o) for o in objects]
    for name, obj in items:
        if not name or name == '<lambda>' or not callable(obj):
            raise ValueError(
                f'Custom objects must be named callables (got name={name!r}, '
                f'obj={obj!r}); lambdas cannot round-trip save/load.')
        dt_custom_objects[name] = obj
        try:
            register_nets(obj)
        except ValueError:
            pass  # not a net builder: the registry entry alone is enough


def get_custom_object(name):
    """Resolve a saved custom object's name; raises if it is not
    registered."""
    fn = dt_custom_objects.get(name) or custom_nets.get(name)
    if fn is None:
        fn = globals().get(name)  # built-ins such as custom_dnn_D_A_D_B
    if fn is None or not callable(fn):
        raise ValueError(
            f'Unknown custom object {name!r}: this model was saved with a '
            f'custom callable. Re-register it with '
            f'deeptables_torch.models.register_custom_objects(...) or pass '
            f'custom_objects={{{name!r}: fn}} to load().')
    return fn
