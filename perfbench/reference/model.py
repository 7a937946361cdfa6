"""Plain PyTorch DeepFM and xDeepFM, as DeepTables defines them.

The benchmark's reference: it imports nothing of the measured package and
takes only what the harness made (inputs, initial weights). Every tensor is
float32. Matrix products go through :func:`matmul`, which runs in IEEE
float32 (``precision='fp32'``, TF32 off) or, for the control, with its
operands rounded to TF32 as the tensor cores round them
(``precision='tf32'``, forward and backward).

``precision='fp64'`` runs the same model in float64 (the caller casts the
weights and inputs): a witness of how far float32 itself lies from the
exact result.

The model (``config``: a configuration file of ``perfbench/configs``):

- one embedding table of ``Σ (vocabulary_j + 1)`` rows and D columns;
  column j's ids index its own region, which starts at the sum of the
  regions before it;
- the dense inputs go through a BatchNorm (``dense_batch_norm``);
- ``concat`` = [flattened embeddings (F·D), normalised dense] through a
  second BatchNorm feeds the DNN;
- BatchNorm as flax computes it: batch mean and the biased variance
  ``E[x²] − E[x]²`` (clamped at 0) in training, the running statistics at
  inference, epsilon 1e-3;
- nets, their logits added: ``linear`` (one Dense without bias over
  [per-field sums of the embeddings, normalised dense]), ``fm_nets``
  (``0.5·Σ_d[(Σ_f e)² − Σ_f e²]``), ``cin_nets`` (layer i:
  ``z_bld = Σ_fg x0_bfd·h_bgd·W_lfg``, then ``cin_activation``; with
  ``cin_direct`` every layer passes all its maps on and outputs them all,
  else every layer but the last passes half of its maps on and outputs the
  other half; the outputs' sums over d through a Dense with bias) and
  ``dnn_nets`` (Dense with bias and ``dnn_activation`` per hidden layer,
  then a Dense without bias to one logit);
- the head: a Dense with bias from the summed logit to the logit.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPSILON = 1e-3

# the activations a configuration may name, by DeepTables' names
ACTIVATIONS = {'relu': torch.relu, 'linear': lambda x: x}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits), to
    nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` of 2-D float32 operands, each rounded to TF32 first, the
    products summed in float32; the backward's products likewise."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        return rg @ rb.t(), ra.t() @ rg


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision in ('fp32', 'fp64'):
        return a @ b
    if precision == 'tf32':
        return _TF32MatMul.apply(a, b)
    raise ValueError(f'unknown precision {precision!r}')


@contextlib.contextmanager
def ieee_float32():
    """Matrix products in IEEE float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def table_rows(config) -> list:
    return [int(v) + 1 for v in config['vocabulary']]


def cin_maps(config):
    """``[(L_i, G_i)]`` of each CIN layer and the width of its output."""
    sizes = list(config.get('cin_cross_layer_size') or ())
    direct = bool(config.get('cin_direct', False))
    layers, width = [], 0
    g = len(config['vocabulary'])
    for i, size in enumerate(sizes):
        layers.append((size, g))
        if direct or i == len(sizes) - 1:
            g = size
            width += size
        else:
            g = size // 2
            width += size - size // 2
    return layers, width


def param_specs(config):
    """The trained leaves, in a fixed order: ``[(name, shape, init)]`` with
    ``init`` one of ``('uniform', lo, hi)``. Dense weights are
    ``(out, in)``; CIN weights ``(L, F, G)``."""
    n_fields = len(config['vocabulary'])
    dim = int(config['embedding_dim'])
    n_dense = int(config['dense_features'])
    concat = n_fields * dim + n_dense
    nets = config['nets']

    def he(fan_in):
        limit = math.sqrt(6.0 / fan_in)
        return ('uniform', -limit, limit)

    def lecun(fan_in):
        limit = math.sqrt(3.0 / fan_in)
        return ('uniform', -limit, limit)

    small = ('uniform', -0.05, 0.05)
    gamma = ('uniform', 0.8, 1.2)
    beta = ('uniform', -0.1, 0.1)
    specs = [('embeddings', (sum(table_rows(config)), dim), small)]
    if n_dense and config.get('dense_batch_norm', True):
        specs += [('bn_dense.gamma', (n_dense,), gamma),
                  ('bn_dense.beta', (n_dense,), beta)]
    specs += [('bn_concat.gamma', (concat,), gamma),
              ('bn_concat.beta', (concat,), beta)]
    if 'linear' in nets:
        specs.append(('linear.w', (1, n_fields + n_dense),
                      lecun(n_fields + n_dense)))
    if 'cin_nets' in nets:
        layers, width = cin_maps(config)
        for i, (size, g) in enumerate(layers):
            specs.append((f'cin.{i}.w', (size, n_fields, g),
                          he(n_fields * g)))
        specs += [('cin.out.w', (1, width), lecun(width)),
                  ('cin.out.b', (1,), small)]
    if 'dnn_nets' in nets:
        width = concat
        for i, units in enumerate(config['dnn_hidden_units']):
            specs += [(f'dnn.{i}.w', (units, width), he(width)),
                      (f'dnn.{i}.b', (units,), small)]
            width = units
        specs.append(('dnn.logit.w', (1, width), lecun(width)))
    specs += [('out.w', (1, 1), lecun(1)), ('out.b', (1,), small)]
    return specs


def dense_moments():
    """Mean and variance of one dense input, ``log1p(max(N(2, 1.5), 0))``
    (the inputs' recipe), by quadrature over x > 0: the mass at 0 adds
    ``log1p(0) = 0`` to both moments."""
    x = torch.linspace(0.0, 2.0 + 1.5 * 12, 200001, dtype=torch.float64)
    pdf = torch.exp(-0.5 * ((x - 2.0) / 1.5) ** 2) / (1.5 * math.sqrt(
        2 * math.pi))
    y = torch.log1p(x)
    dx = float(x[1] - x[0])
    mean = float(torch.trapezoid(y * pdf, dx=dx))
    second = float(torch.trapezoid(y * y * pdf, dx=dx))
    return mean, second - mean * mean


def batch_norm(x, gamma, beta, mean, var, training):
    if training:
        mean = x.mean(dim=0)
        var = torch.clamp_min((x * x).mean(dim=0) - mean * mean, 0.)
    return (x - mean) * torch.rsqrt(var + BN_EPSILON) * gamma + beta


def _cin(params, config, emb, precision):
    batch, n_fields, dim = emb.shape
    layers, _ = cin_maps(config)
    activation = ACTIVATIONS[config['cin_activation']]
    direct = bool(config.get('cin_direct', False))
    hidden, outs = emb, []
    for i, (size, g) in enumerate(layers):
        pair = emb[:, :, None, :] * hidden[:, None, :, :]  # (B, F, G, D)
        cols = pair.reshape(batch, n_fields * g, dim).permute(1, 0, 2)
        z = matmul(params[f'cin.{i}.w'].reshape(size, n_fields * g),
                   cols.reshape(n_fields * g, batch * dim), precision)
        z = activation(z.reshape(size, batch, dim).permute(1, 0, 2))
        if direct or i == len(layers) - 1:
            hidden = z
            outs.append(z)
        else:
            hidden, out = z[:, :size // 2], z[:, size // 2:]
            outs.append(out)
    result = torch.cat(outs, dim=1).sum(dim=-1)
    return matmul(result, params['cin.out.w'].t(), precision) \
        + params['cin.out.b']


def forward(params, config, cat, dense, training, precision='fp32'):
    """Logits ``(B, 1)`` of int64 column-local ids ``cat (B, F)`` and float32
    ``dense (B, n_dense)``. ``params`` holds :func:`param_specs`' leaves and,
    for inference, the running statistics ``bn_*.mean`` / ``bn_*.var``."""
    rows = table_rows(config)
    offsets = torch.tensor([0] + rows[:-1], device=cat.device).cumsum(0)
    batch, n_fields = cat.shape
    dim = int(config['embedding_dim'])
    emb = params['embeddings'].index_select(
        0, (cat + offsets).reshape(-1)).reshape(batch, n_fields, dim)

    dense_bn = dense
    if 'bn_dense.gamma' in params:
        dense_bn = batch_norm(dense, params['bn_dense.gamma'],
                              params['bn_dense.beta'],
                              params.get('bn_dense.mean'),
                              params.get('bn_dense.var'), training)
    concat = batch_norm(torch.cat([emb.reshape(batch, -1), dense_bn], dim=1),
                        params['bn_concat.gamma'], params['bn_concat.beta'],
                        params.get('bn_concat.mean'),
                        params.get('bn_concat.var'), training)

    logit = torch.zeros((batch, 1), dtype=emb.dtype, device=cat.device)
    nets = config['nets']
    if 'linear' in nets:
        logit = logit + matmul(torch.cat([emb.sum(dim=-1), dense_bn], dim=1),
                               params['linear.w'].t(), precision)
    if 'fm_nets' in nets:
        s = emb.sum(dim=1)
        logit = logit + 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(
            dim=1, keepdim=True)
    if 'cin_nets' in nets:
        logit = logit + _cin(params, config, emb, precision)
    if 'dnn_nets' in nets:
        activation = ACTIVATIONS[config['dnn_activation']]
        h = concat
        for i in range(len(config['dnn_hidden_units'])):
            h = activation(matmul(h, params[f'dnn.{i}.w'].t(), precision)
                           + params[f'dnn.{i}.b'])
        logit = logit + matmul(h, params['dnn.logit.w'].t(), precision)
    return matmul(logit, params['out.w'].t(), precision) + params['out.b']


def cast(tensors: dict, precision: str) -> dict:
    """Float tensors in float64 for ``'fp64'``, else as they are."""
    if precision != 'fp64':
        return tensors
    return {k: v.double() if v.is_floating_point() else v
            for k, v in tensors.items()}


def bce(logits, y):
    """Sigmoid binary cross-entropy, the mean over the batch."""
    return F.binary_cross_entropy_with_logits(
        logits.reshape(-1), y.reshape(-1).to(logits.dtype))
