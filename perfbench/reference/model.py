"""The plain PyTorch model of a configuration, as DeepTables defines it.

The benchmark's reference: it imports nothing of the measured package and
takes only what the harness made (inputs, initial weights). Every tensor is
float32. Matrix products go through :func:`matmul`, which runs in IEEE
float32 (``precision='fp32'``, TF32 off) or, for the control, with its
operands rounded to TF32 as the tensor cores round them
(``precision='tf32'``, forward and backward).

``precision='fp64'`` runs the same model in float64 (the caller casts the
weights and inputs): the reference that judges the program, since float32
itself lies as far from the exact result as the program may.

The model (``config``: a configuration file of ``perfbench/configs``):

- one embedding table of ``Σ (vocabulary_j + 1)`` rows and D columns;
  column j's ids index its own region, which starts at the sum of the
  regions before it;
- the dense inputs, where the configuration has any (``dense_features``),
  go through a BatchNorm (``dense_batch_norm``);
- ``concat`` = [flattened embeddings (F·D), normalised dense] through a
  second BatchNorm;
- BatchNorm as flax computes it: batch mean and the biased variance
  ``E[x²] − E[x]²`` (clamped at 0) in training, the running statistics at
  inference, epsilon 1e-3;
- the configuration's nets (``perfbench/nets/<net>.py``), each a logit
  from :class:`Parts`, added in the configuration's order;
- the head: a Dense with bias from the summed logit to the logit.
"""

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import nets as nets_lib

BN_EPSILON = 1e-3


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


def he(fan_in):
    """He's uniform initializer of a layer of ``fan_in`` inputs."""
    limit = math.sqrt(6.0 / fan_in)
    return ('uniform', -limit, limit)


def lecun(fan_in):
    """LeCun's uniform initializer of a layer of ``fan_in`` inputs."""
    limit = math.sqrt(3.0 / fan_in)
    return ('uniform', -limit, limit)


SMALL = ('uniform', -0.05, 0.05)
GAMMA = ('uniform', 0.8, 1.2)
BETA = ('uniform', -0.1, 0.1)


def concat_width(config) -> int:
    return len(config['vocabulary']) * int(config['embedding_dim']) + \
        int(config['dense_features'])


def param_specs(config):
    """The trained leaves, in a fixed order: ``[(name, shape, init)]`` with
    ``init`` one of ``('uniform', lo, hi)``: the table, the BatchNorms, each
    net's leaves in the configuration's order, the head."""
    dim = int(config['embedding_dim'])
    n_dense = int(config['dense_features'])
    concat = concat_width(config)
    specs = [('embeddings', (sum(table_rows(config)), dim), SMALL)]
    if n_dense and config.get('dense_batch_norm', True):
        specs += [('bn_dense.gamma', (n_dense,), GAMMA),
                  ('bn_dense.beta', (n_dense,), BETA)]
    specs += [('bn_concat.gamma', (concat,), GAMMA),
              ('bn_concat.beta', (concat,), BETA)]
    for _, net in nets_lib.of(config):
        specs += net.param_specs(config)
    specs += [('out.w', (1, 1), lecun(1)), ('out.b', (1,), SMALL)]
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


class Parts(NamedTuple):
    """What the nets read: the stacked embeddings ``(B, F, D)``, the
    normalised dense inputs ``(B, n_dense)`` (no columns where the
    configuration has none) and the BatchNormed concatenation ``(B, F·D +
    n_dense)``."""
    embeddings: torch.Tensor
    dense: torch.Tensor
    concat: torch.Tensor


def forward(params, config, cat, dense, training, precision='fp32'):
    """Logits ``(B, 1)`` of int64 column-local ids ``cat (B, F)`` and float32
    ``dense (B, n_dense)``. ``params`` holds :func:`param_specs`' leaves and,
    for inference, the running statistics ``bn_*.mean`` / ``bn_*.var`` and
    those of the nets' own BatchNorms."""
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

    parts = Parts(emb, dense_bn, concat)
    logit = torch.zeros((batch, 1), dtype=emb.dtype, device=cat.device)
    for _, net in nets_lib.of(config):
        logit = logit + net.forward(params, config, parts, training,
                                    precision)
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
