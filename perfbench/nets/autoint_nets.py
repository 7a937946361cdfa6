"""``autoint_nets``: AutoInt's interacting layers over the stacked embeddings
(arXiv:1810.11921, Eq. 5-8), as DeepTables builds them, with the port's
``autoint_params['num_units']`` setting the width of every layer.

Layer i maps ``x (B, F, U_in)`` to ``(B, F, U)``, U = H·dh (U_in = D for
layer 0, U after it):

- ``q, k, v = relu(x·W_{Q,K,V}ᵀ + b)``, each ``(B, F, U)``;
- per head h, ``α = softmax_g(⟨q_f^h, k_g^h⟩ / √dh)`` and
  ``ẽ_f^h = Σ_g α_fg v_g^h`` (Eq. 5-6), the heads side by side (Eq. 7);
- ``relu(ẽ + relu(x·W_Resᵀ + b_Res))`` (Eq. 8's residual), then a
  BatchNorm over U (its rows the B·F (example, field) pairs);

then the last layer's ``(B, F·U)`` through a Dense without bias to one
logit (``dense_logit_autoint_nets``).

Departures from the paper, each DeepTables' structure (and so the port's):
relu on the Q, K, V and residual projections and biases on all four; the
``1/√dh`` score scale; a BatchNorm after every layer; the flattened F·U
output into one logit beside the model's other nets. The paper's attention
dropout is 0 here (``autoint_dropout_rate``; the reference draws no masks).

Its kernels: K5 (``fa_fwd``, the attention of a layer; ``fa_bwd``, its
gradient), ``csrc/field_attention.cu``."""

import functools
import math
import re

import torch

from ..counts.bounds import KernelBound, least_time
from ..reference import model as ref

PROJECTIONS = ('q', 'k', 'v')
RESIDUAL = 'r'


def _heads(config) -> int:
    return int(config['autoint_num_heads'])


def _projections(config):
    residual = bool(config.get('autoint_use_residual', True))
    return PROJECTIONS + ((RESIDUAL,) if residual else ())


def widths(config):
    """``[(U_in, U)]`` of each interacting layer."""
    if float(config.get('autoint_dropout_rate', 0)) != 0:
        raise ValueError('autoint_dropout_rate: the reference computes 0 '
                         'only (it draws no dropout masks)')
    units = int(config['autoint_num_units'])
    if units % _heads(config):
        raise ValueError(f'autoint_num_units {units} is no multiple of '
                         f'autoint_num_heads {_heads(config)}')
    out, width = [], int(config['embedding_dim'])
    for _ in range(int(config['autoint_num_attention'])):
        out.append((width, units))
        width = units
    return out


def param_specs(config):
    """Each layer's projections ``(U, U_in)`` with biases, its BatchNorm's
    scale and offset, then the logit's Dense ``(1, F·U)``."""
    specs = []
    for i, (n_in, units) in enumerate(widths(config)):
        for p in _projections(config):
            specs += [(f'autoint.{i}.{p}.w', (units, n_in), ref.he(n_in)),
                      (f'autoint.{i}.{p}.b', (units,), ref.SMALL)]
        specs += [(f'autoint.{i}.bn.gamma', (units,), ref.GAMMA),
                  (f'autoint.{i}.bn.beta', (units,), ref.BETA)]
    flat = len(config['vocabulary']) * widths(config)[-1][1]
    return specs + [('autoint.logit.w', (1, flat), ref.lecun(flat))]


class _TF32BatchMatMul(torch.autograd.Function):
    """``a @ b`` of batched float32 operands, each rounded to TF32 first;
    the backward's products likewise (``reference.model``'s TF32 product
    over the last two axes)."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = ref.tf32_round(a), ref.tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ref.tf32_round(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


def _bmm(a, b, precision):
    if precision == 'tf32':
        return _TF32BatchMatMul.apply(a, b)
    return a @ b


def _project(x, params, name, precision):
    batch, n_fields, n_in = x.shape
    y = ref.matmul(x.reshape(batch * n_fields, n_in),
                   params[f'{name}.w'].t(), precision) + params[f'{name}.b']
    return torch.relu(y).reshape(batch, n_fields, -1)


def attend(q, k, v, heads, precision):
    """Eq. 5-7: each head's softmax over the fields of its scaled scores,
    its weighted sum of v, the heads side by side: ``(B, F, U)``."""
    batch, n_fields, units = q.shape
    dh = units // heads
    qh, kh, vh = (t.reshape(batch, n_fields, heads, dh).transpose(1, 2)
                  for t in (q, k, v))
    scores = _bmm(qh, kh.transpose(-1, -2), precision) / math.sqrt(dh)
    out = _bmm(torch.softmax(scores, dim=-1), vh, precision)
    return out.transpose(1, 2).reshape(batch, n_fields, units)


def forward(params, config, parts, training, precision):
    x = parts.embeddings
    heads = _heads(config)
    for i, (_, units) in enumerate(widths(config)):
        qkv = [_project(x, params, f'autoint.{i}.{p}', precision)
               for p in PROJECTIONS]
        out = attend(*qkv, heads, precision)
        if RESIDUAL in _projections(config):
            out = out + _project(x, params, f'autoint.{i}.{RESIDUAL}',
                                 precision)
        out = torch.relu(out)
        batch, n_fields, _ = out.shape
        bn = f'autoint.{i}.bn'
        x = ref.batch_norm(out.reshape(batch * n_fields, units),
                           params[f'{bn}.gamma'], params[f'{bn}.beta'],
                           params.get(f'{bn}.mean'), params.get(f'{bn}.var'),
                           training).reshape(batch, n_fields, units)
    flat = x.reshape(x.shape[0], -1)
    logit = ref.matmul(flat, params['autoint.logit.w'].t(), precision)
    # the model normalises the concatenation whatever reads it; where no
    # net of the configuration reads it, the port's optimizer leaves its
    # BatchNorm as it was (no gradient reaches it), and the reference's
    # gradient of those leaves is exactly 0, which ``torch.autograd.grad``
    # gives only for a leaf inside the graph: hence this exact 0
    return logit + 0 * parts.concat.sum(dim=1, keepdim=True)


def layer_ops(n_fields: int, n_in: int, units: int, n_projections: int,
              heads: int) -> int:
    """One example's interacting layer: the projections with their biases
    (2·U_in·U + U a field each), the attention's two products (2·F·dh a
    field each, per head and field: ``fa_bound``'s forward operations) and
    the residual sum (U a field)."""
    dh = units // heads
    projections = n_projections * n_fields * (2 * n_in * units + units)
    attention = 4 * n_fields * n_fields * dh * heads
    return projections + attention + n_fields * units


def ops_per_row(config):
    n_fields = len(config['vocabulary'])
    n_proj = len(_projections(config))
    ops = sum(layer_ops(n_fields, n_in, units, n_proj, _heads(config))
              for n_in, units in widths(config))
    # the logit's Dense over the flattened last layer
    return ops + 2 * n_fields * widths(config)[-1][1]


def statistics(config, draw):
    """Each layer's BatchNorm running statistics, about what its input
    holds after the residual's relu: non-negative, of a mean and variance
    that grow from the embeddings' scale in layer 0 to the normalised
    inputs' after it."""
    out = {}
    for i, (_, units) in enumerate(widths(config)):
        lo, hi = (0.01, 0.05) if i == 0 else (0.3, 0.8)
        out[f'autoint.{i}.bn.mean'] = draw((units,), lo, hi)
        out[f'autoint.{i}.bn.var'] = draw((units,), lo * lo, hi * hi)
    return out


def port_settings(config):
    return {'autoint_params': {
        'num_attention': int(config['autoint_num_attention']),
        'num_heads': _heads(config),
        'num_units': int(config['autoint_num_units']),
        'dropout_rate': 0,
        'use_residual': bool(config.get('autoint_use_residual', True))}}


_DENSE = {'q': 'dense_Q', 'k': 'dense_K', 'v': 'dense_V',
          RESIDUAL: 'dense_residual'}


def port_names(config):
    names = {'autoint.logit.w': 'dense_logit_autoint_nets.weight'}
    for i in range(len(widths(config))):
        block = f'autoint_attention_{i}'
        for p in _projections(config):
            names[f'autoint.{i}.{p}.w'] = f'{block}.{_DENSE[p]}.weight'
            names[f'autoint.{i}.{p}.b'] = f'{block}.{_DENSE[p]}.bias'
        for key, port in (('gamma', 'weight'), ('beta', 'bias'),
                          ('mean', 'running_mean'), ('var', 'running_var')):
            names[f'autoint.{i}.bn.{key}'] = \
                f'{block}.batch_normalize.{port}'
    return names


def kernel_calls(config, rows, phase):
    """K5's forward once a layer in a forward; its backward once a layer in
    a training step's backward: shapes ``(B, F, H, dh)``."""
    n_fields, heads = len(config['vocabulary']), _heads(config)
    shapes = [(rows, n_fields, heads, units // heads)
              for _, units in widths(config)]
    calls = {'fa_fwd': shapes}
    if phase == 'train':
        calls['fa_bwd'] = list(shapes)
    return calls


def fa_bound(kernel: str, B: int, F: int, H: int, dh: int, itemsize: int):
    """Least time of the field attention (``'fa_fwd'``, K5-fwd) or its
    gradient (``'fa_bwd'``, K5-bwd) in seconds, and its operations. Bytes:
    q, k, v read and the output written (forward); q, k, v and do read and
    dq, dk, dv written (backward), each ``(B, F, H·dh)`` in the input type.
    Operations, per example, head and query field: the scores and the
    weighted sum, 2·F·dh each (forward); the backward recomputes the scores
    and takes dw = do·vᵀ, dv, dq and dk, 2·F·dh each."""
    elements = B * F * H * dh
    if kernel == 'fa_fwd':
        nbytes, ops = 4 * elements * itemsize, 4 * F * elements
    elif kernel == 'fa_bwd':
        nbytes, ops = 7 * elements * itemsize, 10 * F * elements
    else:
        raise ValueError(kernel)
    return least_time(ops, nbytes, itemsize), ops


def _named(kind):
    """Whether a device kernel is K5's ``kind`` (``'fa_fwd'`` or
    ``'fa_bwd'``), in its tile or its one-warp design."""
    pattern = re.compile(rf'\b{kind}(_tile)?_kernel\b')
    return lambda name: bool(pattern.search(name))


# each K5 call is one device kernel
bounds = {kind: KernelBound(functools.partial(fa_bound, kind), _named(kind),
                            _named(kind))
          for kind in ('fa_fwd', 'fa_bwd')}
