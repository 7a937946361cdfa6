"""``cin_nets``: xDeepFM's Compressed Interaction Network over the stacked
embeddings (arXiv:1803.05170, Eq. 6), as DeepTables builds it.

Layer i: ``z_bld = Σ_fg x0_bfd·h_bgd·W_lfg``, then ``cin_activation``; with
``cin_direct`` every layer passes all its maps on and outputs them all,
else every layer but the last passes half of its maps on and outputs the
other half; the outputs' sums over d through a Dense with bias. Its
kernels: K4 (``cin_fwd``, the contraction) and K3 (``cin_bwd``, its
gradient), ``csrc/cin.cu``."""

import functools
import re

import torch

from . import ACTIVATIONS
from ..counts.bounds import KernelBound, least_time
from ..reference import model as ref

def maps(config):
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
    """CIN weights ``(L, F, G)``, then the output Dense."""
    n_fields = len(config['vocabulary'])
    layers, width = maps(config)
    specs = [(f'cin.{i}.w', (size, n_fields, g), ref.he(n_fields * g))
             for i, (size, g) in enumerate(layers)]
    return specs + [('cin.out.w', (1, width), ref.lecun(width)),
                    ('cin.out.b', (1,), ref.SMALL)]



def forward(params, config, parts, training, precision):
    emb = parts.embeddings
    batch, n_fields, dim = emb.shape
    layers, _ = maps(config)
    activation = ACTIVATIONS[config['cin_activation']]
    direct = bool(config.get('cin_direct', False))
    hidden, outs = emb, []
    for i, (size, g) in enumerate(layers):
        pair = emb[:, :, None, :] * hidden[:, None, :, :]  # (B, F, G, D)
        cols = pair.reshape(batch, n_fields * g, dim).permute(1, 0, 2)
        z = ref.matmul(params[f'cin.{i}.w'].reshape(size, n_fields * g),
                       cols.reshape(n_fields * g, batch * dim), precision)
        z = activation(z.reshape(size, batch, dim).permute(1, 0, 2))
        if direct or i == len(layers) - 1:
            hidden = z
            outs.append(z)
        else:
            hidden, out = z[:, :size // 2], z[:, size // 2:]
            outs.append(out)
    result = torch.cat(outs, dim=1).sum(dim=-1)
    return ref.matmul(result, params['cin.out.w'].t(), precision) \
        + params['cin.out.b']


def layer_ops(n_fields: int, g: int, n_maps: int, dim: int) -> int:
    """One example's CIN layer: the pair products (F·G a column) and the
    GEMM (2·L·F·G a column), D columns; :func:`cin_bound`'s operations over
    one example."""
    return dim * (2 * n_maps * n_fields * g + n_fields * g)


def ops_per_row(config):
    n_fields = len(config['vocabulary'])
    dim = int(config['embedding_dim'])
    layers, width = maps(config)
    ops = sum(layer_ops(n_fields, g, n_maps, dim) for n_maps, g in layers)
    # the sums over d, then the output Dense with its bias
    return ops + width * dim + 2 * width + 1


def port_settings(config):
    return {'cin_params': {
        'cross_layer_size': tuple(config['cin_cross_layer_size']),
        'activation': config['cin_activation'], 'use_residual': False,
        'use_bias': False, 'direct': bool(config.get('cin_direct', False)),
        'reduce_D': False}}


def port_names(config):
    names = {f'cin.{i}.w': f'cin_layer.f_{i}'
             for i in range(len(maps(config)[0]))}
    names['cin.out.w'] = 'cin_layer.exFM_out.weight'
    names['cin.out.b'] = 'cin_layer.exFM_out.bias'
    return names


def kernel_calls(config, rows, phase):
    """K4 once a layer in a forward; K3 once a layer in a training step's
    backward: shapes ``(B, F, G, L, D)``."""
    n_fields, dim = len(config['vocabulary']), int(config['embedding_dim'])
    shapes = [(rows, n_fields, g, n_maps, dim)
              for n_maps, g in maps(config)[0]]
    calls = {'cin_fwd': shapes}
    if phase == 'train':
        calls['cin_bwd'] = list(shapes)
    return calls


def cin_bound(kernel: str, B: int, F: int, G: int, L: int, D: int,
              itemsize: int):
    """Least time of the CIN contraction (``'cin_fwd'``, K4) or its
    gradient (``'cin_bwd'``, K3) in seconds, and its operations. Bytes:
    each input read once, each output written once (z and dW float32, dx0
    and dh in the input type). Operations: the GEMM (2·L·F·G per column)
    and the pair products (F·G per column); the gradient twice the GEMM
    (dpair and dW) and 5·F·G per column (pair, dx0 and dh products and
    sums). Every operation at the tensor cores' rate on the input type."""
    N = B * D
    if kernel == 'cin_fwd':
        nbytes = itemsize * (N * F + N * G + L * F * G) + 4 * L * N
        ops = 2 * L * F * G * N + F * G * N
    elif kernel == 'cin_bwd':
        nbytes = itemsize * (2 * N * F + 2 * N * G + L * F * G + L * N) \
            + 4 * L * F * G
        ops = 4 * L * F * G * N + 5 * F * G * N
    else:
        raise ValueError(kernel)
    return least_time(ops, nbytes, itemsize), ops


_CIN_KERNEL = re.compile(r'\bcin_\w*kernel\b')


def _named(*parts):
    """Whether a device kernel is one of ``csrc/cin.cu``'s and its name
    holds one of ``parts``."""
    return lambda name: bool(_CIN_KERNEL.search(name)) and any(
        p in name for p in parts)


# K4 is one kernel a call; K3 is its dx0/dh pass (once a call), its dW
# pass and ``cin_sum``, which sums K3's dx0 and dW partials
bounds = {
    'cin_fwd': KernelBound(functools.partial(cin_bound, 'cin_fwd'),
                           _named('cin_fwd'), _named('cin_fwd')),
    'cin_bwd': KernelBound(functools.partial(cin_bound, 'cin_bwd'),
                           _named('cin_bwd', 'cin_sum'),
                           _named('cin_bwd_dx')),
}
