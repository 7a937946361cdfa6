"""Initial weights of a configuration, made on the device from the seed.

Each leaf of ``reference.model.param_specs`` is drawn in one call from a
``torch.Generator`` on the device seeded from ``(seed, leaf index)``, so a
single leaf can be drawn again (:func:`leaf`) and the reference gets the
same weights without keeping a copy. The running statistics of the
BatchNorms (read at inference) are set from the inputs' own distribution:
the embeddings' ``U(-0.05, 0.05)`` and the dense inputs' moments, moved by
a few percent; a net's own BatchNorms as its module says
(``perfbench/nets``)."""

import numpy as np
import torch

from .. import nets as nets_lib
from ..reference import model as ref


def _generator(seed: int, index: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _draw(spec, gen, device):
    _, shape, (kind, lo, hi) = spec
    if kind != 'uniform':
        raise ValueError(f'unknown initializer {kind!r}')
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        lo, hi, generator=gen)


def leaf(config, seed: int, device, name: str) -> torch.Tensor:
    """The initial value of one leaf."""
    for index, spec in enumerate(ref.param_specs(config)):
        if spec[0] == name:
            return _draw(spec, _generator(seed, index, device), device)
    raise KeyError(name)


def make(config, seed: int, device) -> dict:
    """``{leaf: tensor}`` for every trained leaf, the ``bn_*.mean`` /
    ``bn_*.var`` running statistics, and those of the BatchNorms the nets
    own (each net's ``statistics``, where it has any), drawn after the
    shared ones."""
    specs = ref.param_specs(config)
    params = {spec[0]: _draw(spec, _generator(seed, i, device), device)
              for i, spec in enumerate(specs)}
    gen = _generator(seed, len(specs), device)

    def draw(shape, lo, hi):
        return torch.empty(shape, dtype=torch.float32, device=device
                           ).uniform_(lo, hi, generator=gen)

    def jitter(values, rel):
        values = torch.as_tensor(values, dtype=torch.float32, device=device)
        return values * (1 + draw(values.shape, -rel, rel))

    n_fields = len(config['vocabulary'])
    dim = int(config['embedding_dim'])
    n_dense = int(config['dense_features'])
    emb_var = 0.05 ** 2 / 3
    mean, var = ref.dense_moments()
    if 'bn_dense.gamma' in params:
        params['bn_dense.mean'] = jitter([mean] * n_dense, 0.05)
        params['bn_dense.var'] = jitter([var] * n_dense, 0.1)
        dense_mean = params['bn_dense.beta']
        dense_var = params['bn_dense.gamma'] ** 2
    else:
        dense_mean = torch.full((n_dense,), mean, device=device)
        dense_var = torch.full((n_dense,), var, device=device)
    emb_mean = draw(n_fields * dim, -0.005, 0.005)
    params['bn_concat.mean'] = torch.cat([emb_mean, dense_mean])
    params['bn_concat.var'] = torch.cat(
        [jitter([emb_var] * (n_fields * dim), 0.1), dense_var])
    for _, net in nets_lib.of(config):
        if hasattr(net, 'statistics'):
            params.update(net.statistics(config, draw))
    return params
