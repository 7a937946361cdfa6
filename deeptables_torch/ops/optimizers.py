# -*- coding:utf-8 -*-
"""Optimizers whose update rules are optax's (0.2.6), which the JAX
package trains with, where ``torch.optim`` has no equal.

- :class:`RMSprop`: ``optax.rmsprop`` — decay 0.9, ν from 0,
  ``p -= lr·g·rsqrt(ν + eps)`` with eps 1e-8 *inside* the root
  (``torch.optim.RMSprop`` keeps alpha 0.99 and eps outside the root).
- :class:`Adagrad`: ``optax.adagrad`` — accumulator from 0.1,
  ``p -= lr·g·rsqrt(t + 1e-7)`` where t > 0, else no step.
- :class:`Lamb`: ``optax.lamb`` — Adam's moments (b1 0.9, b2 0.999,
  eps 1e-6 outside the root), decoupled weight decay, then the update of
  each parameter tensor scaled by the trust ratio ``‖p‖ / ‖u‖`` (1 where
  either norm is 0); torch has no LAMB. A row-sharded embedding table
  (one with ``row_sharding``, ``parallel/sharded_embedding.py``) takes
  ``‖p‖`` and ``‖u‖`` of the whole table: the squared norms of the shards
  summed over the model axis, so its trust ratio is the replicated table's.

Adam, AdamW (decay 1e-4, decoupled: the same update as ``optax.adamw``)
and SGD are ``torch.optim``'s own; ``DeepModel`` picks them by name. They
take Adam's bias corrections in double precision where optax takes them in
float32 (``1 - 0.999`` is 1.3e-5 off in float32), so their steps differ
from optax's by up to ~1e-5 of a step.
A parameter without a gradient is skipped, as ``torch.optim`` does.
"""

import torch
import torch.distributed as dist


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


class RMSprop(torch.optim.Optimizer):
    def __init__(self, params, lr=1e-3, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            decay, eps, lr = group['decay'], group['eps'], group['lr']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['nu'] = torch.zeros_like(p)
                nu = state['nu']
                g = p.grad
                nu.copy_((1 - decay) * torch.square(g) + decay * nu)
                p.add_(torch.rsqrt(nu + eps) * g, alpha=-lr)
        return loss


class Adagrad(torch.optim.Optimizer):
    def __init__(self, params, lr=1e-3, initial_accumulator_value=0.1,
                 eps=1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            eps, lr = group['eps'], group['lr']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['sum_of_squares'] = torch.full_like(
                        p, group['initial_accumulator_value'])
                acc = state['sum_of_squares']
                g = p.grad
                acc.copy_(torch.square(g) + acc)
                inv_sqrt = torch.where(acc > 0, torch.rsqrt(acc + eps),
                                       torch.zeros_like(acc))
                p.add_(inv_sqrt * g, alpha=-lr)
        return loss


class Lamb(torch.optim.Optimizer):
    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            (b1, b2), eps, lr = group['betas'], group['eps'], group['lr']
            weight_decay = group['weight_decay']
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['count'] = 0
                    state['mu'] = torch.zeros_like(p)
                    state['nu'] = torch.zeros_like(p)
                g = p.grad
                mu, nu = state['mu'], state['nu']
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * torch.square(g) + b2 * nu)
                state['count'] += 1
                count = state['count']
                # the bias corrections in float32, as optax takes them
                mu_hat = mu / (1 - _f32(b1) ** count)
                nu_hat = nu / (1 - _f32(b2) ** count)
                update = mu_hat / (torch.sqrt(nu_hat) + eps)
                if weight_decay:
                    update = update + weight_decay * p
                param_norm = torch.linalg.vector_norm(p)
                update_norm = torch.linalg.vector_norm(update)
                sharding = getattr(p, 'row_sharding', None)
                if sharding is not None:
                    sq = torch.stack([param_norm, update_norm]).square()
                    dist.all_reduce(sq, group=sharding.axis.group)
                    param_norm, update_norm = sq.sqrt().unbind()
                trust_ratio = torch.where(
                    (param_norm == 0) | (update_norm == 0),
                    torch.ones_like(param_norm), param_norm / update_norm)
                p.add_(update * trust_ratio, alpha=-lr)
        return loss
