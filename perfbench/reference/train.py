"""Plain Adam steps of the reference model (``reference/model.py``).

Adam as published (Kingma and Ba) and as optax and ``torch.optim.Adam``
apply it: ``m = β1·m + (1 − β1)·g``, ``v = β2·v + (1 − β2)·g²``,
``p −= lr·m̂ / (√v̂ + ε)`` with the bias-corrected ``m̂``, ``v̂``; every leaf
dense, every row of the table updated each step. Its constants are the
published defaults, which ``torch.optim.Adam`` takes.
"""

import torch

from . import model as ref

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def adam_steps(params0, config, batches, precision='fp32'):
    """Run ``len(batches)`` steps from ``params0`` (``{leaf: tensor}``, left
    unchanged) over ``[(cat int64, dense, y)]``. Returns ``{'losses': [...],
    'grad_norms': {leaf: norm of step 1's gradient}, 'change_norms': {leaf:
    norm of the change after the last step}}``. ``precision``: that of
    ``reference.model.matmul``, or ``'fp64'`` for the whole model."""
    beta1, beta2, eps = BETA1, BETA2, EPS
    lr = float(config['learning_rate'])
    names = [name for name, _, _ in ref.param_specs(config)]
    params = {k: v.detach().clone()
              for k, v in ref.cast(params0, precision).items()}
    for name in names:
        params[name].requires_grad_(True)
    m = {name: torch.zeros_like(params[name]) for name in names}
    v = {name: torch.zeros_like(params[name]) for name in names}
    losses, grad_norms = [], {}
    with ref.ieee_float32():
        for t, (cat, dense, y) in enumerate(batches, 1):
            dense = ref.cast({'x': dense}, precision)['x']
            loss = ref.bce(ref.forward(params, config, cat, dense, True,
                                       precision), y)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            losses.append(loss.item())
            if t == 1:
                grad_norms = {n: float(torch.linalg.vector_norm(g))
                              for n, g in zip(names, grads)}
            with torch.no_grad():
                c1 = 1 - beta1 ** t
                c2 = 1 - beta2 ** t
                for n, g in zip(names, grads):
                    m[n].mul_(beta1).add_(g, alpha=1 - beta1)
                    v[n].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                    step = (m[n] / c1) / ((v[n] / c2).sqrt() + eps)
                    params[n].sub_(lr * step)
            del grads
    change = {n: float(torch.linalg.vector_norm(
        params[n].detach() - params0[n].to(params[n].dtype))) for n in names}
    return {'losses': losses, 'grad_norms': grad_norms,
            'change_norms': change}
