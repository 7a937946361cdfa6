# -*- coding:utf-8 -*-
"""The port's optimizers against optax, which the JAX package trains with,
on the CPU.

Each optimizer name of the JAX package's ``_resolve_optimizer`` runs five
updates on the same parameters and gradients (numpy seeds) in both, among
them a tensor of zeros (LAMB's trust ratio falls back to 1 there) and one
whose gradient is zero for a step. Then one train step of a bridged small
DeepFM in each package's ``DeepModel.fit``, with the embedding tables'
padding rows zeroed on the JAX side (its lane-packed tables hold rows no
column reads; their norm would enter LAMB's trust ratio and AdamW's
decay). Tolerances: the five updates rtol 1e-6 with an absolute term of
1e-6 times the largest magnitude of the tensor (the same float32 updates;
the two frameworks sum the norms in other orders), but 1e-5 for
``torch.optim``'s Adam and AdamW, which take the bias correction
``1 - b2^t`` in double precision where optax rounds b2 = 0.999 to float32
first (1.3e-5 off at t = 1, 6.4e-6 of the step); the DeepFM step atol
2e-5 (the step scales gradients that agree to rtol 1e-5 by lr 1e-3, or to
a trust ratio of the table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeptables_torch import bridge
from deeptables_torch.models import deepmodel
from deeptables_torch.ops import optimizers
from torch_parity import Case

NAMES = ('auto', 'adam', 'adamw', 'sgd', 'rmsprop', 'adagrad', 'lamb')
SHAPES = {'w': (7, 5), 'b': (5,), 'zeros': (3, 4), 'table': (11, 8)}
LR = 0.01
# torch.optim's own Adam family and their tolerance against optax
TORCH_ADAMS, ADAM_RTOL = ('auto', 'adam', 'adamw'), 1e-5


def _close(actual, expected, rtol=1e-6, err_msg=''):
    expected = np.asarray(expected)
    scale = float(np.abs(expected).max())
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


@pytest.mark.parametrize('name', NAMES)
def test_five_updates_match_optax(name):
    rng = np.random.default_rng(len(name))
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in SHAPES.items()}
    params['zeros'][:] = 0
    tx = optax.adam(LR) if name == 'auto' else getattr(optax, name)(LR)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jax_params)
    port_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                   for k, v in params.items()}
    opt = deepmodel._resolve_optimizer(name.upper(), LR,
                                       list(port_params.values()))
    for step in range(5):
        grads = {k: rng.normal(0, 0.1 * (step + 1), s).astype(np.float32)
                 for k, s in SHAPES.items()}
        if step == 2:
            grads['b'][:] = 0
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, opt_state,
            jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, p in port_params.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in SHAPES:
            _close(port_params[k].detach().numpy(), jax_params[k],
                   rtol=ADAM_RTOL if name in TORCH_ADAMS else 1e-6,
                   err_msg=f'{name} step {step + 1} {k}')


def test_optimizer_classes_and_defaults():
    params = [torch.nn.Parameter(torch.zeros(2))]
    r = deepmodel._resolve_optimizer
    adamw = r('adamw', 1e-3, params)
    assert type(adamw) is torch.optim.AdamW
    assert adamw.defaults['weight_decay'] == 1e-4
    assert adamw.defaults['eps'] == 1e-8
    assert type(r('rmsprop', 1e-3, params)) is optimizers.RMSprop
    assert r('rmsprop', 1e-3, params).defaults['decay'] == 0.9
    assert r('adagrad', 1e-3, params).defaults[
        'initial_accumulator_value'] == 0.1
    lamb = r('lamb', 1e-3, params)
    assert lamb.defaults['eps'] == 1e-6 and lamb.defaults['weight_decay'] == 0
    # in place of an optax transformation: an Optimizer subclass or a
    # callable params -> Optimizer
    sgd = r(torch.optim.SGD, 0.5, params)
    assert type(sgd) is torch.optim.SGD and sgd.defaults['lr'] == 0.5
    made = r(lambda p: torch.optim.SGD(p, lr=0.25), 1e-3, params)
    assert made.defaults['lr'] == 0.25
    for bad in ('no_such', 3, lambda p: None, optax.adam(1e-3)):
        with pytest.raises(ValueError):
            r(bad, 1e-3, params)


@pytest.mark.parametrize('name', ['adamw', 'rmsprop', 'adagrad', 'lamb'])
def test_bridged_deepfm_step_matches_jax(name):
    case = Case('nonascending_d16', optimizer=name)
    X = case.dataframe(48, seed=3)
    y = case.labels(48, seed=4)
    X_val, y_val = case.dataframe(16, seed=5), case.labels(16, seed=6)
    case.jax_model.fit(X, y, batch_size=48, epochs=1, verbose=0,
                       validation_data=(X_val, y_val))
    port = case.port_model()
    port.fit(X, y, batch_size=48, epochs=1, verbose=0,
             validation_data=(X_val, y_val))
    assert type(port.optimizer).__name__.lower() == name
    expected = bridge.state_dict_from_flax(
        jax.device_get(case.jax_model.variables), case.port_cats,
        case.port_conts, case.port_config)
    for key, value in port.module.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   rtol=0, atol=2e-5, err_msg=key)
