"""Faults planted under the timed path, for the proof that a broken
program reads as not correct (``perfbench/proof.py`` and the tests). Each
is set on the model's instance before the harness's own wrappers, so the
harness records what it handed in and the program computes something else.

- ``unchanged_state``: the optimizer's step does nothing;
- ``half_batch``: a training step sees the first half of its batch only
  (the loss the mean over those rows);
- ``altered_answer``: an inference forward returns the second row's logit
  in place of the first row's;
- ``half_rows``: a request is answered as if the second half of its rows
  were zeros;
- ``cin_tile``: the CIN's second contraction (K4 of layer 1) returns its
  last ``CIN_TILE`` maps as zeros, as a kernel that skipped them would; its
  gradient is left as it was."""

import functools

import torch

CIN_TILE = 8


def _half_batch(original, batch, yb, wb, loss_fn):
    half = len(yb) // 2
    return original({k: v[:half] for k, v in batch.items()}, yb[:half],
                    None if wb is None else wb[:half], loss_fn)


def _altered_answer(original, batch):
    logits, taps = original(batch)
    logits = logits.clone()
    logits[0] = logits[1]
    return logits, taps


def _half_rows(original, arrays, n=None):
    cut = {k: v.copy() for k, v in arrays.items()}
    for v in cut.values():
        v[len(v) // 2:] = 0
    return original(cut, n)


def _plant_cin_tile(model):
    """Set ``cin_tile`` over the port's contraction (a module global of
    ``ops/interactions.py``), replacing one planted before."""
    from deeptables_torch.ops import interactions
    original = getattr(interactions.cin_contract, 'planted_over',
                       interactions.cin_contract)
    target = model.build().cin_layer.f_1

    def contract(x0, h, w, *args):
        z = original(x0, h, w, *args)
        if w is not target:
            return z
        lost = torch.zeros_like(z)
        lost[:, -CIN_TILE:] = z[:, -CIN_TILE:].detach()
        return z - lost

    contract.planted_over = original
    interactions.cin_contract = contract


def apply(name, model, predictor=None):
    """Plant fault ``name`` (None: none) in ``model`` or, for
    ``half_rows``, in ``predictor``."""
    if name is None:
        return
    if name == 'unchanged_state':
        model.optimizer.step = lambda *args, **kwargs: None
    elif name == 'half_batch':
        model._train_step = functools.partial(_half_batch,
                                              model._train_step)
    elif name == 'altered_answer':
        model.forward_batch = functools.partial(_altered_answer,
                                                model.forward_batch)
    elif name == 'cin_tile':
        _plant_cin_tile(model)
    elif name == 'half_rows':
        predictor.predict_proba_arrays = functools.partial(
            _half_rows, predictor.predict_proba_arrays)
    else:
        raise ValueError(f'unknown fault {name!r}')
