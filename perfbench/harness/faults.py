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
- a net's own faults, by the name its module gives them (``faults`` of
  ``perfbench/nets/faults/<net>.py``)."""

import functools
import importlib

from .. import nets as nets_lib


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


def of_nets(config) -> dict:
    """``{fault: plant(model)}`` of every net of the configuration that
    has a ``nets/faults/<net>.py``."""
    out = {}
    for name in config['nets']:
        nets_lib.path(name)
        if (nets_lib.NETS_DIR / 'faults' / f'{name}.py').is_file():
            out.update(importlib.import_module(
                f'{nets_lib.__name__}.faults.{name}').faults)
    return out


def apply(name, config, model, predictor=None):
    """Plant fault ``name`` (None: none) in ``model`` of ``config`` or, for
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
    elif name == 'half_rows':
        predictor.predict_proba_arrays = functools.partial(
            _half_rows, predictor.predict_proba_arrays)
    else:
        plant = of_nets(config).get(name)
        if plant is None:
            raise ValueError(f'unknown fault {name!r}')
        plant(model)
