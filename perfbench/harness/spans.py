"""Spans and records around the port's entry points, from the harness's
side: each wrapper is set on the instance (the class is untouched) and
removed by :meth:`Probe.remove`.

Spans are ``torch.profiler.record_function`` ranges named ``perfbench.*``;
outside a profiled stretch they record nothing. Records are plain Python
counts and lists that the drivers and metric readers read."""

import functools

from torch.profiler import record_function

TRAIN_STEP = 'perfbench.train_step'
OPTIMIZER_STEP = 'perfbench.optimizer_step'
FORWARD = 'perfbench.forward'
REQUEST = 'perfbench.request'
STRETCH = 'perfbench.stretch'


class Probe:
    """Wraps ``DeepModel._train_step``, its optimizer's ``step`` and
    ``DeepModel.forward_batch``.

    - ``on_train_step(batch, yb, wb, loss)`` and ``on_optimizer_step(n)``
      (n counts the steps from 1) are called after each, when given;
    - ``forward_rows`` lists the rows of each inference forward (a padded
      chunk of a request, a validation batch)."""

    def __init__(self, model, on_train_step=None, on_optimizer_step=None):
        self.model = model
        self.on_train_step = on_train_step
        self.on_optimizer_step = on_optimizer_step
        self.optimizer_steps = 0
        self.forward_rows = []
        self._wrapped = []
        self._wrap(model, '_train_step', self._train_step)
        self._wrap(model, 'forward_batch', self._forward_batch)
        if model.optimizer is not None:
            self._wrap(model.optimizer, 'step', self._optimizer_step)

    def _wrap(self, obj, name, wrapper):
        original = getattr(obj, name)
        self._wrapped.append((obj, name, obj.__dict__.get(name)))
        setattr(obj, name, functools.partial(wrapper, original))

    def _train_step(self, original, batch, yb, wb, loss_fn):
        with record_function(TRAIN_STEP):
            loss, logits = original(batch, yb, wb, loss_fn)
        if self.on_train_step is not None:
            self.on_train_step(batch, yb, wb, loss)
        return loss, logits

    def _optimizer_step(self, original, *args, **kwargs):
        with record_function(OPTIMIZER_STEP):
            out = original(*args, **kwargs)
        self.optimizer_steps += 1
        if self.on_optimizer_step is not None:
            self.on_optimizer_step(self.optimizer_steps)
        return out

    def _forward_batch(self, original, batch):
        self.forward_rows.append(len(next(iter(batch.values()))))
        with record_function(FORWARD):
            return original(batch)

    def remove(self):
        for obj, name, own in reversed(self._wrapped):
            if own is None:
                delattr(obj, name)
            else:
                setattr(obj, name, own)
        self._wrapped = []
