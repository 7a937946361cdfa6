# -*- coding:utf-8 -*-
"""Keras-style training callbacks: the port's copy of
``deeptables_tpu/models/callbacks.py``.

The epoch loop of ``DeepModel.fit`` calls the hooks; ``EarlyStopping``
restores the best weights through the model's ``get_state_snapshot`` /
``set_state_snapshot``, and ``ModelCheckpoint`` calls its ``save``.
"""

from ..utils import consts, dt_logging

logger = dt_logging.get_logger(__name__)


class Callback:
    """Base class; subclass and override any of the hooks."""

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class History(Callback):
    def __init__(self):
        self.history = {}
        self.epoch = []

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        self.epoch.append(epoch)
        for k, v in logs.items():
            self.history.setdefault(k, []).append(v)


def _lookup(logs, monitor):
    if logs is None:
        return None
    if monitor in logs:
        return logs[monitor]
    low = str(monitor).lower()
    for k, v in logs.items():
        if str(k).lower() == low:
            return v
    return None


def resolve_mode(monitor, mode='auto'):
    if mode in ('min', 'max'):
        return mode
    return 'max' if str(monitor).lower() in consts.METRICS_BIGGER_IS_BETTER \
        else 'min'


class EarlyStopping(Callback):
    """Stop training when the monitored metric stops improving; optionally
    restore the best weights (parity: keras EarlyStopping as used at
    reference deeptable.py:740-753)."""

    def __init__(self, monitor='val_loss', patience=0, mode='auto',
                 restore_best_weights=False, min_delta=0, baseline=None,
                 verbose=0):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.restore_best_weights = restore_best_weights
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.verbose = verbose
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = None
        self.best_state = None
        self._mode = resolve_mode(self.monitor, self.mode)

    def _is_improvement(self, current):
        if self.best is None:
            return True
        if self._mode == 'max':
            return current > self.best + self.min_delta
        return current < self.best - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        current = _lookup(logs, self.monitor)
        if current is None:
            logger.warning(
                f'EarlyStopping: monitored metric {self.monitor!r} not found '
                f'in logs {list((logs or {}).keys())}')
            return
        if self._is_improvement(current):
            self.best = current
            self.wait = 0
            if self.restore_best_weights:
                self.best_state = self.model.get_state_snapshot()
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True
                if self.restore_best_weights and self.best_state is not None:
                    if self.verbose:
                        logger.info(
                            'EarlyStopping: restoring best model weights.')
                    self.model.set_state_snapshot(self.best_state)

    def on_train_end(self, logs=None):
        # keras restores best weights at stop time; if training ended without
        # triggering, restore the best snapshot anyway (same net effect for
        # patience>=1 with restore_best_weights=True).
        if self.restore_best_weights and self.best_state is not None \
                and not getattr(self.model, 'stop_training', False):
            self.model.set_state_snapshot(self.best_state)


class ModelCheckpoint(Callback):
    """Save the model every epoch (or only on improvement)."""

    def __init__(self, filepath, monitor='val_loss', save_best_only=False,
                 mode='auto', verbose=0, save_weights_only=False,
                 save_freq='epoch'):
        self.filepath = filepath
        self.monitor = monitor
        self.save_best_only = save_best_only
        self.mode = mode
        self.verbose = verbose
        self.best = None

    def on_train_begin(self, logs=None):
        self._mode = resolve_mode(self.monitor, self.mode)

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        path = self.filepath.format(epoch=epoch + 1, **logs)
        if self.save_best_only:
            current = _lookup(logs, self.monitor)
            if current is None:
                return
            improved = self.best is None or (
                current > self.best if self._mode == 'max'
                else current < self.best)
            if not improved:
                return
            self.best = current
        if self.verbose:
            logger.info(f'ModelCheckpoint: saving model to {path}')
        self.model.save(path)


class LambdaCallback(Callback):
    def __init__(self, on_epoch_begin=None, on_epoch_end=None,
                 on_train_begin=None, on_train_end=None):
        if on_epoch_begin:
            self.on_epoch_begin = on_epoch_begin
        if on_epoch_end:
            self.on_epoch_end = on_epoch_end
        if on_train_begin:
            self.on_train_begin = on_train_begin
        if on_train_end:
            self.on_train_end = on_train_end
