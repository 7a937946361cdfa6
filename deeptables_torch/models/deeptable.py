# -*- coding:utf-8 -*-
"""Training and inference orchestrator for tabular data (counterpart of
``deeptables_tpu/models/deeptable.py``).

``DeepTable`` fits the host preprocessor, then trains port ``DeepModel``s
on its output: ``fit``, k-fold ``fit_cross_validation`` with out-of-fold
predictions, ``evaluate``, ``predict``/``predict_proba`` with the model
selectors (current, best, all, a name; ``all`` averages), ``proba2predict``,
``apply``, class weights, the ``ModelSet`` leaderboard, ``save``/``load``
(``dt.pkl`` and one ``.dt`` model file per model) and ``probe_evaluate``.

``DeepTable(config, preprocessor, device=None)`` builds every ``DeepModel``
on ``device``: ``None`` is the current CUDA device (an error without one),
``'cpu'`` the plain PyTorch path. It takes a DataFrame, a dict of 1-D
arrays or a 2-D array, converted once at the entry to named numpy columns
(``data.columns``), and needs neither pandas nor scikit-learn: the folds
come from ``data.split``, the test-proba CSV files are written with numpy,
and ``probe_evaluate`` fits scikit-learn's logistic regression on scipy.
Cross-validation folds run one after another; ``n_jobs`` is accepted and
ignored. ``fit``, ``evaluate`` and ``predict`` take a streaming loader
(``data/streaming.py``), and ``fit_cross_validation_streaming`` folds a
stream by position; neither touches pandas.
``config.distribute_strategy`` (a ``parallel.DataParallel``) reaches every
``DeepModel`` with the config: each rank of the process group fits its
rows of each batch, and rank 0 alone writes ``save``'s files.
"""

import copy
import math
import os
import pickle
import time

import numpy as np
import torch

from . import modelset
from .callbacks import EarlyStopping, resolve_mode
from ..data import columns as cl
from ..data.split import KFold, StratifiedKFold, take_rows
from .config import ModelConfig
from .deepmodel import DeepModel, _ModelFileUnpickler, \
    _sanitize_config_for_pickle
from ..ops import metrics as metrics_lib
from ..parallel.mesh import get_strategy
from ..serving import fix_binary_predict_proba_result
from ..utils import consts, dt_logging

logger = dt_logging.get_logger(__name__)

class DeepTable:
    """Easy-to-use estimator for classification and regression on tabular
    data; ``ModelConfig`` holds its options."""

    def __init__(self, config=None, preprocessor=None, device=None):
        if config is None:
            config = ModelConfig()
        self.config = config
        self.nets = list(config.nets)
        self.device = device
        self.output_path = self._prepare_output_dir(config.home_dir, self.nets)
        self.preprocessor = preprocessor
        self.__current_model = None
        self.__modelset = modelset.ModelSet(
            metric=self.config.first_metric_name,
            best_mode=consts.MODEL_SELECT_MODE_AUTO)

    # ------------------------------------------------------------------
    @property
    def task(self):
        return self.preprocessor.task

    @property
    def num_classes(self):
        return len(self.preprocessor.labels)

    @property
    def classes_(self):
        return self.preprocessor.labels

    @property
    def pos_label(self):
        if self.config.pos_label is not None:
            return self.config.pos_label
        return self.preprocessor.pos_label

    @property
    def monitor(self):
        monitor = self.config.monitor_metric
        if monitor is None:
            if self.config.metrics is not None and len(self.config.metrics) > 0:
                monitor = 'val_' + self.config.first_metric_name
        return monitor

    @property
    def modelset(self):
        return self.__modelset

    @property
    def best_model(self):
        return self.__modelset.best_model().model

    @property
    def leaderboard(self):
        return self.__modelset.leaderboard()

    def _deep_model(self, model_file=None, custom_objects=None):
        pre = self.preprocessor
        return DeepModel(
            self.task, self.num_classes, self.config,
            pre.categorical_columns, pre.continuous_columns,
            model_file=model_file,
            var_categorical_len_columns=pre.var_len_categorical_columns,
            custom_objects=custom_objects, device=self.device)

    # ------------------------------------------------------------------
    def fit(self, X=None, y=None, batch_size=128, epochs=1, verbose=1,
            callbacks=None, validation_split=0.2, validation_data=None,
            shuffle=True, class_weight=None, sample_weight=None,
            initial_epoch=0, steps_per_epoch=None, validation_steps=None,
            validation_freq=1, max_queue_size=10, workers=1,
            use_multiprocessing=False):
        if DeepModel._is_batch_loader(X):
            # out of core: X is a StreamingDataLoader, preprocessed by its
            # own fitted preprocessor; y must be None
            if self.preprocessor is None:
                self.preprocessor = getattr(X, 'preprocessor', None)
            if self.preprocessor is None:
                raise ValueError('streaming fit needs a fitted preprocessor '
                                 '(see data.streaming.'
                                 'fit_preprocessor_streaming).')
            self.__modelset.clear()
            callbacks = self.__inject_callbacks(callbacks)
            model = self._deep_model()
            history = model.fit(X, validation_data=validation_data,
                                epochs=epochs, verbose=verbose,
                                callbacks=callbacks,
                                initial_epoch=initial_epoch,
                                steps_per_epoch=steps_per_epoch)
            self.__set_model('val', f'{"+".join(self.nets)}', model,
                             history.history)
            return model, history
        X = cl.as_columns(X)
        logger.info(f'X.Shape={np.shape(X)}, y.Shape={np.shape(y)}, '
                    f'batch_size={batch_size}')
        if np.ndim(X) != 2:
            raise ValueError('Input train data should be 2d .')
        if np.shape(X)[1] < 1:
            raise ValueError('Input train data should has 1 feature at least.')
        self.__modelset.clear()

        if self.preprocessor is None:
            self.preprocessor = _get_default_preprocessor(self.config, X, y)

        X, y = self.preprocessor.fit_transform(X, y)
        if validation_data is not None:
            validation_data = self.preprocessor.transform(*validation_data)

        logger.info('Training...')
        if class_weight is None and self.config.apply_class_weight \
                and self.task != consts.TASK_REGRESSION:
            class_weight = self.get_class_weight(y)

        callbacks = self.__inject_callbacks(callbacks)
        model = self._deep_model()
        history = model.fit(
            X, y, batch_size=batch_size, epochs=epochs, verbose=verbose,
            shuffle=shuffle, validation_split=validation_split,
            validation_data=validation_data,
            validation_steps=validation_steps, validation_freq=validation_freq,
            callbacks=callbacks, class_weight=class_weight,
            sample_weight=sample_weight, initial_epoch=initial_epoch,
            steps_per_epoch=steps_per_epoch)
        name = f'{"+".join(self.nets)}'
        logger.info('Training finished.')
        self.__set_model('val', name, model, history.history)
        return model, history

    def fit_cross_validation(self, X, y, X_eval=None, X_test=None,
                             num_folds=5, stratified=False, iterators=None,
                             batch_size=None, epochs=1, verbose=1,
                             callbacks=None, n_jobs=1, random_state=9527,
                             shuffle=True, class_weight=None,
                             sample_weight=None, initial_epoch=0,
                             steps_per_epoch=None, validation_steps=None,
                             validation_freq=1, max_queue_size=10, workers=1,
                             use_multiprocessing=False, oof_metrics=None):
        start = time.time()
        logger.info('Start cross validation')
        self.__modelset.clear()
        X = cl.as_columns(X)

        if self.preprocessor is None:
            self.preprocessor = _get_default_preprocessor(self.config, X, y)
        X, y = self.preprocessor.fit_transform(X, y)
        if X_eval is not None:
            X_eval = self.preprocessor.transform_X(X_eval)
        if X_test is not None:
            X_test = self.preprocessor.transform_X(X_test)

        if iterators is None:
            if stratified and self.task != consts.TASK_REGRESSION:
                iterators = StratifiedKFold(n_splits=num_folds, shuffle=True,
                                            random_state=random_state)
            else:
                iterators = KFold(n_splits=num_folds, shuffle=True,
                                  random_state=random_state)
        logger.info(f'Iterators:{iterators}')

        y = np.asarray(y)
        n_rows = np.shape(X)[0]
        if self.task in (consts.TASK_MULTICLASS, consts.TASK_MULTILABEL):
            oof_proba = np.full((n_rows, self.num_classes), np.nan)
        else:
            oof_proba = np.full((n_rows, 1), np.nan)
        eval_proba_mean = None
        test_proba_mean = None

        if class_weight is None and self.config.apply_class_weight \
                and self.task == consts.TASK_BINARY:
            class_weight = self.get_class_weight(y)

        callbacks = self.__inject_callbacks(callbacks)
        if n_jobs not in (None, 1):
            logger.info('CV folds run one after another on the device; '
                        'n_jobs ignored.')

        fit_kwargs = dict(
            batch_size=batch_size or 128, epochs=epochs, verbose=verbose,
            callbacks=callbacks, class_weight=class_weight, shuffle=shuffle,
            sample_weight=sample_weight, validation_steps=validation_steps,
            validation_freq=validation_freq, initial_epoch=initial_epoch,
            steps_per_epoch=steps_per_epoch)
        oof_scores = [] if oof_metrics is not None else None

        for n_fold, (train_idx, valid_idx) in enumerate(
                iterators.split(X, y if self.task != consts.TASK_MULTILABEL
                                else None)):
            model_file = os.path.join(
                self.output_path,
                f'{"_".join(self.nets)}-kfold-{n_fold + 1}.dt')
            out = _fit_and_score(
                self.task, self.num_classes, self.config,
                self.preprocessor.categorical_columns,
                self.preprocessor.continuous_columns,
                self.preprocessor.var_len_categorical_columns,
                n_fold, valid_idx,
                take_rows(X, train_idx), y[train_idx],
                take_rows(X, valid_idx), y[valid_idx],
                X_eval, X_test, model_file, device=self.device, **fit_kwargs)
            n_fold, idx, history, fold_oof, fold_eval, fold_test = out
            oof_proba[idx] = fold_oof
            if X_eval is not None:
                if eval_proba_mean is None:
                    eval_proba_mean = fold_eval / num_folds
                else:
                    eval_proba_mean += fold_eval / num_folds
            if X_test is not None:
                if test_proba_mean is None:
                    test_proba_mean = fold_test / num_folds
                else:
                    test_proba_mean += fold_test / num_folds
            if oof_metrics is not None:
                fold_y_true = y[idx]
                if self.task == consts.TASK_BINARY:
                    fold_y_proba = fix_binary_predict_proba_result(
                        fold_oof.copy())
                else:
                    fold_y_proba = fold_oof.copy()
                fold_y_true_dec = self.preprocessor.inverse_transform_y(
                    fold_y_true)
                fold_y_pred = self.proba2predict(fold_y_proba,
                                                 encode_to_label=True)
                oof_scores.append(metrics_lib.calc_score(
                    fold_y_true_dec, fold_y_pred, fold_y_proba,
                    metrics=oof_metrics, task=self.task,
                    pos_label=self.pos_label, classes=self.classes_))
            self.__push_model(
                'val', f'{"+".join(self.nets)}-kfold-{n_fold + 1}',
                model_file, history)

        nan_idx = np.argwhere(np.isnan(oof_proba).any(1)).ravel()
        if self.task == consts.TASK_BINARY:
            oof_proba_fixed = fix_binary_predict_proba_result(
                oof_proba.copy())
        elif self.task == consts.TASK_REGRESSION:
            oof_proba_fixed = oof_proba.reshape(n_rows)
        else:
            oof_proba_fixed = oof_proba
        if len(nan_idx) > 0:
            oof_proba_fixed[nan_idx] = np.nan

        if eval_proba_mean is not None and self.task == consts.TASK_BINARY:
            eval_proba_mean = fix_binary_predict_proba_result(eval_proba_mean)
        if test_proba_mean is not None and self.task == consts.TASK_BINARY:
            test_proba_mean = fix_binary_predict_proba_result(test_proba_mean)
            file = os.path.join(self.output_path,
                                f'{"_".join(self.nets)}-cv-{num_folds}.csv')
            write_csv(file, test_proba_mean[:, 1].reshape(-1, 1))

        logger.info(f'fit_cross_validation taken {time.time() - start}s')
        if oof_metrics is not None:
            return oof_proba_fixed, eval_proba_mean, test_proba_mean, \
                oof_scores
        return oof_proba_fixed, eval_proba_mean, test_proba_mean

    def fit_cross_validation_streaming(self, source, target, num_folds=5,
                                       batch_size=512, epochs=1, verbose=0,
                                       callbacks=None, oof_metrics=None):
        """K-fold CV over an out-of-core stream (the analog of upstream's
        Dask CV, ``deeptable.py:416-426``, which splits on index ranges).

        Folds are defined by global stream position modulo ``num_folds``
        (``StreamingDataLoader(fold_spec=...)``); each fold trains on the
        complement and is scored on its own rows in one streaming pass,
        and its model is saved as ``…-stream-kfold-{k}.dt`` and released.
        Returns the folds' score dicts (no out-of-fold predictions: the
        rows of an out-of-core stream do not fit in memory)."""
        from ..data.streaming import (StreamingDataLoader,
                                      fit_preprocessor_streaming)
        from .preprocessor import DefaultPreprocessor
        start = time.time()
        self.__modelset.clear()
        if self.preprocessor is None:
            self.preprocessor = DefaultPreprocessor(self.config,
                                                    use_cache=False)
            fit_preprocessor_streaming(self.preprocessor, source, target)
        pre = self.preprocessor
        callbacks = self.__inject_callbacks(callbacks)
        fold_scores = []
        for fold in range(num_folds):
            logger.info(f'\nStreaming fold {fold + 1}/{num_folds}\n')
            train_loader = StreamingDataLoader(
                source, pre, target, batch_size=batch_size,
                fold_spec=(num_folds, fold, 'train'))
            valid_loader = StreamingDataLoader(
                source, pre, target, batch_size=batch_size,
                shuffle_in_chunk=False, drop_remainder=False,
                fold_spec=(num_folds, fold, 'valid'))
            model = self._deep_model()
            history = model.fit(train_loader, validation_data=valid_loader,
                                epochs=epochs, verbose=verbose,
                                callbacks=callbacks)
            score = model.evaluate(valid_loader)
            if oof_metrics:
                score = {m: score[m] for m in oof_metrics if m in score} \
                    or dict(score)
            fold_scores.append(dict(score))
            name = f'{"+".join(self.nets)}-stream-kfold-{fold + 1}'
            model_file = os.path.join(
                self.output_path,
                f'{"_".join(self.nets)}-stream-kfold-{fold + 1}.dt')
            model.save(model_file)
            model.release()
            self.__push_model('val', name, model_file, history.history,
                              save_model=False)
        logger.info(f'fit_cross_validation_streaming taken '
                    f'{time.time() - start}s')
        return fold_scores

    # ------------------------------------------------------------------
    def evaluate(self, X_test, y_test=None, batch_size=256, verbose=0,
                 model_selector=consts.MODEL_SELECTOR_CURRENT,
                 return_dict=True):
        if DeepModel._is_batch_loader(X_test):
            # a loader preprocesses and carries its labels itself
            X_t, y_t = X_test, None
        else:
            X_t, y_t = self.preprocessor.transform(X_test, y_test)
        model = self.get_model(model_selector)
        if not isinstance(model, DeepModel):
            raise ValueError(f'Wrong model_selector:{model_selector}')
        return model.evaluate(X_t, y_t, batch_size=batch_size,
                              verbose=verbose, return_dict=return_dict)

    def predict_proba(self, X, batch_size=128, verbose=0,
                      model_selector=consts.MODEL_SELECTOR_CURRENT,
                      auto_transform_data=True):
        start = time.time()
        if model_selector == consts.MODEL_SELECTOR_ALL:
            models = self.get_model(model_selector)
            proba_avg = None
            if auto_transform_data:
                X = self.preprocessor.transform_X(X)
            for model in models:
                proba = self.__predict(model, X, batch_size=batch_size,
                                       verbose=verbose,
                                       auto_transform_data=False)
                if proba_avg is None:
                    proba_avg = np.zeros(proba.shape)
                proba_avg += proba
            proba = proba_avg / len(models)
        else:
            proba = self.__predict(self.get_model(model_selector), X,
                                   batch_size=batch_size, verbose=verbose,
                                   auto_transform_data=auto_transform_data)
        logger.info(f'predict_proba taken {time.time() - start}s')
        return proba

    def predict_proba_all(self, X, batch_size=128, verbose=0,
                          auto_transform_data=True):
        proba_all = {}
        if auto_transform_data:
            X = self.preprocessor.transform_X(X)
        for mi in self.__modelset.get_modelinfos():
            model = self.get_model(mi.name)
            proba_all[mi.name] = self.__predict(
                model, X, batch_size=batch_size, verbose=verbose,
                auto_transform_data=False)
        return proba_all

    def predict(self, X, encode_to_label=True, batch_size=128, verbose=0,
                model_selector=consts.MODEL_SELECTOR_CURRENT,
                auto_transform_data=True):
        proba = self.predict_proba(X, batch_size, verbose,
                                   model_selector=model_selector,
                                   auto_transform_data=auto_transform_data)
        return self.proba2predict(proba, encode_to_label)

    def proba2predict(self, proba, encode_to_label=True):
        if self.task == consts.TASK_REGRESSION:
            return proba
        if proba is None:
            raise ValueError('[proba] can not be none.')
        if len(proba.shape) == 1:
            proba = proba.reshape((-1, 1))
        if proba.shape[-1] > 1:
            predict = proba.argmax(axis=-1)
        else:
            predict = (proba > 0.5).astype(consts.DATATYPE_PREDICT_CLASS)
        if encode_to_label:
            predict = self.preprocessor.inverse_transform_y(predict)
        return predict

    def apply(self, X, output_layers, concat_outputs=False, batch_size=128,
              verbose=0, model_selector=consts.MODEL_SELECTOR_CURRENT,
              auto_transform_data=True, transformer=None):
        start = time.time()
        model = self.get_model(model_selector)
        if not isinstance(model, DeepModel):
            raise ValueError(f'Wrong model_selector:{model_selector}')
        if auto_transform_data:
            X = self.preprocessor.transform_X(X)
        output = model.apply(X, output_layers, concat_outputs, batch_size,
                             verbose, transformer)
        logger.info(f'apply taken {time.time() - start}s')
        return output

    def concat_emb_dense(self, flatten_emb_layer, dense_layer):
        """Concatenate the flattened embeddings and the dense inputs (the
        concat half of the model's ``bn_concat_emb_dense``; the BatchNorm
        half lives inside the model, with its own statistics)."""
        if flatten_emb_layer is not None and dense_layer is not None:
            x = torch.cat([flatten_emb_layer, dense_layer], dim=-1)
        elif flatten_emb_layer is not None:
            x = flatten_emb_layer
        elif dense_layer is not None:
            x = dense_layer
        else:
            raise ValueError('No input layer exists.')
        logger.info(f'Concat embedding and dense layer shape:{tuple(x.shape)}')
        return x

    # ------------------------------------------------------------------
    def get_model(self, model_selector=consts.MODEL_SELECTOR_CURRENT):
        if model_selector == consts.MODEL_SELECTOR_CURRENT:
            mi = self.__modelset.get_modelinfo(self.__current_model)
        elif model_selector == consts.MODEL_SELECTOR_BEST:
            mi = self.__modelset.best_model()
        elif model_selector == consts.MODEL_SELECTOR_ALL:
            ms = []
            for mi in self.__modelset.get_modelinfos():
                if isinstance(mi.model, str):
                    mi.model = self.load_deepmodel(mi.model)
                ms.append(mi.model)
            return ms
        else:
            mi = self.__modelset.get_modelinfo(model_selector)
        if mi is None:
            raise ValueError(f'{model_selector} does not exist.')
        if isinstance(mi.model, str):
            mi.model = self.load_deepmodel(mi.model)
        return mi.model

    def get_class_weight(self, y):
        n = len(self.classes_)
        y = np.asarray(y).reshape(-1)
        counts = np.array([(y == i).sum() for i in range(n)], dtype=np.float64)
        total = counts.sum()
        weights = {i: (total / (n * c) if c > 0 else 1.0)
                   for i, c in enumerate(counts)}
        logger.info(f'classes weight: {weights}')
        return weights

    def _prepare_output_dir(self, home_dir, nets):
        if home_dir is None:
            home_dir = 'dt_output'
        home_dir = home_dir.rstrip('/')
        running_dir = f'dt_{time.strftime("%Y%m%d%H%M%S")}_{"_".join(nets)}'
        output_path = os.path.expanduser(os.path.join(home_dir, running_dir))
        os.makedirs(output_path, exist_ok=True)
        return output_path

    def __predict(self, model, X, batch_size=128, verbose=0,
                  auto_transform_data=True):
        if auto_transform_data:
            X = self.preprocessor.transform_X(X)
        proba = model.predict(X, batch_size=batch_size, verbose=verbose)
        if self.task == consts.TASK_BINARY:
            return fix_binary_predict_proba_result(proba)
        return proba

    def __set_model(self, type, name, model, history):
        self.__modelset.clear()
        self.__push_model(type, name, model, history)

    def __push_model(self, type, name, model, history, save_model=True):
        modelfile = ''
        if save_model and isinstance(model, DeepModel):
            modelfile = os.path.join(self.output_path, f'{name}.dt')
            model.save(modelfile)
            logger.info(f'Model has been saved to:{modelfile}')
        mi = modelset.ModelInfo(type, name, model, {}, history=history,
                                modelfile=modelfile)
        self.__modelset.push(mi)
        self.__current_model = mi.name

    def __inject_callbacks(self, callbacks):
        es = None
        if callbacks is not None:
            for callback in callbacks:
                if isinstance(callback, EarlyStopping):
                    es = callback
        else:
            callbacks = []
        mode = resolve_mode(self.monitor, self.config.earlystopping_mode)
        es_patience = self.config.earlystopping_patience
        if es is None and isinstance(es_patience, int) and es_patience > 0:
            es = EarlyStopping(monitor=self.monitor,
                               restore_best_weights=True,
                               patience=es_patience, verbose=1, mode=mode)
            callbacks = list(callbacks) + [es]
            logger.info(f'Injected a callback [EarlyStopping]. '
                        f'monitor:{es.monitor}, patience:{es.patience}, '
                        f'mode:{mode}')
        return callbacks

    # ------------------------------------------------------------------
    def __getstate__(self):
        state = self.__dict__.copy()
        clean = _sanitize_config_for_pickle(self.config)
        if clean is not self.config:
            state['config'] = clean
            tmp_pre = copy.copy(self.preprocessor)
            tmp_pre.config = _sanitize_config_for_pickle(tmp_pre.config)
            state['preprocessor'] = tmp_pre
        return state

    def save(self, filepath, deepmodel_basename=None):
        """``dt.pkl`` (this estimator, its models by file name) and one
        ``.dt`` model file per model in the directory ``filepath``; under a
        data-parallel ``config.distribute_strategy``, by rank 0 only (the
        other ranks take part in gathering row-sharded tables)."""
        if not get_strategy(self.config.distribute_strategy).is_chief:
            for mi in self.__modelset.get_modelinfos():
                if isinstance(mi.model, DeepModel):
                    mi.model.save(None)  # writes nothing off rank 0
            return
        os.makedirs(filepath, exist_ok=True)
        num_model = len(self.__modelset.get_modelinfos())
        for mi in self.__modelset.get_modelinfos():
            if isinstance(mi.model, str):
                mi.model = self.load_deepmodel(mi.model)
            if not isinstance(mi.model, DeepModel):
                raise ValueError(
                    'Currently does not support saving non-DeepModel models.')
            if num_model == 1 and deepmodel_basename is not None:
                mi.name = deepmodel_basename
                self.__current_model = deepmodel_basename
            modelfile = os.path.join(filepath, f'{mi.name}.dt')
            mi.model.save(modelfile)
            mi.model = modelfile
        with open(os.path.join(filepath, 'dt.pkl'), 'wb') as output:
            pickle.dump(self, output, protocol=4)

    @staticmethod
    def load(filepath, custom_objects=None, device=None):
        """A ``DeepTable`` saved by :meth:`save`, its models on ``device``
        (default: the current CUDA device). A JAX package's ``dt.pkl`` is
        refused without importing that package."""
        with open(os.path.join(filepath, 'dt.pkl'), 'rb') as f:
            dt = _ModelFileUnpickler(f).load()
        if not isinstance(dt, DeepTable):
            raise ValueError(f'{filepath}/dt.pkl holds no deeptables_torch '
                             f'DeepTable.')
        dt.device = device
        dt.restore_modelset(filepath, custom_objects=custom_objects)
        return dt

    def restore_modelset(self, filepath, custom_objects=None):
        for mi in self.__modelset.get_modelinfos():
            if isinstance(mi.model, str):
                modelfile = os.path.split(mi.model)[-1]
                mi.model = self.load_deepmodel(
                    os.path.join(filepath, modelfile),
                    custom_objects=custom_objects)

    def load_deepmodel(self, filepath, custom_objects=None):
        if os.path.exists(filepath):
            logger.info(f'Load model from: {filepath}.')
            return self._deep_model(model_file=filepath,
                                    custom_objects=custom_objects)
        raise ValueError(f'Invalid model filename:{filepath}.')


def _fit_and_score(task, num_classes, config, categorical_columns,
                   continuous_columns, var_len_columns, n_fold, valid_idx,
                   X_train, y_train, X_val, y_val, X_eval=None, X_test=None,
                   model_file=None, batch_size=128, epochs=1, verbose=0,
                   callbacks=None, shuffle=True, class_weight=None,
                   sample_weight=None, initial_epoch=0, steps_per_epoch=None,
                   validation_steps=None, validation_freq=1, device=None):
    """One cross-validation fold: fit, predict the held-out rows (and
    ``X_eval``/``X_test``), save the model, free its device memory."""
    logger.info(f'\nFold:{n_fold + 1}\n')
    model = DeepModel(task, num_classes, config, categorical_columns,
                      continuous_columns,
                      var_categorical_len_columns=var_len_columns,
                      device=device)
    history = model.fit(
        X_train, y_train, batch_size=batch_size, epochs=epochs,
        verbose=verbose, callbacks=callbacks,
        validation_data=(X_val, y_val), shuffle=shuffle,
        class_weight=class_weight, sample_weight=sample_weight,
        initial_epoch=initial_epoch, steps_per_epoch=steps_per_epoch,
        validation_steps=validation_steps, validation_freq=validation_freq)
    logger.info(f'Fold {n_fold + 1} fitting over.')
    oof_proba = model.predict(X_val)
    eval_proba = model.predict(X_eval) if X_eval is not None else None
    test_proba = model.predict(X_test) if X_test is not None else None
    logger.info(f'Fold {n_fold + 1} scoring over.')
    if model_file is not None:
        model.save(model_file)
        if X_test is not None:
            write_csv(f'{model_file}.test_proba.csv',
                      test_proba.reshape(len(test_proba), -1))
    model.release()
    return (n_fold, valid_idx, history.history, oof_proba, eval_proba,
            test_proba)


def write_csv(path, values):
    """A 2-D array as the text ``pd.DataFrame(values).to_csv(path,
    index=False)`` writes: a header of the column numbers, each number as
    numpy prints it, NaN as an empty field."""
    values = np.asarray(values)
    text = values.astype(str)
    text[np.isnan(values)] = ''
    with open(path, 'w') as f:
        f.write(','.join(str(j) for j in range(values.shape[1])) + '\n')
        for row in text:
            f.write(','.join(row) + '\n')


def _libm(fn, x):
    """``fn`` (from ``math``: the C library's, which scikit-learn's Cython
    losses call) element by element; numpy's own exp and log differ from it
    in the last bit of a few per cent of values, enough to move L-BFGS's
    path."""
    return np.frompyfunc(fn, 1, 1)(x).astype(np.float64)


def _logistic_loss_gradient(coef, X, target, n_classes, l2):
    """scikit-learn's (1.9) ``LinearModelLoss.loss_gradient`` of the half
    binomial (two classes) or half multinomial loss at ``coef`` (the
    weights, then the intercept last; classes contiguous for multinomial),
    in the type of ``X``: the mean loss plus ``l2 / 2 · |w|²``, the intercept
    unpenalised, and its gradient."""
    n = len(X)
    if n_classes == 2:
        weights, intercept = coef[:-1], coef[-1]
        raw = (X @ weights.astype(X.dtype) + intercept.astype(X.dtype)) \
            .astype(np.float64)
        y = target.astype(np.float64)
        loss = np.empty(n)
        grad = np.empty(n)
        # the branches of sklearn/_loss/_loss.pyx.tp closs_grad_half_binomial
        for mask, sign in ((raw <= -37, None), ((raw > -37) & (raw <= -2), -1),
                           ((raw > -2) & (raw <= 18), 1), (raw > 18, 0)):
            r, t = raw[mask], y[mask]
            if sign is None:
                e = _libm(math.exp, r)
                loss[mask], grad[mask] = e - t * r, e - t
            elif sign == -1:
                e = _libm(math.exp, r)
                loss[mask] = _libm(math.log1p, e) - t * r
                grad[mask] = ((1 - t) * e - t) / (1 + e)
            else:
                e = _libm(math.exp, -r)
                loss[mask] = (_libm(math.log1p, e) if sign else e) \
                    + (1 - t) * r
                grad[mask] = ((1 - t) - t * e) / (1 + e)
        loss, grad_pointwise = loss.astype(X.dtype), grad.astype(X.dtype)
        value = float(loss.sum() / n)
        value += float(0.5 * l2 * (weights @ weights))
        grad_pointwise /= n
        out = np.empty_like(coef, dtype=weights.dtype)
        out[:-1] = X.T @ grad_pointwise + l2 * weights
        out[-1] = grad_pointwise.sum()
        return value, out
    full = coef.reshape((n_classes, -1), order='F')
    weights, intercept = full[:, :-1], full[:, -1]
    raw = X @ weights.astype(X.dtype).T + intercept.astype(X.dtype)
    # sklearn/_loss/_loss.pyx.tp CyHalfMultinomialLoss.loss_gradient: the
    # exponentials stored in the input's type, their sum in double
    top = raw.max(axis=1)
    p = _libm(math.exp, raw.astype(np.float64) - top[:, None]) \
        .astype(raw.dtype)
    sums = p.astype(np.float64).sum(axis=1).astype(raw.dtype)
    rows = np.arange(n)
    labels = target.astype(np.int64)
    loss = (_libm(math.log, sums.astype(np.float64)) + top).astype(raw.dtype)
    loss = loss - raw[rows, labels]
    p /= sums[:, None]
    grad_pointwise = p
    grad_pointwise[rows, labels] -= 1
    value = float(loss.sum() / n)
    flat = np.ravel(weights, order='K')  # sklearn.utils.extmath.squared_norm
    value += float(0.5 * l2 * (flat @ flat))
    grad_pointwise /= n
    out = np.empty((n_classes, weights.shape[1] + 1), dtype=weights.dtype,
                   order='F')
    out[:, :-1] = grad_pointwise.T @ X + l2 * weights
    out[:, -1] = grad_pointwise.sum(axis=0)
    return value, out.ravel(order='F')


def _logistic_regression(X, y, C=1.0, max_iter=1000, tol=1e-4):
    """scikit-learn's ``LogisticRegression(C, max_iter, tol).fit(X, y)``
    (the default l2 penalty and lbfgs solver) on scipy: L-BFGS-B from zero
    with its options, in float32 for float32 features (else float64).
    Returns ``(classes, coef (n_classes or 1, n_features), intercept)``."""
    from scipy import optimize
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    X = np.ascontiguousarray(X)
    y = np.asarray(y).reshape(-1)
    classes = np.unique(y)
    n_classes = len(classes)
    if n_classes < 2:
        raise ValueError(f'This solver needs samples of at least 2 classes '
                         f'in the data, but the data contains only one '
                         f'class: {classes[0]}')
    if n_classes == 2:
        target = (y == classes[1]).astype(X.dtype)
        w0 = np.zeros(X.shape[1] + 1, dtype=X.dtype)
    else:
        target = np.searchsorted(classes, y).astype(X.dtype)
        w0 = np.zeros((n_classes, X.shape[1] + 1), dtype=X.dtype,
                      order='F').ravel(order='F')
    l2 = 1.0 / (C * len(X))
    result = optimize.minimize(
        _logistic_loss_gradient, w0, method='L-BFGS-B', jac=True,
        args=(X, target, n_classes, l2),
        options={'maxiter': max_iter, 'maxls': 50, 'gtol': tol,
                 'ftol': 64 * np.finfo(float).eps})
    if n_classes == 2:
        coef = np.asarray(result.x, dtype=X.dtype)
        return classes, coef[:-1][None, :], coef[-1:]
    coef = np.asarray(result.x, dtype=X.dtype).reshape((n_classes, -1),
                                                       order='F')
    return classes, coef[:, :-1], coef[:, -1]


def _logistic_predict(model, X):
    """(probabilities (n, n_classes), predicted labels) of a fitted
    ``_logistic_regression``, as ``predict_proba`` and ``predict`` give
    them."""
    from scipy.special import expit
    classes, coef, intercept = model
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    scores = X @ coef.T + intercept
    if len(classes) == 2:
        scores = scores.reshape(-1)
        p = expit(scores)
        return np.stack([1 - p, p], axis=1), classes[(scores > 0).astype(int)]
    p = scores - scores.max(axis=1)[:, None]
    np.exp(p, p)
    p /= p.sum(axis=1)[:, None]
    return p, classes[scores.argmax(axis=1)]


def _is_sklearn_auc(fn) -> bool:
    """Whether ``fn`` is scikit-learn's ``roc_auc_score``, known by its
    name and module (scikit-learn is not imported)."""
    return getattr(fn, '__name__', None) == 'roc_auc_score' and \
        getattr(fn, '__module__', '').startswith('sklearn.')


def probe_evaluate(dt, X, y, X_test, y_test, layers, score_fn={}):
    """Linear-probe evaluation of intermediate representations: a logistic
    regression (``_logistic_regression``, scikit-learn's on scipy) on each
    layer's activations, scored on the test rows: the accuracy, or each of
    ``score_fn``. A score function that is scikit-learn's ``roc_auc_score``
    or the port's ``ops.metrics.auc`` is given the probabilities of the
    second class, any other the predicted labels."""
    logger.info('Extracting features of train set...')
    features_train = dt.apply(X, output_layers=layers)
    logger.info('Extracting features of test set...')
    features_test = dt.apply(X_test, output_layers=layers)
    y = dt.preprocessor.transform_y(y)
    y_test = dt.preprocessor.transform_y(y_test)

    if not isinstance(features_train, list):
        features_train = [features_train]
        features_test = [features_test]

    result = {}
    for i, x_train in enumerate(features_train):
        model = _logistic_regression(x_train, y)
        proba, y_score = _logistic_predict(model, features_test[i])
        y_proba = proba[:, 1]
        if len(score_fn) == 0:
            score = float(np.mean(y_score == np.asarray(y_test).reshape(-1)))
            result[layers[i]] = {'accuracy': score}
        else:
            result[layers[i]] = {}
            for metric, fn in score_fn.items():
                if fn is metrics_lib.auc or _is_sklearn_auc(fn):
                    score = fn(y_test, y_proba)
                else:
                    score = fn(y_test, y_score)
                result[layers[i]][metric] = score
    return result


def _get_default_preprocessor(config, X, y):
    from .preprocessor import DefaultPreprocessor
    return DefaultPreprocessor(config)
