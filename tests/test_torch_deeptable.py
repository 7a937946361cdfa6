# -*- coding:utf-8 -*-
"""``DeepTable``, ``ModelSet``, cross-validation and the estimator-backed
serving entry points of the port, on the CPU (``device='cpu'``).

Port twins of ``tests/test_deeptable.py``, ``test_modelset.py``,
``test_cv.py`` and ``test_serving.py``, in the binary task and in the
regression, multiclass and multilabel ones; the ``ModelSet`` twins run on
both packages' registries. Against the JAX package: a port ``DeepTable``
whose model holds the weights of a fitted JAX ``DeepTable`` (bridged; the
two preprocessors reach the same state) gives its ``predict_proba`` within
atol 1e-5 (float32 summation order); a JAX ``dt.pkl`` is refused without
importing the JAX package. Last, the flow of
``examples/quickstart_binary.py`` through the port.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest

from deeptables_torch import bridge, serving
from deeptables_torch.data.datasets import (load_bank, load_boston,
                                            load_glass_uci,
                                            load_multilabel_synthetic)
from deeptables_torch.models import (DeepModel, DeepTable, ModelConfig,
                                     ModelInfo, ModelSet, deepnets)
from deeptables_torch.models import deeptable as dt_mod
from deeptables_torch.utils import consts

REPO = Path(__file__).resolve().parents[1]
LABELS = [f'label_{k}' for k in range(4)]


def _data(task, n=600):
    """(X, y) of a task from the port's loaders."""
    if task == 'binary':
        df = load_bank(n)
        return df, df.pop('y')
    if task == 'regression':
        df = load_boston(n)
        return df, df.pop('target')
    if task == 'multiclass':
        df = load_glass_uci(n)
        return df, df.pop(10)
    df = load_multilabel_synthetic(n)
    return df.drop(columns=LABELS), df[LABELS].to_numpy(np.float32)


TASKS = {
    'binary': dict(nets=['linear', 'dnn_nets'], metrics=['AUC']),
    'regression': dict(nets=['dnn_nets'], metrics=['mse'],
                       task='regression'),
    'multiclass': dict(nets=['dnn_nets'], metrics=['accuracy']),
    'multilabel': dict(nets=['dnn_nets'], metrics=['accuracy', 'logloss'],
                       task='multilabel'),
}


def _head(y, n):
    return y[:n] if isinstance(y, np.ndarray) else y.head(n)


@pytest.fixture(scope='module', params=sorted(TASKS))
def fitted(request, tmp_path_factory):
    task = request.param
    X, y = _data(task)
    conf = ModelConfig(embedding_dropout=0,
                       apply_class_weight=task == 'binary',
                       home_dir=str(tmp_path_factory.mktemp('dt')),
                       **TASKS[task])
    dt = DeepTable(config=conf, device='cpu')
    model, history = dt.fit(X, y, epochs=2, batch_size=128, verbose=0)
    return task, dt, model, history, X, y


# ---------------------------------------------------------------- DeepTable

def test_task_and_history(fitted):
    task, dt, model, history, X, y = fitted
    assert dt.task == task
    assert isinstance(model, DeepModel) and model.device.type == 'cpu'
    metric = TASKS[task]['metrics'][0].lower()
    for key in ('loss', metric, 'val_loss', f'val_{metric}'):
        assert key in history.history, key
        assert np.isfinite(history.history[key]).all(), key


def test_evaluate(fitted):
    task, dt, _, _, X, y = fitted
    result = dt.evaluate(X.head(100), _head(y, 100), verbose=0)
    first = TASKS[task]['metrics'][0]
    assert np.isfinite(result['loss']) and result[first] >= 0
    assert first.lower() in result  # case-insensitive


def test_predict_proba_and_predict(fitted):
    task, dt, _, _, X, y = fitted
    proba = dt.predict_proba(X.head(50))
    assert np.isfinite(proba).all()
    if task == 'regression':
        assert proba.shape == (50, 1)
        np.testing.assert_array_equal(dt.predict(X.head(50)), proba)
        return
    width = 2 if task == 'binary' else dt.num_classes
    assert proba.shape == (50, width)
    if task in ('binary', 'multiclass'):
        np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
        labels = set(np.unique(y))
        assert set(np.unique(dt.predict(X.head(50)))) <= labels
        assert set(np.unique(dt.proba2predict(
            proba, encode_to_label=False))) <= set(range(width))
    else:
        assert ((proba >= 0) & (proba <= 1)).all()


def test_model_selectors_and_leaderboard(fitted):
    _, dt, model, *_ = fitted
    assert dt.get_model(consts.MODEL_SELECTOR_CURRENT) is model
    assert dt.get_model(consts.MODEL_SELECTOR_BEST) is model
    assert dt.get_model(consts.MODEL_SELECTOR_ALL) == [model]
    assert dt.best_model is model
    assert dt.get_model('+'.join(dt.nets)) is model
    with pytest.raises(ValueError):
        dt.get_model('no_such_model')
    assert dt.leaderboard.shape[0] == 1


def test_save_load_round_trip(fitted, tmp_path):
    _, dt, _, _, X, _ = fitted
    before = dt.predict_proba(X.head(40))
    dt.save(str(tmp_path / 'dt_model'))
    assert sorted(os.listdir(tmp_path / 'dt_model')) == \
        sorted(['dt.pkl', f'{"+".join(dt.nets)}.dt'])
    dt2 = DeepTable.load(str(tmp_path / 'dt_model'), device='cpu')
    assert dt2.get_model().device.type == 'cpu'
    np.testing.assert_allclose(dt2.predict_proba(X.head(40)), before,
                               atol=1e-5)


def test_predictor_matches_the_estimator(fitted, tmp_path):
    task, dt, _, _, X, _ = fitted
    predictor = serving.Predictor(dt, batch_buckets=(4, 32, 128)).warmup()
    np.testing.assert_allclose(predictor.predict_proba(X.head(50)),
                               dt.predict_proba(X.head(50)), atol=1e-5)
    for n in (1, 7, 9, 65, 200):
        assert len(serving.Predictor(dt, batch_buckets=(8, 64))
                   .predict_proba(X.head(n))) == n
    path = serving.export_predictor(dt, str(tmp_path / 'served'))
    loaded = serving.Predictor.load(path, device='cpu', batch_buckets=(16,))
    np.testing.assert_allclose(loaded.predict_proba(X.head(10)),
                               dt.predict_proba(X.head(10)), atol=1e-5)
    labels = loaded.predict(X.head(20))
    if task == 'regression':
        assert labels.shape == (20, 1)
    else:
        np.testing.assert_array_equal(labels, dt.predict(X.head(20)))


class TestBinary:
    @pytest.fixture(scope='class')
    def bank(self, tmp_path_factory):
        df = load_bank(1200)
        y = df.pop('y')
        conf = ModelConfig(nets=['dnn_nets'], metrics=['AUC'],
                           apply_class_weight=True, embedding_dropout=0,
                           home_dir=str(tmp_path_factory.mktemp('bank')))
        dt = DeepTable(config=conf, device='cpu')
        dt.fit(df.iloc[:960], y.iloc[:960], epochs=2, batch_size=128,
               verbose=0)
        return dt, df.iloc[:960], y.iloc[:960], df.iloc[960:], y.iloc[960:]

    def test_apply(self, bank):
        dt, _, _, X_test, _ = bank
        features = dt.apply(X_test.head(64),
                            output_layers=['flatten_embeddings',
                                           'dnn_dense_1', 'dnn_dense_2'])
        assert isinstance(features, list) and len(features) == 3
        assert features[1].shape == (64, 128)
        assert features[2].shape == (64, 64)
        single = dt.apply(X_test.head(32),
                          output_layers=['flatten_embeddings'])
        assert single.ndim == 2 and single.shape[0] == 32
        from sklearn.decomposition import PCA
        out = dt.apply(X_test.head(50),
                       output_layers=['flatten_embeddings', 'dnn_dense_1'],
                       transformer=PCA(n_components=3))
        assert len(out) == 2 and out[0].shape == (50, 3)

    def test_probe_evaluate(self, bank):
        from sklearn.metrics import accuracy_score, roc_auc_score
        dt, X_train, y_train, X_test, y_test = bank
        result = dt_mod.probe_evaluate(dt, X_train, y_train, X_test, y_test,
                                       layers=['flatten_embeddings'],
                                       score_fn={})
        assert result['flatten_embeddings']['accuracy'] > 0
        result = dt_mod.probe_evaluate(
            dt, X_train, y_train, X_test, y_test,
            layers=['flatten_embeddings', 'dnn_dense_1'],
            score_fn={'auc': roc_auc_score, 'accuracy': accuracy_score})
        assert set(result) == {'flatten_embeddings', 'dnn_dense_1'}
        assert all('auc' in v for v in result.values())

    def test_unseen_category_and_class_weight(self, bank):
        dt, _, y_train, X_test, _ = bank
        X_mod = X_test.head(20).copy()
        X_mod.loc[:, 'job'] = 'never-seen-job'
        proba = dt.predict_proba(X_mod)
        assert proba.shape == (20, 2) and np.isfinite(proba).all()
        encoded = dt.preprocessor.transform_y(y_train)
        weights = dt.get_class_weight(encoded)
        counts = np.bincount(np.asarray(encoded, int))
        assert weights[int(counts.argmin())] > 1 > \
            weights[int(counts.argmax())]

    def test_concat_emb_dense_helper(self, bank):
        import torch
        dt = bank[0]
        a, b = torch.ones(4, 3), torch.zeros(4, 2)
        assert dt.concat_emb_dense(a, b).shape == (4, 5)
        assert dt.concat_emb_dense(a, None).shape == (4, 3)
        assert dt.concat_emb_dense(None, b).shape == (4, 2)
        with pytest.raises(ValueError):
            dt.concat_emb_dense(None, None)

    def test_streaming_is_not_ported(self, bank):
        """The two streaming entry points that used to raise here run:
        ``fit`` over a loader (taking the loader's preprocessor) and
        ``fit_cross_validation_streaming`` over a stream. Their parity with
        the JAX package: ``tests/test_torch_streaming.py``."""
        from deeptables_torch.data.streaming import (ChunkedSource,
                                                     StreamingDataLoader)
        dt, X, y, *_ = bank
        source = ChunkedSource(X.assign(y=y.to_numpy()), chunk_size=400)
        loader = StreamingDataLoader(source, dt.preprocessor, 'y',
                                     batch_size=128)
        stream_dt = DeepTable(config=dt.config, device='cpu')
        _, history = stream_dt.fit(loader, epochs=1, verbose=0)
        assert stream_dt.preprocessor is dt.preprocessor
        assert np.isfinite(history.history['loss']).all()
        scores = stream_dt.fit_cross_validation_streaming(
            source, 'y', num_folds=2, batch_size=128)
        assert len(scores) == 2
        assert all(np.isfinite(s['loss']) for s in scores)


def test_duplicate_columns_rejected(tmp_path):
    df = pd.DataFrame(np.random.default_rng(0).random((50, 3)),
                      columns=['a', 'a', 'b'])
    y = np.random.default_rng(1).integers(0, 2, 50)
    dt = DeepTable(ModelConfig(metrics=['AUC'], home_dir=str(tmp_path)),
                   device='cpu')
    with pytest.raises(ValueError, match='duplicate'):
        dt.fit(df, y, epochs=1, verbose=0)


def test_multiple_metrics_and_custom_metric(tmp_path):
    df, y = _data('binary')
    conf = ModelConfig(nets=['dnn_nets'],
                       metrics=['AUC', 'accuracy', 'logloss'],
                       earlystopping_patience=3, home_dir=str(tmp_path))
    _, history = DeepTable(conf, device='cpu').fit(df, y, epochs=2,
                                                   verbose=0)
    for k in ('val_auc', 'val_accuracy', 'val_logloss'):
        assert k in history.history

    def r2_c(y_true, y_pred):
        from deeptables_torch.ops.metrics import r2
        return r2(y_true, y_pred)
    df, y = _data('regression')
    conf = ModelConfig(nets=['dnn_nets'], metrics=[r2_c], task='regression',
                       embedding_dropout=0, home_dir=str(tmp_path))
    _, history = DeepTable(conf, device='cpu').fit(df, y, epochs=1,
                                                   verbose=0)
    assert 'val_r2_c' in history.history


def test_task_is_inferred_from_y(tmp_path):
    for task in ('regression', 'multiclass', 'binary'):
        df, y = _data(task, 300)
        dt = DeepTable(ModelConfig(nets=['dnn_nets'], metrics=['mse'],
                                   home_dir=str(tmp_path)), device='cpu')
        dt.fit(df, y, epochs=1, verbose=0)
        assert dt.task == task


# ---------------------------------------------------------------- CV

@pytest.fixture(scope='module')
def cv_fitted(tmp_path_factory):
    df, y = _data('binary')
    X_test = df.head(100)
    conf = ModelConfig(nets=['dnn_nets'], metrics=['AUC'],
                       embedding_dropout=0,
                       home_dir=str(tmp_path_factory.mktemp('cv')))
    dt = DeepTable(config=conf, device='cpu')
    oof, eval_proba, test_proba = dt.fit_cross_validation(
        df, y, X_eval=df.tail(30), X_test=X_test, num_folds=3, epochs=1,
        verbose=0, stratified=True, n_jobs=4)
    return dt, df, y, X_test, oof, eval_proba, test_proba


class TestCV:
    def test_oof_and_mean_probas(self, cv_fitted):
        dt, df, _, X_test, oof, eval_proba, test_proba = cv_fitted
        assert oof.shape == (len(df), 2) and not np.isnan(oof).any()
        assert eval_proba.shape == (30, 2)
        assert test_proba.shape == (len(X_test), 2)
        assert os.path.exists(os.path.join(dt.output_path,
                                           'dnn_nets-cv-3.csv'))

    def test_fold_models(self, cv_fitted):
        dt, df, *_ = cv_fitted
        infos = dt.modelset.get_modelinfos()
        assert len(infos) == 3 and all('kfold' in mi.name for mi in infos)
        proba = dt.predict_proba(df.head(50),
                                 model_selector=consts.MODEL_SELECTOR_ALL)
        assert proba.shape == (50, 2)
        assert len(dt.predict_proba_all(df.head(30))) == 3

    def test_cv_save_load(self, cv_fitted, tmp_path):
        dt, df, *_ = cv_fitted
        dt.save(str(tmp_path / 'cv_model'))
        dt2 = DeepTable.load(str(tmp_path / 'cv_model'), device='cpu')
        proba = dt2.predict_proba(df.head(20),
                                  model_selector=consts.MODEL_SELECTOR_ALL)
        np.testing.assert_allclose(
            proba, dt.predict_proba(df.head(20),
                                    model_selector=consts.MODEL_SELECTOR_ALL),
            atol=1e-5)

    @pytest.mark.parametrize('task', sorted(TASKS))
    def test_oof_metrics_in_every_task(self, task, tmp_path):
        df, y = _data(task, 300)
        metrics = {'binary': ['AUC', 'accuracy'], 'regression': ['mse'],
                   'multiclass': ['accuracy'],
                   'multilabel': ['logloss']}[task]
        conf = ModelConfig(embedding_dropout=0, home_dir=str(tmp_path),
                           **dict(TASKS[task], metrics=metrics))
        dt = DeepTable(config=conf, device='cpu')
        out = dt.fit_cross_validation(df, y, num_folds=2, epochs=1,
                                      verbose=0, oof_metrics=metrics)
        oof, _, _, scores = out
        width = {'binary': (2,), 'regression': ()}.get(
            task, (dt.num_classes,))
        assert oof.shape == (len(df),) + width
        assert not np.isnan(oof).any()
        assert len(scores) == 2 and all(metrics[0] in s for s in scores)


# ---------------------------------------------------------------- ModelSet

@pytest.fixture(params=['port', 'jax'])
def registry(request):
    if request.param == 'port':
        return ModelInfo, ModelSet
    from deeptables_tpu.models import modelset as jax_modelset
    return jax_modelset.ModelInfo, jax_modelset.ModelSet


class TestModelSet:
    def test_best_model(self, registry):
        Info, Set = registry
        ms = Set(metric='AUC', best_mode='auto')
        for name, auc in (('a', 0.7), ('b', 0.9), ('c', 0.8)):
            ms.push(Info('val', name, object(), {'AUC': auc}))
        assert ms.best_model().name == 'b'
        assert [m.name for m in ms.top_n(2)] == ['b', 'c']
        ms = Set(metric='logloss', best_mode='auto')
        ms.push(Info('val', 'a', object(), {'logloss': 0.5}))
        ms.push(Info('val', 'b', object(), {'logloss': 0.3}))
        assert ms.best_model().name == 'b'
        with pytest.raises(ValueError):
            ms.push(Info('val', 'a', object(), {'logloss': 0.1}))
        ms.clear()
        with pytest.raises(ValueError):
            ms.best_model()

    def test_score_from_history_and_leaderboard(self, registry):
        Info, Set = registry
        info = Info('val', 'm', object(), {},
                    history={'AUC': [0.5, 0.8], 'loss': [1.0, 0.4]})
        assert info.get_score('auc') == 0.8
        assert info.get_score('LOSS') == 0.4
        ms = Set(metric='AUC')
        ms.push(Info('val', 'a', object(), {'AUC': 0.7}))
        ms.push(Info('test', 'b', object(), {'AUC': 0.9}))
        board = ms.leaderboard()
        assert board.shape[0] == 2 and '*auc' in board.columns
        assert list(board['model']) == ['b', 'a']
        assert [m.name for m in ms.get_modelinfos(type='test')] == ['b']
        assert Set().leaderboard() is None


# ---------------------------------------------------------------- vs JAX

@pytest.mark.parametrize('task', ['binary', 'multiclass'])
def test_bridged_deeptable_predicts_as_jax(task, tmp_path):
    from deeptables_tpu.models import DeepTable as JaxDeepTable
    from deeptables_tpu.models import ModelConfig as JaxModelConfig
    df, y = _data(task, 400)
    kwargs = dict(TASKS[task], embedding_dropout=0, home_dir=str(tmp_path))
    if task == 'binary':
        kwargs['nets'] = deepnets.DeepFM
    jax_dt = JaxDeepTable(JaxModelConfig(**kwargs))
    jax_dt.fit(df, y, epochs=1, verbose=0)
    port_dt = DeepTable(ModelConfig(**kwargs), device='cpu')
    port_dt.fit(df, y, epochs=1, verbose=0)
    pre = port_dt.preprocessor
    assert [c.name for c in pre.categorical_columns] == \
        [c.name for c in jax_dt.preprocessor.categorical_columns]
    model = port_dt.get_model()
    model.module.load_state_dict(bridge.state_dict_from_flax(
        jax.device_get(jax_dt.get_model().variables),
        pre.categorical_columns, pre.continuous_columns, port_dt.config))
    np.testing.assert_allclose(port_dt.predict_proba(df.head(120)),
                               jax_dt.predict_proba(df.head(120)), atol=1e-5)
    np.testing.assert_array_equal(port_dt.predict(df.head(120)),
                                  jax_dt.predict(df.head(120)))


def test_a_jax_dt_pkl_is_refused(tmp_path):
    from deeptables_tpu.models import DeepTable as JaxDeepTable
    from deeptables_tpu.models import ModelConfig as JaxModelConfig
    df, y = _data('binary', 200)
    jax_dt = JaxDeepTable(JaxModelConfig(nets=['dnn_nets'], metrics=['AUC'],
                                         home_dir=str(tmp_path)))
    jax_dt.fit(df, y, epochs=1, verbose=0)
    path = str(tmp_path / 'jax_dt')
    jax_dt.save(path)
    script = (
        'import sys\n'
        'sys.modules["deeptables_tpu"] = None\n'
        'from deeptables_torch.models import DeepTable\n'
        'try:\n'
        f'    DeepTable.load({path!r}, device="cpu")\n'
        'except ValueError as e:\n'
        '    assert "JAX package" in str(e), e\n'
        '    print("refused")\n')
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
    proc = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == 'refused'


# ---------------------------------------------------------------- quickstart

def test_quickstart_binary_flow(tmp_path):
    """``examples/quickstart_binary.py`` through the port on the CPU: DeepFM
    on bank, early stopping, fit, predict, save, load, evaluate."""
    df = load_bank()
    y = df.pop('y')
    conf = ModelConfig(nets=deepnets.DeepFM, metrics=['AUC'],
                       auto_discrete=True, earlystopping_patience=3,
                       home_dir=str(tmp_path))
    dt = DeepTable(config=conf, device='cpu')
    model, history = dt.fit(df, y, epochs=10, batch_size=512, verbose=0)
    assert history.history['val_auc'][-1] > 0.85
    proba = dt.predict_proba(df.head(10))
    assert proba.shape == (10, 2)
    assert set(dt.predict(df.head(10))) <= {'yes', 'no'}
    dt.save(str(tmp_path / 'dt_quickstart'))
    dt2 = DeepTable.load(str(tmp_path / 'dt_quickstart'), device='cpu')
    result = dict(dt2.evaluate(df.head(1000), y.head(1000)))
    assert result['auc'] > 0.85 and result['loss'] < 0.4
