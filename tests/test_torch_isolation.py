# -*- coding:utf-8 -*-
"""The port imports nothing of JAX, flax, optax, pandas, scikit-learn,
pyarrow, LightGBM, the compression packages (``zstandard``, ``lz4``,
``brotli``) or the JAX package, so that it runs on a machine that has
none of them. No module is exempt: ``data/streaming.py`` reads CSV through
``data/columns.py`` and Parquet through ``data/parquet.py``. The estimator
layer (``models/preprocessor.py``, ``models/transformers.py`` with GBM
leaf features over ``models/gbm.py``, ``models/deeptable.py``,
``models/hyper_dt.py``, ``preprocessing``, ``tools/parity_quality.py``),
``probe_evaluate``, the leaderboards, ``utils/feature_importance.py`` and
``utils/quicktest.py`` run on numpy and scipy alone; ``eda`` and
``utils/shap.py`` import pandas or their own packages only inside the
functions that use them, and no module imports scikit-learn, pyarrow or
shap at all (Kernel SHAP runs there, its lasso selection the port's own) (LightGBM only where GBM leaf features find it). ZSTD and LZ4 pages
are read by the port's own decoders (``csrc/parquet_codecs.cpp``).

A subprocess blocks those modules (``sys.modules[name] = None`` makes any
import of them fail), then imports every module of ``deeptables_torch``
(``HOST_ONLY`` names none), ``deeptables_torch.models`` (whose estimator
exports are lazy) and ``chip_smoke.py``, and runs a DeepFM forward and a ``fit`` with its default
(stratified) validation split on ``device='cpu'``, so that training needs
no scikit-learn, a ``fit`` over a ``CriteoStreamLoader`` on TSV shards (the
native parser, the card's streaming path), an xDeepFM ``fit`` (the CIN modules, ``ops/cin_grad.py``
and ``ops/kernels/cin.py``) and an AutoInt ``fit`` on the avazu-style columns
(``ops/attention_grad.py``, ``ops/kernels/field_attention.py``, the fused
block too). It hides any CUDA device, so that ``DeepModel`` without a
device must raise. ``DeepTable`` and ``ModelSet`` (``models/deeptable.py``,
``models/modelset.py``) and the preprocessor import there too, and load
through ``deeptables_torch.models``'s lazy exports. ``serving``,
``models.deeptable``, ``models.modelset``, ``data``, ``data.fast_ingest``,
``data.criteo``, ``models.preprocessor``, ``models.hyper_dt`` and
``tools.parity_quality`` also import each on its own with those blocked,
and ``serving`` then loads neither ``DeepTable`` nor the preprocessor.
(``tests/test_torch_estimator.py`` runs the estimator itself so.)
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'sklearn', 'pyarrow',
           'lightgbm', 'zstandard', 'lz4', 'brotli', 'shap',
           'deeptables_tpu')
# packages that no module of the port imports, not even inside a function
NEVER = ('sklearn', 'pyarrow', 'zstandard', 'lz4', 'brotli', 'shap')
# the port's modules that may import pandas at module level: none
HOST_ONLY = ()

SCRIPT = r'''
import importlib, importlib.util, pkgutil, sys
for name in BLOCKED:
    sys.modules[name] = None

import numpy as np
import deeptables_torch

modules = ['deeptables_torch']
for info in pkgutil.walk_packages(deeptables_torch.__path__,
                                  'deeptables_torch.'):
    if info.name in HOST_ONLY:
        continue
    importlib.import_module(info.name)
    modules.append(info.name)
import deeptables_torch.models
from deeptables_torch.models import DeepModel as _DeepModel
for name in ('DefaultPreprocessor', 'AbstractPreprocessor'):
    getattr(deeptables_torch.models, name)  # the estimator needs no pandas
assert {'deeptables_torch.models.deeptable',
        'deeptables_torch.models.modelset',
        'deeptables_torch.models.preprocessor',
        'deeptables_torch.models.transformers',
        'deeptables_torch.models.hyper_dt',
        'deeptables_torch.data.columns',
        'deeptables_torch.tools.parity_quality'} <= set(modules)
from deeptables_torch.models import DeepTable, ModelInfo, ModelSet
from deeptables_torch import DeepTable as _DeepTable, ModelSet as _ModelSet
assert DeepTable is _DeepTable and ModelSet is _ModelSet
ms = ModelSet(metric='AUC', best_mode='auto')
ms.push(ModelInfo('val', 'a', None, {'AUC': 0.7}))
ms.push(ModelInfo('val', 'b', None, {'AUC': 0.9}))
assert ms.best_model().name == 'b'
assert callable(deeptables_torch.models.make_experiment)
assert deeptables_torch.make_experiment is deeptables_torch.models.make_experiment
assert not set(HOST_ONLY) & set(sys.modules), 'a host-only module loaded'

spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')
spec.loader.exec_module(importlib.util.module_from_spec(spec))

from deeptables_torch import (CategoricalColumn, ContinuousColumn, DeepModel,
                              ModelConfig, Predictor)
from deeptables_torch.data.datasets import load_criteo_synthetic

cat, dense, _, vocabs = load_criteo_synthetic(n_rows=9, n_cat=4, n_dense=3,
                                              max_vocab=50,
                                              return_arrays=True)
cats = tuple(CategoricalColumn(f'C{i}', int(v), 8) for i, v in
             enumerate(vocabs))
conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
config = ModelConfig(nets=['linear', 'fm_nets', 'dnn_nets'],
                     embedding_dropout=0,
                     dnn_params={'hidden_units': ((16, 0, False),)})
try:
    DeepModel('binary', 2, config, cats, conts)
except RuntimeError as e:
    assert 'CUDA' in str(e), e
else:
    raise AssertionError('DeepModel without a device ran without CUDA')

model = DeepModel('binary', 2, config, cats, conts, device='cpu')
proba = model.predict({'cat': cat, 'input_continuous_all': dense})
assert proba.shape == (9, 1) and np.isfinite(proba).all()
holder = type('Holder', (), {'task': 'binary', 'preprocessor': None,
                             'get_model': lambda self, selector: model})()
assert Predictor(holder).predict_proba_arrays(
    {'cat': cat, 'input_continuous_all': dense}).shape == (9, 2)
# Kernel SHAP without shap or scikit-learn, in the sampled regime (M = 12)
# whose lasso selection is the port's own
from deeptables_torch.data.columns import Columns, to_2d
from deeptables_torch.utils.shap import DeepTablesExplainer
summed = type('Summed', (), {'predict': lambda self, frame, **kw:
                             to_2d(frame).sum(axis=1)})()
background = Columns({f'f{j}': np.random.default_rng(j).normal(size=6)
                      for j in range(12)})
explainer = DeepTablesExplainer(summed, background)
phi = explainer.get_shap_values(np.ones((1, 12)))
assert phi.shape == (1, 12) and abs(
    phi.sum() - (12 - explainer.expected_value)) < 1e-9
y = (np.arange(9) % 2).astype(np.float32)
history = model.fit({'cat': cat, 'input_continuous_all': dense}, y,
                    batch_size=4, epochs=2, verbose=0)
assert np.isfinite(history.history['val_loss']).all()
assert set(model.evaluate({'cat': cat, 'input_continuous_all': dense}, y)) \
    == {'loss', 'accuracy'}
# streaming from Criteo TSV shards: the native parser, the loader and fit
import os, tempfile
from deeptables_torch.data import criteo, fast_ingest
assert fast_ingest.have_native()
shard_dir = tempfile.mkdtemp()
rng = np.random.default_rng(0)
for i in range(2):
    with open(os.path.join(shard_dir, f'day_{i}.tsv'), 'w') as f:
        for _ in range(40):
            f.write('\t'.join([str(rng.integers(0, 2))]
                              + [str(v) for v in rng.integers(0, 9, 3)]
                              + [format(int(v), '08x') for v in
                                 rng.integers(0, 2 ** 32, 4)]) + '\n')
source = fast_ingest.CriteoTsvSource(os.path.join(shard_dir, '*.tsv'),
                                     n_dense=3, n_cat=4,
                                     hash_buckets=[50, 9, 30, 7],
                                     chunk_bytes=1000)
scats, sconts = criteo.criteo_columns([50, 9, 30, 7], emb_dim=8, n_dense=3)
smodel = DeepModel('binary', 2, config, scats, sconts, device='cpu')
history = smodel.fit(criteo.CriteoStreamLoader(source, batch_size=16),
                     epochs=2, verbose=0,
                     validation_data=criteo.CriteoStreamLoader(
                         source, batch_size=16, shuffle=False,
                         drop_remainder=False))
assert np.isfinite(history.history['val_loss']).all()
# xDeepFM: the CIN contraction and its gradient take the plain path on the
# CPU
assert {'deeptables_torch.ops.cin_grad',
        'deeptables_torch.ops.kernels.cin'} <= set(modules)
xconfig = ModelConfig(nets=['linear', 'cin_nets', 'dnn_nets'],
                      embedding_dropout=0,
                      cin_params={'cross_layer_size': (4, 2)},
                      dnn_params={'hidden_units': ((16, 0, False),)})
xmodel = DeepModel('binary', 2, xconfig, cats, conts, device='cpu')
history = xmodel.fit({'cat': cat, 'input_continuous_all': dense}, y,
                     batch_size=4, epochs=1, verbose=0)
assert np.isfinite(history.history['loss']).all()
# AutoInt on the avazu-style columns, which come without pandas
assert {'deeptables_torch.ops.attention_grad',
        'deeptables_torch.ops.kernels.field_attention'} <= set(modules)
from deeptables_torch.data.datasets import _avazu_fields
fields, click = _avazu_fields(n_rows=12)
acat = np.stack(list(fields.values()), axis=1).astype(np.int32)
acats = tuple(CategoricalColumn(name, int(col.max()) + 2, 8)
              for name, col in fields.items())
for extra in ({}, {'fuse_projections': True}):
    aconfig = ModelConfig(nets=['autoint_nets'], embedding_dropout=0,
                          autoint_params=dict({'num_attention': 2,
                                               'num_heads': 2}, **extra))
    amodel = DeepModel('binary', 2, aconfig, acats, (), device='cpu')
    history = amodel.fit({'cat': acat}, click.astype(np.float32),
                         batch_size=4, epochs=1, verbose=0)
    assert np.isfinite(history.history['loss']).all()
# every other net of the zoo at once, beside a var-len column (its pooled
# field stacks onto the categorical ones), and custom_dnn_D_A_D_B
from deeptables_torch.models import VarLenCategoricalColumn, deepnets
zoo = [n for n in deepnets._BUILTIN if n not in
       ('linear', 'fm_nets', 'cin_nets', 'autoint_nets', 'dnn_nets')]
genres = VarLenCategoricalColumn('genres', 6, 8, pooling_strategy='max')
genres.max_elements_length = 3
zconfig = ModelConfig(
    nets=zoo, embedding_dropout=0, cin_params={'cross_layer_size': (4, 2)},
    fgcnn_params={'fg_filters': (2, 2), 'fg_heights': (3, 3),
                  'fg_pool_heights': (2, 2), 'fg_new_feat_filters': (1, 1)},
    dnn_params={'hidden_units': ((8, 0, True),),
                'custom_dnn_fn': deepnets.custom_dnn_D_A_D_B})
zmodel = DeepModel('binary', 2, zconfig, cats, conts,
                   var_categorical_len_columns=[genres], device='cpu')
zdata = {'cat': cat, 'input_continuous_all': dense,
         'genres': (np.arange(27).reshape(9, 3) % 6).astype(np.int32)}
history = zmodel.fit(zdata, y, batch_size=4, epochs=1, verbose=0)
assert np.isfinite(history.history['loss']).all()
# the denoising auto-encoder, and the checkpoint and data-parallel modules
assert {'deeptables_torch.fe.dae', 'deeptables_torch.parallel.mesh',
        'deeptables_torch.parallel.multihost',
        'deeptables_torch.utils.checkpoint'} <= set(modules)
from deeptables_torch.fe import DAE
feats = DAE(encoder_units=(8, 8), feature_units=2).fit_transform(
    dense.astype(np.float32), batch_size=4, epochs=2, verbose=0,
    device='cpu')
assert feats.shape == (9, 2)
# GBM leaf features (scikit-learn's trees, models/gbm.py) and Parquet
# (data/parquet.py) need neither scikit-learn nor pyarrow
from deeptables_torch.data import columns as cl
from deeptables_torch.models.transformers import GbmLeavesEncoder
table = cl.Columns({'a': np.arange(40) % 7, 'b': np.linspace(0, 1, 40)})
encoder = GbmLeavesEncoder(['a'], ['b'], 'binary', n_estimators=3,
                           random_state=0)
table = encoder.fit_transform(table, np.arange(40) % 3 == 0)
assert encoder.backend == 'sklearn' and encoder.new_columns == [
    'gbm_leaf_0', 'gbm_leaf_1', 'gbm_leaf_2']
parquet = cl.read_parquet('tests/torch_data/kinds_snappy.parquet')
assert len(parquet) == 400 and parquet.kinds['s'] == 'str'
for name in ('kinds_zstd', 'kinds_lz4_raw', 'kinds_delta'):
    other = cl.read_parquet(f'tests/torch_data/{name}.parquet')
    assert other.columns == parquet.columns, name
for name in BLOCKED:
    assert sys.modules[name] is None, name
print(len(modules))
'''


def test_port_runs_without_jax_pandas_or_the_jax_package():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1',
               PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, '-c',
         f'BLOCKED = {BLOCKED!r}\nHOST_ONLY = {HOST_ONLY!r}\n' + SCRIPT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-1]) >= 20  # every module was imported


ALONE = r'''
import importlib, sys
for name in BLOCKED:
    sys.modules[name] = None
importlib.import_module(MODULE)
loaded = set(sys.modules)
assert not set(HOST_ONLY) & loaded, 'a host-only module loaded'
if MODULE == 'deeptables_torch.serving':
    assert 'deeptables_torch.models.deeptable' not in loaded
print('ok')
'''


@pytest.mark.parametrize('module', ['deeptables_torch.serving',
                                    'deeptables_torch.models.deeptable',
                                    'deeptables_torch.models.modelset',
                                    'deeptables_torch.data',
                                    'deeptables_torch.data.fast_ingest',
                                    'deeptables_torch.data.criteo',
                                    'deeptables_torch.models.preprocessor',
                                    'deeptables_torch.models.hyper_dt',
                                    'deeptables_torch.tools.parity_quality'])
def test_module_imports_alone_without_host_libraries(module):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1',
               PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, '-c',
         f'BLOCKED = {BLOCKED!r}\nHOST_ONLY = {HOST_ONLY!r}\n'
         f'MODULE = {module!r}\n' + ALONE],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split()[-1] == 'ok'


def test_sources_name_no_blocked_module():
    """No import statement of the port or chip_smoke.py names a blocked
    module; pandas and LightGBM only inside a function (as ``eda`` and GBM
    leaf features import them), or in the host-only modules (none), which
    import pandas and nothing else blocked; scikit-learn, pyarrow and the
    compression packages nowhere."""
    host_only = {REPO / (name.replace('.', '/') + '.py') for name in HOST_ONLY}
    files = sorted((REPO / 'deeptables_torch').rglob('*.py'))
    files.append(REPO / 'chip_smoke.py')
    for path in files:
        for number, line in enumerate(path.read_text().splitlines(), 1):
            words = line.split()
            if not words or words[0] not in ('import', 'from'):
                continue
            top = words[1].split('.')[0]
            assert top not in NEVER, f'{path}:{number}: {line.strip()}'
            if top in ('pandas', 'lightgbm') and line[:1].isspace():
                continue  # a lazy import inside a function
            if top == 'pandas' and path in host_only:
                continue
            assert top not in BLOCKED, f'{path}:{number}: {line.strip()}'


def test_host_only_modules_import_pandas():
    """No module is exempted above, and no module of the port, the
    streaming module and the estimator layer included, imports pandas or
    scikit-learn at module level."""
    assert HOST_ONLY == ()
    files = sorted((REPO / 'deeptables_torch').rglob('*.py'))
    assert REPO / 'deeptables_torch' / 'data' / 'streaming.py' in files
    for path in files:
        lines = path.read_text().splitlines()
        assert not any(line.startswith(('import pandas', 'from pandas',
                                        'import sklearn', 'from sklearn'))
                       for line in lines), path
