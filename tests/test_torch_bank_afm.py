# -*- coding:utf-8 -*-
"""``bank_afm``: AFM alone on bank-style rows, the parity tool's row whose
AUC lies near chance in both packages (its tower sees the categorical
embeddings only; bank's signal lives in its numeric columns).

Both packages train it on the CPU for one epoch of the parity protocol
(``load_bank(20000)``, the preprocessors' output, batch 512, the default
stratified 20% validation split, Adam 1e-3) from the same initial weights
(the JAX model's, bridged), on the same batches, with embedding dropout off
(the two frameworks draw other masks). Held to ``tests/test_torch_nets.py``'s
float32 rules, which a fault in the port's AFM would break: the epoch's
loss and validation loss rtol 1e-4, the validation AUC rtol 1e-4, the
trained parameters within 2e-4 (``tests/test_torch_train.py``'s final
state; BatchNorm's running statistics of the raw columns, variances up to
~1e7, also rtol 1e-6). The spread of the trained AUC over seeds is then the tower's, not
the port's.
"""

import jax
import numpy as np
import pytest

from deeptables_tpu.data import datasets as jax_datasets
from deeptables_tpu.models import DeepModel as JaxDeepModel
from deeptables_tpu.models import ModelConfig as JaxModelConfig
from deeptables_tpu.models import preprocessor as jax_preprocessor
from deeptables_torch import bridge
from deeptables_torch.models import DeepModel, ModelConfig, preprocessor
from deeptables_torch.tools import parity_quality

ROWS, SEED = 20000, 0


@pytest.fixture(scope='module')
def fitted():
    frame = jax_datasets.load_bank(ROWS)
    y = frame.pop('y').to_numpy()
    spec = parity_quality.configs()['bank_afm']
    kwargs = dict(nets=spec['nets'], metrics=['AUC', 'logloss'], seed=SEED,
                  embedding_dropout=0, earlystopping_patience=0)
    ref_pre = jax_preprocessor.DefaultPreprocessor(JaxModelConfig(**kwargs),
                                                   use_cache=False)
    port_pre = preprocessor.DefaultPreprocessor(ModelConfig(**kwargs),
                                                use_cache=False)
    X_ref, y_ref = ref_pre.fit_transform(frame.copy(), np.copy(y))
    X_port, y_port = port_pre.fit_transform(frame.copy(), np.copy(y))
    jax_model = JaxDeepModel('binary', 2, JaxModelConfig(**kwargs),
                             ref_pre.categorical_columns,
                             ref_pre.continuous_columns)
    jax_model.build()
    config = ModelConfig(**kwargs)
    port_model = DeepModel('binary', 2, config, port_pre.categorical_columns,
                           port_pre.continuous_columns, device='cpu')
    port_model.build().load_state_dict(bridge.state_dict_from_flax(
        jax.device_get(jax_model.variables), port_pre.categorical_columns,
        port_pre.continuous_columns, config), strict=True)
    jax_history = jax_model.fit(X_ref, y_ref, batch_size=parity_quality.BATCH,
                                epochs=1, verbose=0)
    port_history = port_model.fit(X_port, y_port,
                                  batch_size=parity_quality.BATCH, epochs=1,
                                  verbose=0)
    return jax_model, port_model, port_pre, config, jax_history, \
        port_history


@pytest.mark.parametrize('key', ['loss', 'val_loss', 'val_auc'])
def test_bank_afm_epoch_matches_jax(fitted, key):
    _, _, _, _, jax_history, port_history = fitted
    np.testing.assert_allclose(port_history.history[key],
                               jax_history.history[key], rtol=1e-4,
                               err_msg=key)


def test_bank_afm_trained_weights_match_jax(fitted):
    jax_model, port_model, pre, config, _, _ = fitted
    expected = bridge.state_dict_from_flax(
        jax.device_get(jax_model.variables), pre.categorical_columns,
        pre.continuous_columns, config)
    state = port_model.module.state_dict()
    assert set(state) == set(expected)
    for name, value in expected.items():
        # BatchNorm's running statistics of bank's raw columns (variances
        # up to ~1e7) also to float32's relative rounding
        rtol = 1e-6 if '.running_' in name else 0
        np.testing.assert_allclose(state[name].numpy(), value.numpy(),
                                   rtol=rtol, atol=2e-4, err_msg=name)
