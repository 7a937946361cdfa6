# -*- coding:utf-8 -*-
"""Training in the port (``deeptables_torch``) against the JAX package, on
the CPU: BatchNorm in training mode, the loss, one train step's gradients,
a ``fit`` trajectory with the default validation split, ``evaluate``,
``save``/``load``, early stopping, dropout, and the numpy train/test split
against scikit-learn's.

Tolerances, each with its reason:
- float32: rtol 1e-5, with an absolute term of 1e-5 times the largest
  magnitude of the compared tensor where values cancel to near zero (the
  conftest pins JAX matmuls to full float32; only summation order differs).
- bfloat16 gradients: rtol 1e-2, with an absolute term of 1e-2 times the
  largest magnitude: the two frameworks round the bfloat16 sums of the
  linear and FM nets at other places.
- the ``fit`` trajectory: per-epoch metrics rtol 1e-4, the final state atol
  2e-4 (Adam moves each parameter by up to lr = 1e-3 a step whatever the
  gradient's size, so a rounding difference in a gradient near zero shows
  at that scale over nine steps).
- ``evaluate``: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn

from deeptables_tpu.models.callbacks import resolve_mode as jax_resolve_mode
from deeptables_tpu.ops import losses as jax_losses
from deeptables_tpu.ops import metrics as jax_metrics
from deeptables_torch import bridge
from deeptables_torch.data import split
from deeptables_torch.models import DeepModel, deepmodel
from deeptables_torch.models.callbacks import (EarlyStopping, LambdaCallback,
                                               resolve_mode)
from deeptables_torch.ops import layers, losses, metrics
from deeptables_torch.ops.embedding import MultiColumnEmbedding
from torch_parity import Case

F32, BF16 = 'float32', 'bfloat16'


def _allclose(actual, expected, rtol, err_msg=''):
    actual = np.asarray(actual, np.float32)
    expected = np.asarray(expected, np.float32)
    assert actual.shape == expected.shape, err_msg
    scale = float(np.abs(expected).max()) if expected.size else 0.
    np.testing.assert_allclose(actual, expected, rtol=rtol,
                               atol=rtol * scale, err_msg=err_msg)


# ---------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize('dtype', [F32, BF16])
def test_batch_norm_training_matches_flax(dtype):
    rng = np.random.default_rng(0)
    B, C = 37, 11
    x = rng.normal(1.5, 2.0, (B, C)).astype(np.float32)
    g = rng.normal(size=(B, C)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.2, C).astype(np.float32)
    mean = rng.normal(0, 0.5, C).astype(np.float32)
    var = rng.uniform(0.5, 2.0, C).astype(np.float32)

    flax_bn = jnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-3)
    variables = {'params': {'scale': scale, 'bias': bias},
                 'batch_stats': {'mean': mean, 'var': var}}
    jx = jnp.asarray(x, getattr(jnp, dtype))

    def apply(v, inp):
        out, mutated = flax_bn.apply(
            {'params': v, 'batch_stats': variables['batch_stats']}, inp,
            mutable=['batch_stats'])
        return out, mutated['batch_stats']

    out, stats = apply(variables['params'], jx)
    _, vjp = jax.vjp(lambda v, inp: apply(v, inp)[0], variables['params'], jx)
    dparams, dx = vjp(jnp.asarray(g))

    bn = layers.BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    tout = bn(tx, training=True)
    assert tout.dtype == torch.float32 and out.dtype == jnp.float32
    tout.backward(torch.from_numpy(g))
    _allclose(tout.detach(), out, 1e-5, 'output')
    _allclose(tx.grad.float(), np.asarray(dx, np.float32),
              1e-5 if dtype == F32 else 1e-2, 'dx')
    _allclose(bn.weight.grad, dparams['scale'], 1e-5, 'dscale')
    _allclose(bn.bias.grad, dparams['bias'], 1e-5, 'dbias')
    _allclose(bn.running_mean, stats['mean'], 1e-5, 'running_mean')
    _allclose(bn.running_var, stats['var'], 1e-5, 'running_var')


def test_batch_norm_inference_leaves_running_stats():
    bn = layers.BatchNorm(3)
    bn(torch.randn(8, 3), training=False)
    torch.testing.assert_close(bn.running_mean, torch.zeros(3))
    torch.testing.assert_close(bn.running_var, torch.ones(3))


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize('weighted', [False, True])
def test_binary_crossentropy_matches_jax(weighted):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 4, (64, 1)).astype(np.float32)
    y = rng.integers(0, 2, 64).astype(np.float32)
    w = rng.uniform(0, 2, 64).astype(np.float32) if weighted else None
    expected = jax_losses.binary_crossentropy(
        jnp.asarray(logits), jnp.asarray(y),
        None if w is None else jnp.asarray(w))
    got = losses.binary_crossentropy(
        torch.from_numpy(logits), torch.from_numpy(y),
        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(expected), rtol=1e-6)


def test_losses_optimizers_and_regularizers_not_ported_raise():
    """Every loss, optimizer and regularizer of the JAX package is ported
    now: the names that raised before resolve, and only names that neither
    package knows raise."""
    assert losses.get_loss('BCE') is \
        losses.binary_crossentropy
    for task, classes in (('binary', 2), ('multiclass', 3),
                          ('regression', 1), ('multilabel', 3)):
        assert losses.auto_loss_name(task, classes) == \
            jax_losses.auto_loss_name(task, classes)
    for name in ('mse', 'categorical_crossentropy', 'ghmc'):
        assert losses.get_loss(name) is losses._LOSSES[name]
    with pytest.raises(ValueError):
        losses.get_loss('no_such_loss')
    params = [torch.nn.Parameter(torch.zeros(2))]
    for name in ('adamw', 'rmsprop', 'adagrad', 'lamb'):
        assert isinstance(deepmodel._resolve_optimizer(name, 1e-3, params),
                          torch.optim.Optimizer)
    with pytest.raises(ValueError):
        deepmodel._resolve_optimizer('no_such_optimizer', 1e-3, params)
    case = Case('nonascending_d16')
    for field in ('embeddings_regularizer', 'embeddings_activity_regularizer'):
        config = case.port_config._replace(**{field: 'l2'})
        model = DeepModel('binary', 2, config, case.port_cats,
                          case.port_conts, device='cpu')
        model.build()
    with pytest.raises(ValueError):
        DeepModel('binary', 2, case.port_config._replace(
            embeddings_regularizer='l3'), case.port_cats, case.port_conts,
            device='cpu').fit(case.batch(8), np.zeros(8, np.float32),
                              verbose=0)


def test_optimizers_are_adam_and_plain_sgd():
    params = [torch.nn.Parameter(torch.zeros(2))]
    adam = deepmodel._resolve_optimizer('auto', 1e-3, params)
    assert isinstance(adam, torch.optim.Adam)
    assert adam.defaults['betas'] == (0.9, 0.999)
    assert adam.defaults['eps'] == 1e-8
    sgd = deepmodel._resolve_optimizer('SGD', 0.1, params)
    assert isinstance(sgd, torch.optim.SGD) and sgd.defaults['momentum'] == 0


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize('name', sorted(metrics._METRICS))
def test_metric_copy_matches_jax(name):
    rng = np.random.default_rng(len(name))
    y = rng.integers(0, 2, 200)
    proba = rng.uniform(size=(200, 1))
    assert metrics.get_metric(name)[1](y, proba) == \
        jax_metrics.get_metric(name)[1](y, proba)
    assert metrics.compute_metrics([name], y, proba, 'binary') == \
        jax_metrics.compute_metrics([name], y, proba, 'binary')


@pytest.mark.parametrize('monitor', ['val_loss', 'val_auc', 'AUC', 'loss'])
def test_early_stopping_mode_matches_jax(monitor):
    assert resolve_mode(monitor) == jax_resolve_mode(monitor)


# ---------------------------------------------------------------- one step

@pytest.mark.parametrize('schema,dtype', [
    ('nonascending_d16', F32), ('nonascending_d16', BF16),
    ('nonascending_d8', F32), ('nonascending_d8', BF16)])
def test_one_train_step_gradients_match_jax(schema, dtype):
    case = Case(schema, dtype)
    batch = case.batch(64, seed=4)
    rng = np.random.default_rng(5)
    y = rng.integers(0, 2, 64).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    module = case.jax_model.module
    params = case.variables['params']
    batch_stats = case.variables['batch_stats']

    def train_loss(p):
        (logits, _), mutated = module.apply(
            {'params': p, 'batch_stats': batch_stats}, batch, training=True,
            rngs={'dropout': jax.random.PRNGKey(0)}, mutable=['batch_stats'])
        loss = jax_losses.binary_crossentropy(logits, jnp.asarray(y),
                                              jnp.asarray(w))
        return loss, mutated['batch_stats']

    (loss, new_stats), grads = jax.value_and_grad(
        train_loss, has_aux=True)(params)
    expected_grads = bridge.state_dict_from_flax(
        {'params': jax.device_get(grads)}, case.port_cats, case.port_conts,
        case.port_config)
    expected_stats = bridge.state_dict_from_flax(
        {'params': params, 'batch_stats': jax.device_get(new_stats)},
        case.port_cats, case.port_conts, case.port_config)

    port = case.port_model()
    logits, _ = port.module(port.to_device(batch), training=True)
    port_loss = losses.binary_crossentropy(logits, torch.from_numpy(y),
                                           torch.from_numpy(w))
    port_loss.backward()
    rtol = 1e-5 if dtype == F32 else 1e-2
    np.testing.assert_allclose(float(port_loss.detach()), float(loss),
                               rtol=rtol)
    named = dict(port.module.named_parameters())
    assert set(named) == set(expected_grads)
    for name, param in named.items():
        _allclose(param.grad, expected_grads[name], rtol, name)
    for name, value in port.module.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            _allclose(value, expected_stats[name], 1e-5, name)


def test_bridge_maps_a_tree_without_batch_stats():
    case = Case('nonascending_d16')
    grads = {'params': case.variables['params']}
    mapped = bridge.state_dict_from_flax(grads, case.port_cats,
                                         case.port_conts, case.port_config)
    assert set(mapped) == {k for k in case.state_dict
                           if not k.endswith(('running_mean', 'running_var'))}
    for key, value in mapped.items():
        torch.testing.assert_close(value, case.state_dict[key])


# ---------------------------------------------------------------- fit

def _dataframe(case, n, seed):
    pd = pytest.importorskip('pandas')
    batch = case.batch(n, seed=seed)
    columns = {c.name: batch['cat'][:, i]
               for i, c in enumerate(case.port_cats)}
    dense = case.port_conts[0]
    columns.update({name: batch[dense.name][:, i]
                    for i, name in enumerate(dense.column_names)})
    y = (np.random.default_rng(seed).uniform(size=n)
         < 0.3 + 0.4 * (batch['cat'][:, 0] % 2)).astype(np.int64)
    return pd.DataFrame(columns), y


@pytest.fixture(scope='module')
def fitted():
    """A JAX fit and a port fit from the same weights on one DataFrame: 75
    rows, the default stratified 20% validation split (15 rows), batches of
    16 (3 steps an epoch), 3 epochs."""
    case = Case('nonascending_d16')
    X, y = _dataframe(case, 75, seed=11)
    jax_history = case.jax_model.fit(X, y, batch_size=16, epochs=3,
                                     verbose=0)
    port = case.port_model()
    port_history = port.fit(X, y, batch_size=16, epochs=3, verbose=0)
    return case, port, X, y, jax_history, port_history


@pytest.mark.parametrize('key', ['loss', 'val_loss', 'val_auc'])
def test_fit_trajectory_matches_jax(fitted, key):
    _, _, _, _, jax_history, port_history = fitted
    assert len(port_history.history[key]) == 3
    np.testing.assert_allclose(port_history.history[key],
                               jax_history.history[key], rtol=1e-4)


def test_fit_logs_the_same_keys(fitted):
    _, _, _, _, jax_history, port_history = fitted
    assert type(port_history.history).__name__ == 'IgnoreCaseDict'
    assert sorted(port_history.history.data) == \
        sorted(jax_history.history.data)
    assert port_history.history['VAL_AUC'] == port_history.history['val_auc']


def test_fit_final_state_matches_jax(fitted):
    case, port, *_ = fitted
    expected = bridge.state_dict_from_flax(
        jax.device_get(case.jax_model.variables), case.port_cats,
        case.port_conts, case.port_config)
    state = port.module.state_dict()
    assert set(state) == set(expected)
    for key, value in state.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   rtol=0, atol=2e-4, err_msg=key)


def test_evaluate_matches_jax(fitted):
    case, port, X, y, *_ = fitted
    got = port.evaluate(X, y, batch_size=32)
    expected = case.jax_model.evaluate(X, y, batch_size=32)
    assert sorted(got.data) == sorted(expected.data)
    for key in expected.data:
        np.testing.assert_allclose(got[key], expected[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    listed = port.evaluate(X, y, return_dict=False)
    assert listed[0] == pytest.approx(got['loss'], rel=1e-6)


def test_save_load_and_model_file_round_trip(fitted, tmp_path):
    case, port, X, *_ = fitted
    path = tmp_path / 'model.pt'
    port.save(path)
    expected = port.predict(X)
    loaded = DeepModel.load(path, device='cpu')
    np.testing.assert_array_equal(loaded.predict(X), expected)
    again = DeepModel('regression', 1, case.port_config, (), (),
                      model_file=path, device='cpu')
    assert again.task == 'binary' and again.categorical_columns == \
        case.port_cats
    np.testing.assert_array_equal(again.predict(X), expected)


def test_load_refuses_a_jax_model_file(tmp_path):
    case = Case('nonascending_d16')
    path = tmp_path / 'jax.dt'
    case.jax_model.save(str(path))
    with pytest.raises(ValueError, match='state_dict_from_flax'):
        DeepModel.load(path, device='cpu')


def test_fit_on_packed_arrays_with_weights_and_validation_data():
    case = Case('nonascending_d8')
    batch = case.batch(96, seed=6)
    y = np.random.default_rng(6).integers(0, 2, 96)
    port = case.port_model()
    val = ({k: v[:24] for k, v in batch.items()}, y[:24])
    history = port.fit(batch, y, batch_size=32, epochs=2, verbose=0,
                       validation_data=val, class_weight={0: 1., 1: 3.},
                       validation_freq=2)
    assert len(history.history['loss']) == 2
    assert len(history.history['val_loss']) == 1
    assert np.isfinite(history.history['loss']).all()


def test_early_stopping_restores_the_best_snapshot():
    case = Case('nonascending_d8')
    batch = case.batch(120, seed=7)
    y = np.random.default_rng(7).integers(0, 2, 120)
    port = case.port_model()
    snapshots = []
    recorder = LambdaCallback(on_epoch_end=lambda epoch, logs:
                              snapshots.append(port.get_state_snapshot()))
    stopper = EarlyStopping(monitor='val_loss', patience=10,
                            restore_best_weights=True)
    history = port.fit(batch, y, batch_size=32, epochs=4, verbose=0,
                       callbacks=[stopper, recorder])
    best = int(np.argmin(history.history['val_loss']))
    state = port.module.state_dict()
    for key, value in snapshots[best].items():
        torch.testing.assert_close(state[key], value, rtol=0, atol=0)
    # snapshots are copies: the last one differs from the best unless the
    # last epoch was the best
    if best != 3:
        assert any(not torch.equal(snapshots[3][k], v)
                   for k, v in snapshots[best].items())


# ---------------------------------------------------------------- dropout

def test_dropout_masks_repeat_with_a_fixed_generator():
    x = torch.ones(4000, 8)
    a = layers.dropout(x, 0.25, torch.Generator().manual_seed(3))
    b = layers.dropout(x, 0.25, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.75))
    with pytest.raises(ValueError, match='Generator'):
        layers.dropout(x, 0.25, None)
    assert layers.dropout(x, 0., None) is x


def test_spatial_dropout_shares_its_mask_over_fields():
    emb = MultiColumnEmbedding([50, 7, 300], [16] * 3, dropout_rate=0.5)
    ids = torch.zeros(64, 3, dtype=torch.int32)
    out = emb(ids, training=True,
              generator=torch.Generator().manual_seed(0)).stacked
    reference = emb(ids, training=False).stacked
    zero = out == 0
    assert torch.equal(zero, zero[:, :1].expand_as(zero))
    assert 0.3 < float(zero[:, 0].float().mean()) < 0.7
    torch.testing.assert_close(out[~zero], (reference * 2)[~zero])


def test_training_forward_with_dropout_needs_and_uses_the_generator():
    case = Case('nonascending_d8')
    config = case.port_config._replace(
        embedding_dropout=0.2, dense_dropout=0.3,
        dnn_params={'hidden_units': ((16, 0.5, False),),
                    'activation': 'relu'})
    model = DeepModel('binary', 2, config, case.port_cats, case.port_conts,
                      device='cpu')
    module = model.build()
    inputs = model.to_device(case.batch(32))
    with pytest.raises(ValueError, match='Generator'):
        module(inputs, training=True)
    runs = [module(inputs, training=True,
                   generator=torch.Generator().manual_seed(13))[0]
            for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1])
    other = module(inputs, training=True,
                   generator=torch.Generator().manual_seed(14))[0]
    assert not torch.equal(runs[0], other)


# ---------------------------------------------------------------- split

@pytest.mark.parametrize('stratified', [False, True])
@pytest.mark.parametrize('test_size', [0.2, 0.37, 7])
@pytest.mark.parametrize('n,seed', [(20, 0), (75, 9527), (1001, 3)])
def test_split_returns_sklearns_rows(n, seed, test_size, stratified):
    from sklearn.model_selection import train_test_split
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    y = rng.integers(0, 3, n)
    y[:6] = [0, 0, 1, 1, 2, 2]  # every class twice, as stratifying needs
    stratify = y if stratified else None
    expected = train_test_split(X, y, test_size=test_size,
                                random_state=seed, stratify=stratify)
    got = split.train_test_split(X, y, test_size=test_size,
                                 random_state=seed, stratify=stratify)
    for a, b in zip(got, expected):
        np.testing.assert_array_equal(a, b)


def test_split_takes_dataframes_and_dicts():
    from sklearn.model_selection import train_test_split
    case = Case('nonascending_d16')
    X, y = _dataframe(case, 40, seed=2)
    expected = train_test_split(X, y, test_size=0.2, random_state=5,
                                stratify=y)
    got = split.train_test_split(X, y, test_size=0.2, random_state=5,
                                 stratify=y)
    assert list(got[0].index) == list(expected[0].index)
    assert list(got[1].index) == list(expected[1].index)
    arrays = {'a': np.arange(40), 'b': np.arange(40) * 2}
    train, test, y_train, _ = split.train_test_split(
        arrays, y, test_size=0.2, random_state=5, stratify=y)
    np.testing.assert_array_equal(train['a'], np.asarray(expected[0].index))
    np.testing.assert_array_equal(train['b'], 2 * train['a'])
    np.testing.assert_array_equal(y_train, expected[2])
