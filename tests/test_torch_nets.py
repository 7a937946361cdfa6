# -*- coding:utf-8 -*-
"""The port's net zoo against the JAX package's (mirrors tests/test_nets.py):
every one of the 20 builders alone, every preset and all nets together, each
built in both packages on a schema whose JAX field order is not the column
order, the JAX weights bridged into the port, and compared on

- the inference logits: float32 rtol 1e-5, with an absolute term of 1e-6
  times the largest logit (only the order of float32 sums differs);
- one training step's loss and gradients (BatchNorm on batch statistics):
  rtol 1e-4, with an absolute term of 1e-4 times each tensor's largest
  gradient (longer chains of float32 sums: the FGCNN stages, the pair
  products' softmax) plus 1e-6 times the largest gradient of the model (a
  tensor whose gradients are sums that cancel to near zero, such as the
  dense BatchNorm's scale);
- under ``'bfloat16'`` (a few nets): rtol 1e-2 and 1e-2 of the largest
  value, as the frameworks round the bfloat16 products at other places.

Then ``custom_dnn_fn`` (the port's contract) and ``custom_dnn_D_A_D_B``
against the JAX package's, the FGCNN and FiBiNet layer numbering, and the
custom-object save/load round trip of tests/test_nets.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeptables_tpu.models import deepnets as jax_deepnets
from deeptables_tpu.ops import losses as jax_losses
from deeptables_torch import bridge
from deeptables_torch.models import DeepModel, ModelConfig, deepnets
from deeptables_torch.ops import losses
from deeptables_torch.ops.layers import Dense
from torch_parity import Case

F32, BF16 = 'float32', 'bfloat16'
ALL_NETS = list(jax_deepnets._BUILTIN)
PRESETS = ['DeepFM', 'xDeepFM', 'WideDeep', 'DCN', 'AutoInt', 'FGCNN',
           'FiBiNet', 'PNN', 'AFM']
# the FGCNN stages cut to size; an even kernel height and pools over odd
# field counts exercise SAME padding's odd pad at the end
FGCNN_PARAMS = {'fg_filters': (3, 4), 'fg_heights': (3, 2),
                'fg_pool_heights': (2, 2), 'fg_new_feat_filters': (2, 1)}
SMALL = dict(jit_init=True, fgcnn_params=FGCNN_PARAMS,
             autoint_params={'num_attention': 1, 'num_heads': 2,
                             'dropout_rate': 0, 'use_residual': True},
             afm_params={'attention_factor': 4, 'dropout_rate': 0},
             cross_params={'num_cross_layer': 3})
B = 32


def _close(actual, expected, rtol, atol_of_max, err_msg=''):
    actual = np.asarray(actual, np.float32)
    expected = np.asarray(expected, np.float32)
    assert actual.shape == expected.shape, err_msg
    scale = float(np.abs(expected).max()) if expected.size else 0.
    np.testing.assert_allclose(actual, expected, rtol=rtol,
                               atol=atol_of_max * scale, err_msg=err_msg)


def check_against_jax(case, dtype=F32, n=B):
    """Inference logits, then one step's loss and gradients of ``case``'s
    two models on one batch."""
    batch = case.batch(n, seed=11)
    y = np.random.default_rng(12).integers(0, 2, n).astype(np.float32)
    module = case.jax_model.module
    params = case.variables['params']
    batch_stats = case.variables['batch_stats']
    port = case.port_model()

    def jax_side(p, b):
        """Inference logits, then the training loss and its gradients."""
        logits, _ = module.apply({'params': p, 'batch_stats': batch_stats},
                                 b, training=False)

        def train_loss(p):
            (lg, _), _ = module.apply(
                {'params': p, 'batch_stats': batch_stats}, b, training=True,
                rngs={'dropout': jax.random.PRNGKey(0)},
                mutable=['batch_stats'])
            return jax_losses.binary_crossentropy(lg, jnp.asarray(y), None)
        return logits, jax.value_and_grad(train_loss)(p)

    # jitted: one compile a model instead of one for each operation
    expected, (loss, grads) = jax.jit(jax_side)(params, batch)
    with torch.no_grad():
        logits, _ = port.module(port.to_device(batch), training=False)
    rtol, atol = (1e-5, 1e-6) if dtype == F32 else (1e-2, 1e-2)
    _close(logits, expected, rtol, atol, 'logits')

    expected_grads = bridge.state_dict_from_flax(
        {'params': jax.device_get(grads)}, case.port_cats, case.port_conts,
        case.port_config, case.port_vars)
    logits, _ = port.module(port.to_device(batch), training=True,
                            generator=torch.Generator())
    port_loss = losses.binary_crossentropy(logits, torch.from_numpy(y), None)
    port_loss.backward()
    rtol = 1e-4 if dtype == F32 else 1e-2
    np.testing.assert_allclose(float(port_loss.detach()), float(loss),
                               rtol=rtol)
    named = dict(port.module.named_parameters())
    assert set(named) == set(expected_grads)
    floor = 1e-6 * max(float(g.abs().max()) for g in expected_grads.values())
    for name, param in named.items():
        # a parameter no net reads (bn_concat_emb_dense under a net of the
        # fields alone) has no gradient in torch, zeros in JAX
        grad = torch.zeros_like(param) if param.grad is None else param.grad
        expected = expected_grads[name].numpy()
        np.testing.assert_allclose(
            grad.numpy(), expected, rtol=rtol,
            atol=rtol * float(np.abs(expected).max()) + floor, err_msg=name)
    return port


@pytest.mark.parametrize('net', ALL_NETS)
def test_each_net_alone_matches_jax(net):
    check_against_jax(Case('nonascending_d8', nets=[net], **SMALL))


@pytest.mark.parametrize('preset', PRESETS)
def test_presets_match_jax(preset):
    nets = getattr(jax_deepnets, preset)
    assert getattr(deepnets, preset) == nets
    if len(nets) == 1:
        # a preset of one net is that net alone, which
        # test_each_net_alone_matches_jax holds against the JAX package
        assert nets[0] in ALL_NETS
        return
    check_against_jax(Case('nonascending_d8', nets=nets, **SMALL))


def test_all_nets_together_match_jax():
    port = check_against_jax(Case('nonascending_d8', nets=ALL_NETS,
                                  **SMALL))
    names = set(port.module._modules)
    # one counter a model: fg_nets and the five fgcnn_* nets take 0-5, the
    # two FiBiNet nets 0-1, as the JAX package numbers them
    assert {f'fgcnn_{i}_stage_1' for i in range(6)} <= names
    assert {'senet_layer_0', 'senet_layer_1'} <= names


@pytest.mark.parametrize('nets', [['pnn_nets'], ['fgcnn_ipnn_nets'],
                                  ['fibi_dnn_nets'], ['afm_nets'],
                                  ['linear', 'dnn_nets', 'dcn_nets']],
                         ids=lambda n: '+'.join(n))
def test_nets_match_jax_in_bfloat16(nets):
    check_against_jax(Case('nonascending_d16', BF16, nets=nets, **SMALL),
                      BF16)


@pytest.mark.parametrize('dtype', [F32, BF16])
def test_wide_deep_dcn_on_adult_matches_jax(dtype):
    """BASELINE.json's second configuration on its adult schema (JAX field
    order [6, 5, 4, 2, 0, 3, 1, 7], D=16, 4 cross layers), the MLP cut."""
    case = Case('adult_widedeep_dcn', dtype, jit_init=True)
    assert case.port_config.cross_params == {'num_cross_layer': 4}
    check_against_jax(case, dtype)


@pytest.mark.parametrize('extra', [
    {'outer_product_kernel_type': 'vec'}, {'outer_product_kernel_type':
                                           'num'}], ids=['vec', 'num'])
def test_outer_product_kernel_types_match_jax(extra):
    check_against_jax(Case('nonascending_d8', nets=['opnn_nets'],
                           pnn_params=extra, **SMALL))


@pytest.mark.parametrize('fibinet_params', [
    {'bilinear_type': 'field_all', 'senet_pooling_op': 'max'},
    {'bilinear_type': 'field_each', 'senet_reduction_ratio': 2}],
    ids=['field_all-max', 'field_each'])
def test_fibinet_options_match_jax(fibinet_params):
    check_against_jax(Case('nonascending_d8', nets=['fibi_dnn_nets'],
                           fibinet_params=fibinet_params, **SMALL))


def test_custom_dnn_d_a_d_b_matches_jax():
    hidden = ((16, 0, True), (8, 0, False))
    case = Case('nonascending_d8', nets=['dnn_nets'], jit_init=True,
                dnn_params={'hidden_units': hidden, 'activation': 'relu',
                            'custom_dnn_fn': 'custom_dnn_D_A_D_B'})
    port = check_against_jax(case)
    assert {'dnn_custom_dense_1', 'dnn_custom_bn_1', 'dnn_custom_dense_2'} \
        <= set(port.module._modules)


def test_single_field_pair_nets_skip():
    """A net over field pairs needs two fields: with one it builds nothing,
    and a model of it alone has no logit (tests/test_nets.py:166-189)."""
    from deeptables_torch.models import CategoricalColumn
    cats = (CategoricalColumn('c', 6, 4),)
    for net in ('afm_nets', 'ipnn_nets', 'opnn_nets', 'pnn_nets',
                'fibi_dnn_nets'):
        model = DeepModel('binary', 2, ModelConfig(nets=[net]), cats, (),
                          device='cpu')
        with pytest.raises(ValueError, match='Unexpected logit output'):
            model.build()


# ------------------------------------------------ custom nets and objects

class _CustomDense(torch.nn.Module):
    def __init__(self, in_features, out, name, generator=None):
        super().__init__()
        self.add_module(name, Dense(in_features, out, generator=generator))
        self.name = name
        self.output_dim = out


class _RoundTripNet(_CustomDense):
    def forward(self, embeddings, flatten_emb_layer, dense_layer,
                concat_emb_dense, ctx):
        return getattr(self, self.name)(concat_emb_dense)


class _TwoLayerDnn(torch.nn.Module):
    def __init__(self, in_features, cellname, generator=None):
        super().__init__()
        self.add_module(f'{cellname}_d0', Dense(in_features, 24,
                                                generator=generator))
        self.add_module(f'{cellname}_d1', Dense(24, 12, generator=generator))
        self.cellname = cellname
        self.output_dim = 12

    def forward(self, x, ctx):
        x = torch.relu(getattr(self, f'{self.cellname}_d0')(x))
        return getattr(self, f'{self.cellname}_d1')(x)


def my_roundtrip_net(inputs, config, model_desc, generator=None):
    model_desc.add_net('rt_custom', (None, inputs.concat_dim), (None, 6))
    return _RoundTripNet(inputs.concat_dim, 6, 'rt_custom_dense', generator)


def my_dnn_fn(in_features, params, cellname, generator=None):
    return _TwoLayerDnn(in_features, cellname, generator)


@pytest.fixture
def clean_registry():
    names = ('my_roundtrip_net', 'my_dnn_fn')

    def clear():
        for name in names:
            deepnets.custom_nets.pop(name, None)
            deepnets.dt_custom_objects.pop(name, None)
    clear()
    yield clear
    clear()


def test_custom_objects_save_load_roundtrip(clean_registry, tmp_path):
    """Save a DeepTable whose model has a custom net and a custom_dnn_fn,
    clear the registries, check that load fails naming the custom object,
    then load with ``custom_objects`` and get the same predictions
    (tests/test_nets.py:121)."""
    pytest.importorskip('pandas')
    from deeptables_torch.data.datasets import load_bank
    from deeptables_torch.models import DeepTable
    df = load_bank(300)
    y = df.pop('y')
    conf = ModelConfig(nets=['linear', my_roundtrip_net, 'dnn_nets'],
                       metrics=['AUC'], embedding_dropout=0,
                       embeddings_output_dim=4, earlystopping_patience=0,
                       dnn_params={'custom_dnn_fn': my_dnn_fn})
    dt = DeepTable(config=conf, device='cpu')
    dt.fit(df, y, epochs=1, batch_size=128, verbose=0)
    model = dt.get_model()
    assert {'rt_custom_dense', 'dnn_custom_d0', 'dnn_custom_d1'} <= set(
        model.module._modules)
    proba_before = dt.predict_proba(df.head(64))
    path = str(tmp_path / 'custom_dt')
    dt.save(path)

    clean_registry()
    with pytest.raises(ValueError, match='custom'):
        DeepTable.load(path, device='cpu')

    dt2 = DeepTable.load(path, device='cpu',
                         custom_objects={'my_roundtrip_net': my_roundtrip_net,
                                         'my_dnn_fn': my_dnn_fn})
    np.testing.assert_allclose(dt2.predict_proba(df.head(64)), proba_before,
                               rtol=1e-5)


def test_custom_dnn_fn_by_name_fails_loudly_when_unregistered(clean_registry):
    conf = ModelConfig(nets=['dnn_nets'],
                       dnn_params={'custom_dnn_fn': 'my_dnn_fn'})
    from deeptables_torch.models import CategoricalColumn
    model = DeepModel('binary', 2, conf, (CategoricalColumn('c', 6, 4),), (),
                      device='cpu')
    with pytest.raises(ValueError, match='Unknown custom object'):
        model.build()
    deepnets.register_custom_objects({'my_dnn_fn': my_dnn_fn})
    assert model.build().dnn_custom_d1.weight.shape == (12, 24)


def test_custom_objects_must_be_named_callables():
    with pytest.raises(ValueError, match='named callables'):
        deepnets.register_custom_objects(lambda x: x)
    with pytest.raises(ValueError, match='Signature'):
        deepnets.register_nets(lambda embeddings: None)
