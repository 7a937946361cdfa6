# -*- coding:utf-8 -*-
"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. This file imports torch and the port only (no JAX),
so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances:
- FM forward: float32 rtol 1e-5 (the kernel and the plain version sum in
  another order); bfloat16 rtol 1e-2 against the plain version in float32
  (one rounding of the output to bfloat16). Both carry an absolute term of
  the same relative size times the largest ``Σ_f,d x²`` of a row: FM is a
  difference of two sums of that size, which cancel to zero at F = 1.
- FM backward: float32 rtol 1e-5 with an absolute term of 1e-5 times the
  largest ``|g|·Σ_f |x|`` (the size of the terms of ``g·(Σ_f x − x)``);
  bfloat16 the same with 1e-2 (one rounding of dx to bfloat16), against the
  plain version on the same bfloat16 inputs.
- Embedding gradient: rtol 1e-5, atol 1e-5 times the largest row sum of
  ``|g|`` that meets in one table row: float atomics add in another order on
  every run, so only rounding may differ.
- DeepFM fit on the card against the CPU: losses rtol 1e-4; parameters atol
  2e-4 (Adam moves each parameter by up to lr = 1e-3 a step whatever the
  gradient's size, so rounding in a gradient near zero shows at that scale).
"""

import numpy as np
import pytest
import torch

from deeptables_torch.ops.kernels.emb_grad import emb_grad, emb_grad_reference
from deeptables_torch.ops.kernels.fm import (fm, fm_backward,
                                             fm_backward_reference,
                                             fm_reference)

RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _close(actual, expected, x, rtol):
    scale = float(x.float().square().sum(dim=(1, 2)).max())
    np.testing.assert_allclose(actual.float().cpu().numpy(),
                               expected.float().cpu().numpy(), rtol=rtol,
                               atol=rtol * scale)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,F,D', [(1, 26, 16), (4093, 26, 16),
                                   (4096, 26, 16), (64, 3, 4), (33, 5, 256),
                                   (7, 1, 12), (300, 26, 33)])
def test_fm_kernel_matches_reference(cuda, B, F, D, dtype):
    gen = torch.Generator().manual_seed(B * 1000 + F * 10 + D)
    x = torch.randn(B, F, D, generator=gen).to(dtype).to(cuda)
    before = fm.launches
    out = fm(x)
    torch.cuda.synchronize()
    assert fm.launches == before + 1
    assert out.shape == (B, 1) and out.dtype == dtype
    _close(out, fm_reference(x.float()), x, RTOL[dtype])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,F,D', [(1, 26, 16), (4093, 26, 16),
                                   (8192, 26, 16), (64, 3, 4), (33, 5, 256),
                                   (7, 1, 12), (300, 26, 33)])
def test_fm_backward_kernel_matches_reference(cuda, B, F, D, dtype):
    gen = torch.Generator().manual_seed(B * 1000 + F * 10 + D + 1)
    x = torch.randn(B, F, D, generator=gen).to(dtype).to(cuda)
    g = torch.randn(B, 1, generator=gen).to(dtype).to(cuda)
    before = fm_backward.launches
    dx = fm_backward(x, g)
    torch.cuda.synchronize()
    assert fm_backward.launches == before + 1
    assert dx.shape == x.shape and dx.dtype == dtype
    expected = fm_backward_reference(x, g)
    rtol = RTOL[dtype]
    scale = float((g.float().abs().reshape(-1, 1, 1)
                   * x.float().abs().sum(dim=1, keepdim=True)).max())
    np.testing.assert_allclose(dx.float().cpu().numpy(),
                               expected.float().cpu().numpy(), rtol=rtol,
                               atol=rtol * scale)


def test_fm_autograd_runs_both_kernels(cuda):
    x = torch.randn(64, 26, 16, device=cuda, requires_grad=True)
    g = torch.randn(64, 1, device=cuda)
    fwd, bwd = fm.launches, fm_backward.launches
    fm(x).backward(g)
    torch.cuda.synchronize()
    assert (fm.launches, fm_backward.launches) == (fwd + 1, bwd + 1)
    torch.testing.assert_close(x.grad, fm_backward_reference(x.detach(), g),
                               rtol=1e-5, atol=1e-4)


def _zipf_ids(B, vocabs, rng):
    cols = [(rng.zipf(1.2, size=B) - 1) % v for v in vocabs]
    offsets = np.concatenate([[0], np.cumsum(vocabs)[:-1]])
    return (np.stack(cols, axis=1) + offsets).astype(np.int32).reshape(-1)


def _check_emb_grad(ids, g, num_rows):
    before = emb_grad.launches
    out = emb_grad(ids, g, num_rows)
    torch.cuda.synchronize()
    assert emb_grad.launches == before + 1
    assert out.shape == (num_rows, g.shape[1]) and out.dtype == torch.float32
    expected = emb_grad_reference(ids, g, num_rows)
    row_abs = emb_grad_reference(ids, g.abs(), num_rows)
    np.testing.assert_allclose(out.cpu().numpy(), expected.cpu().numpy(),
                               rtol=1e-5,
                               atol=1e-5 * float(row_abs.max()) + 1e-30)


@pytest.mark.parametrize('B', [1, 37, 4093, 8192])
@pytest.mark.parametrize('D', [4, 8, 16, 32, 33])
def test_emb_grad_kernel_on_zipf_ids(cuda, B, D):
    rng = np.random.default_rng(B + D)
    vocabs = [7, 300, 2500, 100000]
    ids = torch.from_numpy(_zipf_ids(B, vocabs, rng)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(len(ids), D)).astype(np.float32))
    _check_emb_grad(ids, g.to(cuda), sum(vocabs))


def test_emb_grad_kernel_one_hot_row(cuda):
    ids = torch.full((8192 * 26,), 5, dtype=torch.int32, device=cuda)
    g = torch.rand(8192 * 26, 16, device=cuda)
    _check_emb_grad(ids, g, 324489)


def test_emb_grad_kernel_two_width_groups(cuda):
    from deeptables_torch.ops.embedding import MultiColumnEmbedding
    vocabs, dims = [50, 7, 300, 20], [8, 16, 8, 16]
    emb = MultiColumnEmbedding(vocabs, dims).to(cuda)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.stack([rng.integers(0, v, 333) for v in vocabs],
                                    axis=1).astype(np.int32)).to(cuda)
    before = emb_grad.launches
    out = emb(ids, training=True)
    sum((e * (i + 1)).sum() for i, e in enumerate(out)).backward()
    torch.cuda.synchronize()
    assert emb_grad.launches == before + 2  # one per width group
    for dim, cols in ((8, [0, 2]), (16, [1, 3])):
        grad = getattr(emb, f'embeddings_d{dim}').grad
        offsets = np.concatenate([[0], np.cumsum([vocabs[c] for c in cols])])
        expected = torch.zeros_like(grad)
        for k, c in enumerate(cols):
            expected.index_add_(0, ids[:, c].long() + int(offsets[k]),
                                torch.full((333, dim), float(c + 1),
                                           device=cuda))
        torch.testing.assert_close(grad, expected, rtol=1e-6, atol=1e-4)


def test_kernels_reject_what_they_do_not_take(cuda):
    x = torch.randn(8, 4, 16, device=cuda)
    g = torch.randn(8, 1, device=cuda)
    with pytest.raises(TypeError):
        fm(x.half())
    with pytest.raises(ValueError):
        fm(x.transpose(1, 2))
    with pytest.raises(TypeError):
        fm_backward(x, g.bfloat16())
    with pytest.raises(ValueError):
        fm_backward(x.transpose(1, 2), g)
    ids = torch.zeros(8, dtype=torch.int32, device=cuda)
    rows = torch.randn(8, 16, device=cuda)
    with pytest.raises(TypeError):
        emb_grad(ids.long(), rows, 10)
    with pytest.raises(TypeError):
        emb_grad(ids, rows.bfloat16(), 10)
    with pytest.raises(ValueError):
        emb_grad(ids, rows.t(), 10)
    with pytest.raises(ValueError):
        emb_grad(ids.cpu(), rows, 10)


def test_deepfm_on_cuda_matches_cpu(cuda):
    from deeptables_torch.models import (CategoricalColumn, ContinuousColumn,
                                         DeepModel, ModelConfig)
    from deeptables_torch.ops.kernels import fm as fm_module
    vocabs = [50, 7, 300, 20]
    cats = tuple(CategoricalColumn(f'C{i}', v, 16) for i, v in enumerate(vocabs))
    conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
    config = ModelConfig(nets=['linear', 'fm_nets', 'dnn_nets'],
                         task='binary', embedding_dropout=0,
                         dnn_params={'hidden_units': ((64, 0, False),
                                                      (32, 0, False))})
    gpu = DeepModel('binary', 2, config, cats, conts, device=cuda)
    cpu = DeepModel('binary', 2, config, cats, conts, device='cpu')
    cpu.build().load_state_dict(gpu.build().state_dict())
    rng = np.random.default_rng(0)
    X = {'cat': np.stack([rng.integers(0, v, 37) for v in vocabs],
                         axis=1).astype(np.int32),
         'input_continuous_all': rng.normal(size=(37, 3)).astype(np.float32)}
    before = fm_module.fm.launches
    proba = gpu.predict(X, batch_size=16)
    assert fm_module.fm.launches == before + 3
    np.testing.assert_allclose(proba, cpu.predict(X, batch_size=16),
                               atol=1e-5)


def test_deepfm_fit_on_cuda_matches_cpu(cuda):
    from deeptables_torch.models import (CategoricalColumn, ContinuousColumn,
                                         DeepModel, ModelConfig)
    from deeptables_torch.ops.kernels import emb_grad as emb_grad_module
    from deeptables_torch.ops.kernels import fm as fm_module
    vocabs = [50, 7, 300, 20]
    cats = tuple(CategoricalColumn(f'C{i}', v, 16)
                 for i, v in enumerate(vocabs))
    conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
    config = ModelConfig(nets=['linear', 'fm_nets', 'dnn_nets'],
                         task='binary', embedding_dropout=0, metrics=['AUC'],
                         dnn_params={'hidden_units': ((64, 0, False),
                                                      (32, 0, False))})
    gpu = DeepModel('binary', 2, config, cats, conts, device=cuda)
    cpu = DeepModel('binary', 2, config, cats, conts, device='cpu')
    cpu.build().load_state_dict(gpu.build().state_dict())
    rng = np.random.default_rng(0)
    n = 96
    X = {'cat': np.stack([rng.integers(0, v, n) for v in vocabs],
                         axis=1).astype(np.int32),
         'input_continuous_all': rng.normal(size=(n, 3)).astype(np.float32)}
    y = rng.integers(0, 2, n).astype(np.float32)
    val = ({k: v[:32] for k, v in X.items()}, y[:32])
    fwd, bwd = fm_module.fm.launches, fm_module.fm_backward.launches
    grads = emb_grad_module.emb_grad.launches
    h_gpu = gpu.fit(X, y, batch_size=48, epochs=1, validation_data=val,
                    shuffle=False, verbose=0)
    assert fm_module.fm_backward.launches == bwd + 2
    assert emb_grad_module.emb_grad.launches == grads + 2
    assert fm_module.fm.launches > fwd
    h_cpu = cpu.fit(X, y, batch_size=48, epochs=1, validation_data=val,
                    shuffle=False, verbose=0)
    for key in ('loss', 'val_loss', 'val_auc'):
        np.testing.assert_allclose(h_gpu.history[key], h_cpu.history[key],
                                   rtol=1e-4, err_msg=key)
    cpu_state = cpu.module.state_dict()
    for key, value in gpu.module.state_dict().items():
        np.testing.assert_allclose(value.cpu().numpy(),
                                   cpu_state[key].numpy(), atol=2e-4,
                                   err_msg=key)


def test_model_file_moves_between_card_and_cpu(cuda, tmp_path):
    from deeptables_torch.models import (CategoricalColumn, ContinuousColumn,
                                         DeepModel, ModelConfig)
    vocabs = [50, 7, 300, 20]
    cats = tuple(CategoricalColumn(f'C{i}', v, 16)
                 for i, v in enumerate(vocabs))
    conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
    config = ModelConfig(nets=['linear', 'fm_nets', 'dnn_nets'],
                         task='binary', embedding_dropout=0.1,
                         dnn_params={'hidden_units': ((64, 0.1, False),)})
    rng = np.random.default_rng(1)
    X = {'cat': np.stack([rng.integers(0, v, 64) for v in vocabs],
                         axis=1).astype(np.int32),
         'input_continuous_all': rng.normal(size=(64, 3)).astype(np.float32)}
    y = rng.integers(0, 2, 64).astype(np.float32)
    gpu = DeepModel('binary', 2, config, cats, conts, device=cuda)
    gpu.fit(X, y, batch_size=16, epochs=1, verbose=0)
    gpu.save(tmp_path / 'card.pt')
    cpu = DeepModel.load(tmp_path / 'card.pt', device='cpu')
    np.testing.assert_allclose(cpu.predict(X), gpu.predict(X), atol=1e-5)
    cpu.save(tmp_path / 'cpu.pt')
    back = DeepModel.load(tmp_path / 'cpu.pt', device=cuda)
    assert back.device.type == 'cuda'
    np.testing.assert_array_equal(back.predict(X), gpu.predict(X))
