# -*- coding:utf-8 -*-
"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. This file imports torch and the port only (no JAX),
so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 rtol 1e-5 (the kernel and the plain version sum in
another order); bfloat16 rtol 1e-2 against the plain version in float32 (one
rounding of the output to bfloat16). Both carry an absolute term of the same
relative size times the largest ``Σ_f,d x²`` of a row: FM is a difference of
two sums of that size, which cancel to zero at F = 1.
"""

import numpy as np
import pytest
import torch

from deeptables_torch.ops.kernels.fm import fm, fm_reference

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


def test_fm_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(8, 4, 16, device=cuda)
    with pytest.raises(TypeError):
        fm(x.half())
    with pytest.raises(ValueError):
        fm(x.transpose(1, 2))
    with pytest.raises(NotImplementedError, match='training slice'):
        fm(x.clone().requires_grad_(True))


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
