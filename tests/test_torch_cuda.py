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
- Embedding gradient: against ``emb_grad_reference`` (``index_add_``, with
  atomics on the card) rtol 1e-5, atol 1e-5 times the largest row sum of
  ``|g|`` that meets in one table row: the kernel adds a segment cut by its
  chunks as a sum of pieces, another association, so only rounding may
  differ. Against ``emb_grad_sorted_reference`` on the CPU, which adds the
  same float32 values in the same order, and against a second call of the
  kernel: bit for bit (``torch.equal``).
- DeepFM fit on the card against the CPU (also with each head, loss,
  optimizer and regularizer): losses rtol 1e-4; parameters atol 2e-4 (Adam
  moves each parameter by up to lr = 1e-3 a step whatever the gradient's
  size, so rounding in a gradient near zero shows at that scale); GHMC's
  bin counts atol 1 (one example within rounding of a bin edge).
- CIN forward and backward: the kernels and the plain versions both take
  float32 products and sums of the same inputs (bfloat16 inputs are exact in
  float32; float32 operands go to the tensor cores as three exact bfloat16
  planes, whose six plane products miss a float32 product by ~2·2⁻²⁴ of
  it), so every output is held to 1e-5 times the sum of the magnitudes of
  its terms (the plain version run on |x0|, |h|, |w|, |dz|): only the order
  and rounding of the sums differ. dx0 and dh in bfloat16 add rtol 1e-2 for their
  one rounding to bfloat16 (the two may round neighbouring values apart).
- Field attention (K5) and the fused block (K6), forward and backward:
  both sides compute in float32 from the same inputs, so every output is
  held to 1e-5 of its tensor's largest value; outputs in bfloat16 add rtol
  1e-2 for their one rounding. K6's backward leaves out the examples with a
  projection within 1e-5 of 0 (``ab_mask_margin``): there the two sums,
  taken in another order, may take the two sides of its relu mask.
- Row-sharded lookups' pieces (one process, S row blocks of one table):
  the dispatch plan and the masked local gather bit for bit against the
  CPU; each block's K1 gradient by the embedding gradient's rules above.
"""

import numpy as np
import pytest
import torch

from deeptables_torch.ops.kernels import cin as cin_module
from deeptables_torch.ops.kernels.cin import (bwd_design, cin_bwd,
                                              cin_bwd_reference, cin_fwd,
                                              cin_fwd_reference, fwd_design,
                                              split_bf16x3)
from deeptables_torch.ops.kernels import field_attention as fa
from deeptables_torch.ops.kernels import fm as fm_module
from deeptables_torch.ops.kernels import emb_grad as eg_module
from deeptables_torch.ops.kernels.emb_grad import (emb_grad, emb_grad_design,
                                                   emb_grad_reference,
                                                   emb_grad_sorted_reference)
from deeptables_torch.ops.kernels.fm import (fm, fm_backward,
                                             fm_backward_reference,
                                             fm_design, fm_reference,
                                             fm_vec16_plan,
                                             pointer_alignment)

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
                                   (4096, 26, 16), (8192, 26, 16),
                                   (12288, 26, 16), (64, 3, 4), (33, 5, 256),
                                   (7, 1, 12), (300, 26, 33), (5, 200, 8),
                                   (9, 2, 64)])
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


def _ran(fn, *args, calls=3):
    """The names of the kernels (``*kernel*``) that calls of fn launched
    (torch.profiler). The profiler may lose a window's first kernels (a
    process's first window most of all), so each kernel must be seen once a
    call; a window that lost some is run again, up to twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args)  # built and warm
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and 'kernel' in e.key]
        if kernels and all(e.count == calls for e in kernels):
            break
    return {e.key for e in kernels}


def _offset_view(shape, dtype, gen, cuda):
    """A contiguous tensor of ``shape`` one element into its storage, so its
    data pointer is not 16-byte aligned."""
    n = int(np.prod(shape))
    flat = torch.randn(n + 1, generator=gen).to(dtype).to(cuda)
    return flat[1:].view(shape)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B', [1, 4093, 4096, 8192, 12288])
def test_fm_kernel_on_an_offset_view(cuda, B, dtype):
    """x one element into its storage runs the scalar design, and is
    right."""
    gen = torch.Generator().manual_seed(B + 7)
    x = _offset_view((B, 26, 16), dtype, gen, cuda)
    assert fm_design(dtype, B, 26, 16, pointer_alignment(x)) == 'scalar'
    before = fm.launches
    out = fm(x)
    torch.cuda.synchronize()
    assert fm.launches == before + 1
    _close(out, fm_reference(x.float()), x, RTOL[dtype])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,F,D,offset', [
    (4096, 26, 16, 0), (4096, 26, 16, 1), (37, 26, 16, 0), (64, 3, 4, 0),
    (7, 1, 12, 0), (33, 5, 256, 0), (5, 200, 8, 0), (9, 2, 64, 0)])
def test_fm_design_names_the_kernel_that_ran(cuda, B, F, D, offset, dtype):
    gen = torch.Generator().manual_seed(B + F + D)
    x = (_offset_view((B, F, D), dtype, gen, cuda) if offset else
         torch.randn(B, F, D, generator=gen).to(dtype).to(cuda))
    names = _ran(fm, x)
    vec16 = {n for n in names if 'fm_fwd_vec16_kernel' in n}
    scalar = {n for n in names if 'fm_fwd_kernel<' in n}
    if fm_design(dtype, B, F, D, pointer_alignment(x)) == 'vec16':
        chunks, slices = fm_vec16_plan(dtype, F, D)
        t = 'float' if dtype == torch.float32 else '__nv_bfloat16'
        assert len(vec16) == 1 and not scalar, names
        assert f'fm_fwd_vec16_kernel<{t}, {chunks}, {slices}>' in \
            vec16.pop(), names
    else:
        assert len(scalar) == 1 and not vec16, names


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
    assert torch.equal(out.cpu(), emb_grad_sorted_reference(
        ids.cpu(), g.cpu(), num_rows))


@pytest.mark.parametrize('B', [1, 37, 4093, 8192])
@pytest.mark.parametrize('D', [4, 8, 12, 16, 32, 33, 36])
def test_emb_grad_kernel_on_zipf_ids(cuda, B, D):
    rng = np.random.default_rng(B + D)
    vocabs = [7, 300, 2500, 100000]
    ids = torch.from_numpy(_zipf_ids(B, vocabs, rng)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(len(ids), D)).astype(np.float32))
    _check_emb_grad(ids, g.to(cuda), sum(vocabs))


def test_emb_grad_kernel_at_the_avazu_shape(cuda):
    """AutoInt's schema: 22 avazu-style columns at its training batch."""
    from deeptables_torch.data.datasets import _avazu_fields
    fields, _ = _avazu_fields(n_rows=8192, seed=5)
    cat = np.stack(list(fields.values()), axis=1)
    vocabs = cat.max(axis=0) + 2
    offsets = np.concatenate([[0], np.cumsum(vocabs)[:-1]])
    ids = torch.from_numpy((cat + offsets).astype(np.int32).reshape(-1))
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(len(ids), 16)).astype(np.float32)).to(cuda)
    assert emb_grad_design(len(ids), 16, int(vocabs.sum()),
                           pointer_alignment(g)) == 'segment_v4'
    _check_emb_grad(ids.to(cuda), g, int(vocabs.sum()))


@pytest.mark.parametrize('B', [1, 37, 4093, 8192])
@pytest.mark.parametrize('D', [4, 16, 33])
def test_emb_grad_kernel_on_an_offset_g(cuda, B, D):
    """g one element into its storage (a view with an offset, as
    ``EmbeddingLookup.backward`` may pass): right all the same."""
    rng = np.random.default_rng(B * D)
    vocabs = [7, 300, 2500, 100000]
    ids = torch.from_numpy(_zipf_ids(B, vocabs, rng)).to(cuda)
    gen = torch.Generator().manual_seed(B * D)
    g = _offset_view((len(ids), D), torch.float32, gen, cuda)
    assert pointer_alignment(g) == 4
    assert emb_grad_design(len(ids), D, sum(vocabs), 4) == 'segment_scalar'
    _check_emb_grad(ids, g, sum(vocabs))


@pytest.mark.parametrize('B,D,offset', [
    (4093, 16, 0), (4093, 16, 1), (37, 4, 0), (37, 12, 0), (37, 33, 0),
    (37, 36, 0), (37, 4, 1), (1, 8, 2)])
def test_emb_grad_design_names_the_kernel_that_ran(cuda, B, D, offset):
    rng = np.random.default_rng(B + D + offset)
    vocabs = [7, 300, 2500, 100000]
    ids = torch.from_numpy(_zipf_ids(B, vocabs, rng)).to(cuda)
    gen = torch.Generator().manual_seed(B + D)
    g = (_offset_view((len(ids), D), torch.float32, gen, cuda) if offset
         else torch.randn(len(ids), D, generator=gen).to(cuda))
    names = _ran(emb_grad, ids, g, sum(vocabs))
    ran = {k for k in ('segment_kernel<float4>', 'merge_kernel<float4>',
                       'segment_kernel<float>', 'merge_kernel<float>')
           if any(k in n for n in names)}
    assert any('zero_kernel' in n for n in names), names
    if emb_grad_design(len(ids), D, sum(vocabs),
                       pointer_alignment(g)) == 'segment_v4':
        assert ran == {'segment_kernel<float4>', 'merge_kernel<float4>'}, names
    else:
        assert ran == {'segment_kernel<float>', 'merge_kernel<float>'}, names


def test_emb_grad_v4_refuses_what_it_does_not_take(cuda, monkeypatch):
    """The v4 variant given a misaligned g or a D not a multiple of 4: the
    C side refuses the launch, the wrapper raises and counts no launch."""
    gen = torch.Generator().manual_seed(4)
    ids = torch.zeros(8, dtype=torch.int32, device=cuda)
    monkeypatch.setattr(eg_module, 'emb_grad_design',
                        lambda *args: 'segment_v4')
    before = emb_grad.launches
    for g in (_offset_view((8, 16), torch.float32, gen, cuda),
              torch.randn(8, 6, generator=gen).to(cuda)):
        with pytest.raises(RuntimeError, match='emb_grad kernel launch'):
            emb_grad(ids, g, 10)
    assert emb_grad.launches == before


def _criteo_flat_ids(B, kind, seed):
    """The criteo schema's flat ids (26 columns, offsets of vocab + 1, as
    the model lays out the table): its Zipf ids, or uniform ones."""
    from deeptables_torch.data.datasets import load_criteo_synthetic
    cat, _, _, vocabs = load_criteo_synthetic(n_rows=B, seed=seed,
                                              return_arrays=True)
    if kind == 'uniform':
        rng = np.random.default_rng(seed)
        cat = np.stack([rng.integers(0, v + 1, B) for v in vocabs], axis=1)
    offsets = np.concatenate([[0], np.cumsum(vocabs + 1)[:-1]])
    flat = (cat + offsets).astype(np.int32).reshape(-1)
    return torch.from_numpy(flat), int(np.sum(vocabs + 1))


def _avazu_flat_ids(B, seed):
    from deeptables_torch.data.datasets import _avazu_fields
    fields, _ = _avazu_fields(n_rows=B, seed=seed)
    cat = np.stack(list(fields.values()), axis=1)
    vocabs = cat.max(axis=0) + 2
    offsets = np.concatenate([[0], np.cumsum(vocabs)[:-1]])
    return (torch.from_numpy((cat + offsets).astype(np.int32).reshape(-1)),
            int(vocabs.sum()))


@pytest.mark.parametrize('case', [
    *(f'{kind}-{B}' for kind in ('zipf', 'uniform')
      for B in (64, 512, 4093, 8192)),
    'avazu-8192', 'one_row-8192', 'offset-8192'])
def test_emb_grad_kernel_is_deterministic(cuda, case):
    """The sorted segment sum adds without atomics, in an order fixed by
    the inputs: two calls give the same bits, and those of the plain twin
    of that order on the CPU."""
    kind, B = case.rsplit('-', 1)
    B = int(B)
    if kind == 'avazu':
        ids, V = _avazu_flat_ids(B, 5)
    else:
        ids, V = _criteo_flat_ids(B, 'uniform' if kind == 'uniform'
                                  else 'zipf', B)
    if kind == 'one_row':
        ids = torch.full_like(ids, 5)
    gen = torch.Generator().manual_seed(B)
    g = (_offset_view((len(ids), 16), torch.float32, gen, cuda)
         if kind == 'offset' else
         torch.randn(len(ids), 16, generator=gen).to(cuda))
    ids = ids.to(cuda)
    first = emb_grad(ids, g, V)
    second = emb_grad(ids, g, V)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), emb_grad_sorted_reference(
        ids.cpu(), g.cpu(), V))


def test_fm_vec16_refuses_what_it_does_not_take(cuda, monkeypatch):
    """vec16 given a misaligned x: the C side refuses the launch, the
    wrapper raises and counts no launch, and nothing else runs."""
    gen = torch.Generator().manual_seed(3)
    x = _offset_view((8, 26, 16), torch.bfloat16, gen, cuda)
    monkeypatch.setattr(fm_module, 'fm_design', lambda *args: 'vec16')
    before = fm.launches
    with pytest.raises(RuntimeError, match='fm kernel launch failed'):
        fm(x)
    assert fm.launches == before


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


HEADS = [('multiclass', 5, 'categorical_crossentropy', 'adamw', {}),
         ('regression', 1, 'mse', 'rmsprop', {}),
         ('regression', 1, 'huber', 'adagrad', {}),
         ('multilabel', 3, 'multilabel_binary_crossentropy', 'lamb', {}),
         ('binary', 2, 'binary_focal_loss', 'adam', {}),
         ('binary', 2, 'ghmc', 'adam', {}),
         ('binary', 2, 'binary_crossentropy', 'adam',
          {'embeddings_regularizer': 'l2',
           'embeddings_activity_regularizer': 'l1'})]


@pytest.mark.parametrize('task,classes,loss,optimizer,extra', HEADS,
                         ids=[f'{h[0]}-{h[2]}-{h[3]}' for h in HEADS])
def test_deepfm_heads_fit_on_cuda_matches_cpu(cuda, task, classes, loss,
                                              optimizer, extra):
    """Each head, loss, optimizer and regularizer of the port through
    ``fit`` on the card and the CPU from the same weights: the sibling
    test's tolerances; GHMC's state (bin counts) within one example, which
    may sit within rounding of a bin edge."""
    from deeptables_torch.models import (CategoricalColumn, ContinuousColumn,
                                         DeepModel, ModelConfig)
    from deeptables_torch.ops.kernels import emb_grad as emb_grad_module
    vocabs = [50, 7, 300, 20]
    cats = tuple(CategoricalColumn(f'C{i}', v, 16)
                 for i, v in enumerate(vocabs))
    conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
    config = ModelConfig(nets=['linear', 'fm_nets', 'dnn_nets'], task=task,
                         embedding_dropout=0, metrics=['mse'], loss=loss,
                         optimizer=optimizer,
                         dnn_params={'hidden_units': ((64, 0, False),
                                                      (32, 0, False))},
                         **extra)
    gpu = DeepModel(task, classes, config, cats, conts, device=cuda)
    cpu = DeepModel(task, classes, config, cats, conts, device='cpu')
    cpu.build().load_state_dict(gpu.build().state_dict())
    rng = np.random.default_rng(3)
    n = 96
    X = {'cat': np.stack([rng.integers(0, v, n) for v in vocabs],
                         axis=1).astype(np.int32),
         'input_continuous_all': rng.normal(size=(n, 3)).astype(np.float32)}
    y = {'multiclass': rng.integers(0, classes, n).astype(np.int32),
         'multilabel': (rng.uniform(size=(n, classes)) < 0.4).astype(
             np.float32),
         'regression': rng.normal(1, 2, n).astype(np.float32)}.get(
        task, rng.integers(0, 2, n).astype(np.float32))
    val = ({k: v[:32] for k, v in X.items()}, y[:32])
    grads = emb_grad_module.emb_grad.launches
    h_gpu = gpu.fit(X, y, batch_size=48, epochs=1, validation_data=val,
                    shuffle=False, verbose=0)
    assert emb_grad_module.emb_grad.launches == grads + 2
    h_cpu = cpu.fit(X, y, batch_size=48, epochs=1, validation_data=val,
                    shuffle=False, verbose=0)
    for key in ('loss', 'val_loss'):
        np.testing.assert_allclose(h_gpu.history[key], h_cpu.history[key],
                                   rtol=1e-4, err_msg=key)
    cpu_state = cpu.module.state_dict()
    for key, value in gpu.module.state_dict().items():
        np.testing.assert_allclose(value.cpu().numpy(),
                                   cpu_state[key].numpy(), atol=2e-4,
                                   err_msg=key)
    if loss == 'ghmc':
        assert gpu.loss_state.device.type == 'cuda'
        np.testing.assert_allclose(gpu.loss_state.cpu().numpy(),
                                   cpu.loss_state.numpy(), atol=1.0)
    else:
        assert gpu.loss_state is None


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


# ---------------------------------------------------------------- CIN

CIN_SHAPES = [(4096, 26, 26, 128, 16), (8192, 26, 64, 128, 16),
              (4093, 26, 26, 128, 16), (37, 5, 7, 12, 16), (3, 4, 130, 9, 5),
              (1, 26, 64, 128, 4096), (2, 1, 1, 1, 1)]
# the forward's tensor-core kernels at their edges: L not a multiple of 8,
# L past one 128-wide tile, D that does not divide its 128 columns, B = 1,
# F + G = 252, the float32 kernels' top (K = 15876: their longest sums),
# and F + G past their shared memory (the CUDA-core kernel then runs:
# F + G = 253 in float32, 703 in both types)
CIN_FWD_SHAPES = CIN_SHAPES + [
    (37, 26, 26, 100, 16), (64, 26, 64, 256, 16), (5, 7, 9, 300, 16),
    (41, 26, 26, 128, 12), (17, 5, 13, 128, 33), (1, 26, 64, 128, 16),
    (64, 126, 126, 128, 16), (3, 3, 700, 5, 4), (19, 26, 227, 8, 16)]


def _fwd_expected(dtype, F, G):
    if dtype == torch.bfloat16:
        return 'wgmma' if F + G <= 602 else 'simt'
    return 'wgmma_f32' if F + G <= 252 else 'simt'

# the backward's tensor-core kernels at their edges: L not a multiple of 16
# and past one 128-wide tile, G of one n32 tile, one n64 tile and two (dx0
# partials), D that does not divide the 64- and 128-column tiles, B = 1 and
# the batch-minor (1, F, D·B) call, F + G = 252 (K = 15876: the longest dW
# and dx0 sums); and bfloat16 shapes past shared memory
# (G = 700: the dW pass's h rows; L = 900: the dx0/dh pass's dz tile),
# which take the CUDA-core kernels
CIN_BWD_SIMT = [(3, 3, 700, 5, 4), (5, 4, 6, 900, 16)]
# ... and float32 shapes past the three dz planes' shared memory (L = 300,
# 257 and 385 for G ≤ 32; 193, 256 and 337 for G > 32), which take the
# dx0/dh pass that splits dz in registers up to its own limit (L ≤ 384 for
# G ≤ 32, L ≤ 336 past it) and the CUDA cores past that; and G = 229, past
# the dW pass's h rows
CIN_BWD_RS_F32 = [(5, 7, 9, 300, 16), (64, 26, 64, 256, 16),
                  (7, 5, 20, 257, 16), (9, 26, 64, 193, 16),
                  (7, 5, 20, 384, 16), (9, 26, 64, 336, 16),
                  (3, 26, 200, 200, 10)]
CIN_BWD_SIMT_F32 = [(6, 3, 229, 5, 16), (7, 5, 20, 385, 16),
                    (9, 26, 64, 337, 16)]
CIN_BWD_SHAPES = CIN_SHAPES + [
    (37, 26, 26, 100, 16), (64, 26, 64, 256, 16), (5, 7, 9, 300, 16),
    (300, 26, 128, 128, 16), (19, 5, 26, 40, 16), (41, 26, 26, 128, 12),
    (17, 5, 13, 128, 33), (1, 26, 64, 128, 16), (1, 26, 26, 128, 592),
    (64, 126, 126, 128, 16)] + CIN_BWD_SIMT + [(7, 5, 20, 257, 16), (9, 26, 64, 193, 16),
                        (6, 3, 229, 5, 16), (11, 26, 64, 192, 16),
                        (6, 3, 228, 5, 16), (7, 5, 20, 384, 16),
                        (9, 26, 64, 336, 16), (3, 26, 200, 200, 10),
                        (7, 5, 20, 385, 16), (9, 26, 64, 337, 16)]


def _bwd_expected(dtype, shape):
    if dtype == torch.bfloat16:
        return 'simt' if shape in CIN_BWD_SIMT else 'wgmma'
    if shape in CIN_BWD_RS_F32:
        return 'wgmma_f32_rs'
    return 'simt' if shape in CIN_BWD_SIMT + CIN_BWD_SIMT_F32 \
        else 'wgmma_f32'


def _cin_inputs(B, F, G, L, D, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype).cuda()
            for shape in ((B, F, D), (B, G, D), (L, F, G), (B, L, D))]


def _cin_close(actual, expected, scale, rtol_out=0.):
    actual, expected = actual.float().cpu(), expected.float().cpu()
    err = (actual - expected).abs()
    limit = 1e-5 * scale.float().cpu() + rtol_out * expected.abs()
    assert bool((err <= limit).all()), float((err - limit).max())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,F,G,L,D', CIN_FWD_SHAPES)
def test_cin_fwd_kernel_matches_reference(cuda, B, F, G, L, D, dtype):
    x0, h, w, _ = _cin_inputs(B, F, G, L, D, dtype, B + F + G + L + D)
    assert fwd_design(dtype, F, G) == _fwd_expected(dtype, F, G)
    before = cin_fwd.launches
    z = cin_fwd(x0, h, w)
    torch.cuda.synchronize()
    assert cin_fwd.launches == before + 1
    assert z.shape == (B, L, D) and z.dtype == torch.float32
    _cin_close(z, cin_fwd_reference(x0, h, w),
               cin_fwd_reference(x0.abs(), h.abs(), w.abs()))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,F,G,L,D', CIN_BWD_SHAPES)
def test_cin_bwd_kernel_matches_reference(cuda, B, F, G, L, D, dtype):
    x0, h, w, dz = _cin_inputs(B, F, G, L, D, dtype, 7 * B + F + G + L)
    assert bwd_design(dtype, F, G, L) == _bwd_expected(dtype,
                                                       (B, F, G, L, D))
    design = bwd_design(dtype, F, G, L)
    before = cin_bwd.launches, cin_bwd.designs.get(design, 0)
    dx0, dh, dw = cin_bwd(x0, h, w, dz)
    torch.cuda.synchronize()
    assert (cin_bwd.launches, cin_bwd.designs[design]) == (before[0] + 1,
                                                           before[1] + 1)
    assert (dx0.shape, dh.shape, dw.shape) == (x0.shape, h.shape, w.shape)
    assert dx0.dtype == dh.dtype == dtype and dw.dtype == torch.float32
    expected = cin_bwd_reference(x0, h, w, dz)
    scale = cin_bwd_reference(x0.abs(), h.abs(), w.abs(), dz.abs())
    rtol_out = 0. if dtype == torch.float32 else 1e-2
    _cin_close(dx0, expected[0], scale[0].float(), rtol_out)
    _cin_close(dh, expected[1], scale[1].float(), rtol_out)
    _cin_close(dw, expected[2], scale[2])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,F,G,L,D', [(4096, 26, 64, 128, 16),
                                       (3, 4, 130, 9, 5), (3, 3, 700, 5, 4),
                                       (512, 26, 200, 200, 10)])
def test_cin_bwd_runs_the_kernels_its_design_names(cuda, B, F, G, L, D,
                                                   dtype):
    """The kernels that ran, by name (torch.profiler): a shape that fits
    runs its type's tensor-core passes (the ``<float>`` instantiations in
    float32; at 200 maps the dx0/dh pass that splits dz in registers beside
    the float32 dW pass), one ``cin_bwd_dx`` kernel a call, and never the
    CUDA-core ones; ``cin_bwd.designs`` counts each call under its
    design."""
    x0, h, w, dz = _cin_inputs(B, F, G, L, D, dtype, 5)
    design = bwd_design(dtype, F, G, L)
    before = cin_bwd.designs.get(design, 0)
    names = _ran(cin_bwd, x0, h, w, dz)
    assert cin_bwd.designs[design] > before
    wgmma = {n for n in names if 'cin_bwd_' in n and 'wgmma' in n}
    simt = {n for n in names if 'cin_bwd_' in n and 'wgmma' not in n}
    dx = {n for n in wgmma if 'cin_bwd_dx' in n}
    if design == 'simt':
        assert len(simt) == 2 and not wgmma, names
    else:
        f32 = {n for n in wgmma if 'wgmma_kernel<float' in n}
        rs = {n for n in dx if 'cin_bwd_dx_rs_wgmma_kernel<' in n}
        assert len(wgmma) == 2 and len(dx) == 1 and not simt, names
        expected = {'wgmma': (set(), set()), 'wgmma_f32': (wgmma, set()),
                    'wgmma_f32_rs': (wgmma - dx, dx)}[design]
        assert (f32, rs) == expected, names
        assert design == ('wgmma' if dtype == torch.bfloat16
                          else 'wgmma_f32_rs' if L == 200 else 'wgmma_f32')


def test_cin_bwd_launch_failure_raises(cuda, monkeypatch):
    """A tensor-core launch the C side refuses (here a W layout whose L is
    not padded to 64) raises, counts no launch and runs nothing else."""
    x0, h, w, dz = _cin_inputs(64, 5, 7, 12, 16, torch.bfloat16, 2)
    monkeypatch.setattr(cin_module, 'dpair_w',
                        lambda w: w.new_zeros((5, 32, 12 + 1)))
    before = cin_bwd.launches
    with pytest.raises(RuntimeError, match='cin_bwd kernel launch failed'):
        cin_bwd(x0, h, w, dz)
    assert cin_bwd.launches == before


def test_cin_f32_launch_failure_raises(cuda, monkeypatch):
    """The float32 tensor-core launches the C side refuses (W planes whose
    L is not padded to a whole tile) raise and count no launch: no other
    design runs in their place."""
    x0, h, w, dz = _cin_inputs(64, 5, 7, 12, 16, torch.float32, 2)
    monkeypatch.setattr(cin_module, 'padded_w', lambda w: torch.zeros(
        (3, 12, 64), dtype=torch.bfloat16, device=w.device))
    monkeypatch.setattr(cin_module, 'dpair_w', lambda w: torch.zeros(
        (3, 5, 32, 12 + 1), dtype=torch.bfloat16, device=w.device))
    before = cin_fwd.launches, cin_bwd.launches
    with pytest.raises(RuntimeError, match='cin_fwd kernel launch failed'):
        cin_fwd(x0, h, w)
    with pytest.raises(RuntimeError, match='cin_bwd kernel launch failed'):
        cin_bwd(x0, h, w, dz)
    assert (cin_fwd.launches, cin_bwd.launches) == before


@pytest.mark.parametrize('B', [8192, 4093])
@pytest.mark.parametrize('F,G,L', [(26, 26, 128), (26, 64, 128),
                                   (104, 104, 128), (104, 64, 128),
                                   (26, 200, 200)])
def test_cin_f32_kernels_at_the_main_path_shapes(cuda, F, G, L, B):
    """Float32 K4 and K3 on the tensor cores at xDeepFM's layers (128 maps
    and the paper's 200: K3's dx0/dh pass then splits dz in registers) and
    fgcnn_cin's, against the plain versions at 1e-5 of the sum of the
    terms' magnitudes; K3 gives the same bits on a second call (fixed-order
    sums, no atomics)."""
    D = 16
    x0, h, w, dz = _cin_inputs(B, F, G, L, D, torch.float32, B + G)
    design = 'wgmma_f32_rs' if L == 200 else 'wgmma_f32'
    assert fwd_design(torch.float32, F, G) == 'wgmma_f32'
    assert bwd_design(torch.float32, F, G, L) == design
    before = cin_bwd.designs.get(design, 0)
    z = cin_fwd(x0, h, w)
    grads = cin_bwd(x0, h, w, dz)
    again = cin_bwd(x0, h, w, dz)
    torch.cuda.synchronize()
    assert cin_bwd.designs[design] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    del again
    _cin_close(z, cin_fwd_reference(x0, h, w),
               cin_fwd_reference(x0.abs(), h.abs(), w.abs()))
    del z
    expected = cin_bwd_reference(x0, h, w, dz)
    scale = cin_bwd_reference(x0.abs(), h.abs(), w.abs(), dz.abs())
    for got, ref, s in zip(grads, expected, scale):
        _cin_close(got, ref, s)


# (L, the l where w and dz are not zero) of the exact checks: each float32
# K3 design's dx0/dh pass, the dz planes in shared memory at L = 2 and dz
# split in registers at L = 257 (its l in three 64-wide panels and the last
# 16-wide step)
EXACT_L = {'wgmma_f32': (2, None), 'wgmma_f32_rs': (257, (0, 1, 130, 256))}


def _exact_operands(full, seed, B=1, F=2, G=2, L=2, D=2, support=None):
    """Float32 x0, h, w, dz on the card whose contraction and gradient the
    float32 kernels must give bit for bit: the operand ``full`` holds
    values of 20 significant bits, ±[1, 2), the others ±1; w and dz are zero
    at every l but those of ``support`` (all of them by default), at most
    four. Every term, plane product and partial sum is then a multiple of
    2⁻¹⁹ under 2⁴ (at most eight terms a sum), 23 bits: exact in float32
    and in the tensor cores' accumulator. Two bfloat16 planes hold at most
    ~18 bits: the third plane of ``full`` (of the pair where ``full`` is x0
    or h) decides the bits."""
    rng = np.random.RandomState(seed)
    shapes = {'x0': (B, F, D), 'h': (B, G, D), 'w': (L, F, G),
              'dz': (B, L, D)}
    out = {}
    for name, shape in shapes.items():
        signs = rng.choice([-1.0, 1.0], shape)
        if name == full:
            mantissas = rng.randint(2 ** 19, 2 ** 20, shape) | 1
            out[name] = signs * mantissas * 2.0 ** -19
        else:
            out[name] = signs
    if support is not None:
        off = np.setdiff1d(np.arange(L), support)
        out['w'][off] = 0.
        out['dz'][:, off] = 0.
    return [torch.from_numpy(out[k]).float() for k in ('x0', 'h', 'w', 'dz')]


def _exact_contraction(x0, h, w, dz):
    """z, dx0, dh, dW in float64 (exact here) and rounded to float32, which
    must not change them."""
    x0, h, w, dz = (t.double().cpu() for t in (x0, h, w, dz))
    got = (torch.einsum('bfd,bgd,lfg->bld', x0, h, w),
           torch.einsum('bld,lfg,bgd->bfd', dz, w, h),
           torch.einsum('bld,lfg,bfd->bgd', dz, w, x0),
           torch.einsum('bld,bfd,bgd->lfg', dz, x0, h))
    assert all(torch.equal(t.float().double(), t) for t in got)
    return [t.float() for t in got]


def _two_planes(v):
    return split_bf16x3(v)[:2].double().sum(0).float()


@pytest.mark.parametrize('full', ['x0', 'h', 'w', 'dz'])
def test_cin_f32_kernels_keep_every_plane_bit_for_bit(cuda, full):
    """Float32 K4 and K3 on operands whose third bfloat16 plane decides the
    result, while every sum stays exact (``_exact_operands``): z, dx0, dh
    and dW equal the float64 contraction bit for bit, in each float32 K3
    design (``EXACT_L``). Each operand takes the third plane by another
    route: the pair's in K4's and the dW pass's registers (x0, h), W's from
    the wrapper (w), dz's in both K3 passes' stores or, at L = 257, the
    dx0/dh pass's registers (dz). Without that plane the exact answer moves
    (checked here on the CPU), so a kernel that lost it would fail."""
    assert fwd_design(torch.float32, 2, 2) == 'wgmma_f32'
    for design, (L, support) in EXACT_L.items():
        ops = _exact_operands(full, seed=len(full), L=L, support=support)
        exact = _exact_contraction(*ops)
        cut = [_two_planes(t) if name == full else t
               for name, t in zip(('x0', 'h', 'w', 'dz'), ops)]
        assert any(not torch.equal(a, b)
                   for a, b in zip(_exact_contraction(*cut), exact))
        x0, h, w, dz = (t.cuda() for t in ops)
        assert bwd_design(torch.float32, 2, 2, L) == design
        got = (cin_fwd(x0, h, w),) + tuple(cin_bwd(x0, h, w, dz))
        for a, b in zip(got, exact):
            assert torch.equal(a.cpu(), b), design


def test_cin_f32_kernels_without_w_plane3_fail_the_exact_check(
        cuda, monkeypatch):
    """The check above has teeth on the card: with W's third plane zeroed
    where the wrapper lays it out (``padded_w``, ``dpair_w``), z, dx0 and
    dh no longer equal the exact contraction, in each float32 K3 design."""
    for name in ('padded_w', 'dpair_w'):
        layout = getattr(cin_module, name)

        def cut(w, layout=layout):
            out = layout(w)
            out[2] = 0
            return out
        monkeypatch.setattr(cin_module, name, cut)
    for design, (L, support) in EXACT_L.items():
        ops = _exact_operands('w', seed=1, L=L, support=support)
        exact = _exact_contraction(*ops)
        x0, h, w, dz = (t.cuda() for t in ops)
        assert bwd_design(torch.float32, 2, 2, L) == design
        got = (cin_fwd(x0, h, w),) + tuple(cin_bwd(x0, h, w, dz))
        for a, b in zip(got[:3], exact[:3]):
            assert not torch.equal(a.cpu(), b), design
        assert torch.equal(got[3].cpu(), exact[3])  # dW does not read W


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('formulation', ['pallas', 'auto', 'assoc', 'bm'])
def test_cin_contract_runs_the_kernels_for_every_formulation(
        cuda, formulation, dtype):
    from deeptables_torch.ops.cin_grad import cin_contract
    x0, h, w, dz = _cin_inputs(64, 6, 9, 10, 16, dtype, 3)
    h = h.float()  # a previous layer's float32 output
    w = w.float()  # a float32 parameter
    leaves = [t.clone().requires_grad_(True) for t in (x0, h, w)]
    before = cin_fwd.launches, cin_bwd.launches
    z = cin_contract(*leaves, formulation=formulation)
    z.backward(dz.float())
    torch.cuda.synchronize()
    assert (cin_fwd.launches, cin_bwd.launches) == (before[0] + 1,
                                                   before[1] + 1)
    cpu = [t.detach().cpu().requires_grad_(True) for t in (x0, h, w)]
    z_cpu = cin_contract(*cpu, formulation=formulation)
    z_cpu.backward(dz.float().cpu())
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(z.cpu(), z_cpu.detach(), rtol=1e-5,
                               atol=1e-4)
    for card, host in zip(leaves, cpu):
        assert card.grad.dtype == host.grad.dtype == card.dtype
        scale = float(host.grad.abs().max())
        torch.testing.assert_close(card.grad.cpu(), host.grad, rtol=rtol,
                                   atol=rtol * scale)


@pytest.mark.parametrize('extra', [{}, {'use_bias': True}, {'direct': True},
                                   {'use_residual': True}, {'reduce_D': True},
                                   {'layout': 'batch_minor'}])
def test_cin_module_on_cuda_matches_cpu(cuda, extra):
    from deeptables_torch.ops.interactions import CIN
    params = dict({'cross_layer_size': (8, 4), 'activation': 'relu'},
                  **extra)
    cpu = CIN(5, 16, params, generator=torch.Generator().manual_seed(0))
    card = CIN(5, 16, params).to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(37, 5, 16, generator=torch.Generator().manual_seed(1))
    xc = x.cuda().requires_grad_(True)
    before = cin_fwd.launches, cin_bwd.launches
    out = card(xc)
    (out * out.cos()).sum().backward()
    torch.cuda.synchronize()
    assert (cin_fwd.launches, cin_bwd.launches) == (before[0] + 2,
                                                   before[1] + 2)
    xh = x.clone().requires_grad_(True)
    ref = cpu(xh)
    (ref * ref.cos()).sum().backward()
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), rtol=1e-5,
                               atol=1e-5)
    # gradients: sums of hundreds of terms in another order, so the absolute
    # term scales with the largest gradient of the tensor
    grads = {'x': (xc.grad, xh.grad)}
    host = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        grads[name] = (p.grad, host[name].grad)
    for name, (card_grad, host_grad) in grads.items():
        torch.testing.assert_close(
            card_grad.cpu(), host_grad, rtol=1e-4,
            atol=1e-5 * float(host_grad.abs().max()), msg=name)


def test_cin_kernels_reject_what_they_do_not_take(cuda):
    x0, h, w, dz = _cin_inputs(8, 3, 4, 5, 16, torch.float32, 0)
    with pytest.raises(TypeError):
        cin_fwd(x0.half(), h.half(), w.half())
    with pytest.raises(TypeError):
        cin_fwd(x0, h.bfloat16(), w)
    with pytest.raises(ValueError):
        cin_fwd(x0.transpose(0, 2).contiguous().transpose(0, 2), h, w)
    with pytest.raises(ValueError):
        cin_fwd(x0, h, w.cpu())
    with pytest.raises(ValueError):
        cin_bwd(x0, h, w, dz[:, :4])
    with pytest.raises(TypeError):
        cin_bwd(x0, h, w, dz.bfloat16())


def _xdeepfm(cuda, cin_params=None):
    from deeptables_torch.models import (CategoricalColumn, ContinuousColumn,
                                         DeepModel, ModelConfig)
    vocabs = [50, 7, 300, 20]
    cats = tuple(CategoricalColumn(f'C{i}', v, 16)
                 for i, v in enumerate(vocabs))
    conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
    config = ModelConfig(
        nets=['linear', 'cin_nets', 'dnn_nets'], task='binary',
        embedding_dropout=0, metrics=['AUC'],
        cin_params=dict({'cross_layer_size': (16, 8), 'activation': 'relu'},
                        **(cin_params or {})),
        dnn_params={'hidden_units': ((64, 0, False), (32, 0, False))})
    gpu = DeepModel('binary', 2, config, cats, conts, device=cuda)
    cpu = DeepModel('binary', 2, config, cats, conts, device='cpu')
    cpu.build().load_state_dict(gpu.build().state_dict())
    rng = np.random.default_rng(0)
    n = 96
    X = {'cat': np.stack([rng.integers(0, v, n) for v in vocabs],
                         axis=1).astype(np.int32),
         'input_continuous_all': rng.normal(size=(n, 3)).astype(np.float32)}
    y = rng.integers(0, 2, n).astype(np.float32)
    return gpu, cpu, X, y


@pytest.mark.parametrize('layout', ['auto', 'batch_minor'])
def test_xdeepfm_on_cuda_matches_cpu(cuda, layout):
    gpu, cpu, X, _ = _xdeepfm(cuda, {'layout': layout})
    before = cin_fwd.launches
    proba = gpu.predict(X, batch_size=32)
    assert cin_fwd.launches == before + 6  # two layers, three batches
    np.testing.assert_allclose(proba, cpu.predict(X, batch_size=32),
                               atol=1e-5)


def test_xdeepfm_fit_on_cuda_matches_cpu(cuda):
    gpu, cpu, X, y = _xdeepfm(cuda)
    val = ({k: v[:32] for k, v in X.items()}, y[:32])
    fwd, bwd = cin_fwd.launches, cin_bwd.launches
    h_gpu = gpu.fit(X, y, batch_size=48, epochs=1, validation_data=val,
                    shuffle=False, verbose=0)
    assert cin_bwd.launches == bwd + 4  # two layers, two steps
    assert cin_fwd.launches == fwd + 6  # ... and one validation batch
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


# ---------------------------------------------------------------- AutoInt

# (B, F, H, dh): odd shapes (dh not a power of two, F > 32, B = 1) and the
# AutoInt configuration (F=22, 2 heads of dh=8) at its training batch
FA_SHAPES = [(37, 7, 3, 5), (5, 40, 2, 8), (1, 22, 2, 8), (9, 3, 1, 64),
             (8192, 22, 2, 8),
             # heads wider than 64 (in slices), and buffers past shared
             # memory: K5-bwd at F=200 and at F=160, U=16; K6-bwd at F=80,
             # U=64; K6 at U=128, where w_aug is read from device memory
             (37, 7, 1, 96), (37, 7, 2, 128), (37, 200, 2, 8),
             (37, 160, 2, 8), (37, 80, 1, 64), (37, 22, 1, 128),
             (37, 22, 2, 64)]
FA_TYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.bfloat16, torch.float32)]
FA_TYPE_IDS = ['f32', 'bf16', 'bf16-f32out']
F32, BF16, BF16_F32 = FA_TYPES
# ragged tiles of the tile designs: every B, F and (H, dh) of these
RAGGED_TILES = [(B, F, H, dh) for B in (1, 7, 4093, 8192)
                for F in (3, 7, 22, 39)
                for H, dh in ((2, 8), (1, 16), (4, 16), (3, 5))]
# K5's tile design at ragged tiles (the shapes of FA_SHAPES left out), then
# the shapes on each side of where it hands over to the one-warp kernels:
# dh = 64 and 65; F = 98 and 99 at (2, 8) in float32, 103 and 104 with a
# float32 output or do, 105 and 106 in bfloat16, where the backward's tile
# outgrows shared memory
FA_TILE_SHAPES = [
    shape for shape in RAGGED_TILES
    + [(37, 7, 1, 64), (37, 7, 1, 65), (37, 98, 2, 8), (37, 99, 2, 8),
       (37, 103, 2, 8), (37, 104, 2, 8), (37, 105, 2, 8), (37, 106, 2, 8)]
    if shape not in FA_SHAPES]
# (F, H, dh): the type pairs that run K5's one-warp kernels there (heads
# past 64, and the tiles past shared memory); every other shape of
# FA_SHAPES and FA_TILE_SHAPES runs the tile
FA_WARP = {(7, 1, 96): set(FA_TYPES), (7, 2, 128): set(FA_TYPES),
           (200, 2, 8): set(FA_TYPES), (160, 2, 8): set(FA_TYPES),
           (22, 1, 128): set(FA_TYPES), (7, 1, 65): set(FA_TYPES),
           (80, 1, 64): {F32, BF16_F32}, (99, 2, 8): {F32},
           (103, 2, 8): {F32}, (104, 2, 8): {F32, BF16_F32},
           (105, 2, 8): {F32, BF16_F32}, (106, 2, 8): set(FA_TYPES)}


def _fa_inputs(B, F, H, dh, dtype, out_dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    U = H * dh
    q, k, v, x, dx = (torch.randn(B, F, U, generator=gen).to(dtype).cuda()
                      for _ in range(5))
    do = torch.randn(B, F, U, generator=gen).to(out_dtype).cuda()
    w = (0.35 * torch.randn(U + 1, 4 * U, generator=gen)).to(dtype).cuda()
    return q, k, v, do, x, w, dx


def _fa_close(actual, expected, keep=None):
    assert actual.shape == expected.shape and actual.dtype == expected.dtype
    if keep is not None:
        actual, expected = actual[keep], expected[keep]
    rtol = 1e-2 if expected.dtype == torch.bfloat16 else 0.
    actual, expected = actual.float().cpu(), expected.float().cpu()
    limit = 1e-5 * float(expected.abs().max()) + rtol * expected.abs()
    err = (actual - expected).abs()
    assert bool((err <= limit).all()), float((err - limit).max())


@pytest.mark.parametrize('dtype,out_dtype', FA_TYPES, ids=FA_TYPE_IDS)
@pytest.mark.parametrize('B,F,H,dh', FA_SHAPES + FA_TILE_SHAPES)
def test_field_attention_kernels_match_reference(cuda, B, F, H, dh, dtype,
                                                 out_dtype):
    warp = (dtype, out_dtype) in FA_WARP.get((F, H, dh), ())
    assert fa.fa_design(dtype, out_dtype, B, F, H, dh) == (
        'warp' if warp else 'tile')
    q, k, v, do, _, _, _ = _fa_inputs(B, F, H, dh, dtype, out_dtype,
                                      B + F + H + dh)
    before = fa.fa_fwd.launches, fa.fa_bwd.launches
    out = fa.fa_fwd(q, k, v, H, out_dtype)
    grads = fa.fa_bwd(q, k, v, do, H)
    torch.cuda.synchronize()
    assert (fa.fa_fwd.launches, fa.fa_bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
    _fa_close(out, fa.fa_fwd_reference(q, k, v, H, out_dtype))
    for got, ref in zip(grads, fa.fa_bwd_reference(q, k, v, do, H)):
        _fa_close(got, ref)


def test_field_attention_kernels_at_the_papers_widths(cuda):
    """K5 at the AutoInt paper's widths and the benchmark cell's batch:
    B = 32,768, F = 22, 2 heads of dh = 32, float32, where the tile design
    takes 2 examples a forward tile and 1 a backward tile (88 and 44 of a
    block's threads); the tolerances of the test above."""
    B, F, H, dh = 32768, 22, 2, 32
    assert fa.fa_design(*F32, B, F, H, dh) == 'tile'
    assert (fa.fa_tile_examples('fa_fwd', *F32, F, H, dh),
            fa.fa_tile_examples('fa_bwd', *F32, F, H, dh)) == (2, 1)
    q, k, v, do, _, _, _ = _fa_inputs(B, F, H, dh, *F32, 32)
    before = fa.fa_fwd.launches, fa.fa_bwd.launches
    out = fa.fa_fwd(q, k, v, H)
    grads = fa.fa_bwd(q, k, v, do, H)
    torch.cuda.synchronize()
    assert (fa.fa_fwd.launches, fa.fa_bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
    _fa_close(out, fa.fa_fwd_reference(q, k, v, H))
    for got, ref in zip(grads, fa.fa_bwd_reference(q, k, v, do, H)):
        _fa_close(got, ref)


# K6's tile design at ragged tiles: every B, F and (H, dh) of these (the
# shapes of FA_SHAPES left out), then the shapes on each side of where the
# design hands over to the one-warp kernels: U = 64 and 72; F = 104 and
# 105 at (2, 8) in bfloat16, F = 38 and 39 at (4, 16) in float32, where
# the backward's tile outgrows shared memory
AB_TILE_SHAPES = [
    shape for shape in RAGGED_TILES
    + [(37, 22, 1, 64), (37, 22, 1, 72), (37, 104, 2, 8), (37, 105, 2, 8),
       (37, 38, 4, 16)]
    if shape not in FA_SHAPES]
# (F, H, dh, dtype) that run the one-warp kernels (dtype None: both types):
# U past 64, and the tiles past shared memory
AB_WARP = {(7, 1, 96, None), (7, 2, 128, None), (200, 2, 8, None),
           (160, 2, 8, None), (80, 1, 64, None), (22, 1, 128, None),
           (22, 2, 64, None), (22, 1, 72, None), (105, 2, 8, None),
           (104, 2, 8, torch.float32), (39, 4, 16, torch.float32)}


def _block_inputs(B, F, H, dh, dtype, seed):
    """x, w_aug, do for K6 and the examples outside the relu masks'
    margin (``ab_mask_margin``), at least half of them and one at least:
    an example within the margin cannot be compared, and at B = 1 a draw
    may leave none, so this takes the first of a few seeds that leaves
    enough."""
    for s in range(seed, seed + 8):
        _, _, _, _, x, w, dx = _fa_inputs(B, F, H, dh, dtype, dtype, s)
        keep = (fa.ab_mask_margin(x, w, H) >= 1e-5).cpu()
        if int(keep.sum()) >= max(1, B / 2):
            return x, w, dx, keep
    raise AssertionError(f'no draw of {(B, F, H, dh)} leaves half the '
                         f'examples outside the mask margin')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,F,H,dh', FA_SHAPES + AB_TILE_SHAPES)
def test_attention_block_kernels_match_reference(cuda, B, F, H, dh, dtype):
    warp = {(F, H, dh, None), (F, H, dh, dtype)} & AB_WARP
    assert fa.ab_design(dtype, B, F, H, dh) == ('warp' if warp else 'tile')
    x, w, dx, keep = _block_inputs(B, F, H, dh, dtype, 3 * B + F)
    before = fa.ab_fwd.launches, fa.ab_bwd.launches
    out = fa.ab_fwd(x, w, H)
    dpre = fa.ab_bwd(x, w, dx, H)
    torch.cuda.synchronize()
    assert (fa.ab_fwd.launches, fa.ab_bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
    _fa_close(out, fa.ab_fwd_reference(x, w, H))
    _fa_close(dpre, fa.ab_bwd_reference(x, w, dx, H), keep)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B,F,H,dh', [(8192, 22, 2, 8), (4093, 39, 3, 5)])
def test_attention_block_tile_kernels_are_deterministic(cuda, B, F, H, dh,
                                                        dtype):
    """The tile design sums in a fixed order, without atomics: two runs
    give the same bits."""
    assert fa.ab_design(dtype, B, F, H, dh) == 'tile'
    _, _, _, _, x, w, dx = _fa_inputs(B, F, H, dh, dtype, dtype, 5)
    assert torch.equal(fa.ab_fwd(x, w, H), fa.ab_fwd(x, w, H))
    assert torch.equal(fa.ab_bwd(x, w, dx, H), fa.ab_bwd(x, w, dx, H))


@pytest.mark.parametrize('kind', ['ab_fwd', 'ab_bwd'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('F,H,dh', [(22, 2, 8), (7, 3, 5), (39, 1, 16),
                                    (22, 1, 64), (3, 4, 16)])
def test_attention_block_tile_plan_matches_the_kernel(cuda, kind, dtype, F,
                                                      H, dh):
    """The wrapper's shared-memory sum is the kernel's layout."""
    lib = fa._library()
    examples = fa.ab_tile_examples(kind, dtype, F, H, dh)
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert lib.dt_ab_tile_smem(int(kind == 'ab_bwd'), itemsize, examples, F,
                               H, dh) == fa.ab_tile_smem(kind, dtype,
                                                         examples, F, H, dh)


@pytest.mark.parametrize('dtype,out_dtype', FA_TYPES, ids=FA_TYPE_IDS)
@pytest.mark.parametrize('B,F,H,dh', [(8192, 22, 2, 8), (4093, 39, 3, 5)])
def test_field_attention_tile_kernels_are_deterministic(cuda, B, F, H, dh,
                                                        dtype, out_dtype):
    """K5's tile design sums in a fixed order, without atomics: two runs
    give the same bits."""
    assert fa.fa_design(dtype, out_dtype, B, F, H, dh) == 'tile'
    q, k, v, do, _, _, _ = _fa_inputs(B, F, H, dh, dtype, out_dtype, 6)
    assert torch.equal(fa.fa_fwd(q, k, v, H, out_dtype),
                       fa.fa_fwd(q, k, v, H, out_dtype))
    for a, b in zip(fa.fa_bwd(q, k, v, do, H), fa.fa_bwd(q, k, v, do, H)):
        assert torch.equal(a, b)


@pytest.mark.parametrize('kind', ['fa_fwd', 'fa_bwd'])
@pytest.mark.parametrize('dtype,out_dtype', FA_TYPES, ids=FA_TYPE_IDS)
@pytest.mark.parametrize('F,H,dh', [(22, 2, 8), (7, 3, 5), (39, 1, 16),
                                    (22, 2, 64), (3, 4, 16)])
def test_field_attention_tile_plan_matches_the_kernel(cuda, kind, dtype,
                                                      out_dtype, F, H, dh):
    """The wrapper's shared-memory sum is the kernel's layout."""
    lib = fa._library()
    examples = fa.fa_tile_examples(kind, dtype, out_dtype, F, H, dh)

    def size(t):
        return torch.empty((), dtype=t).element_size()
    assert lib.dt_fa_tile_smem(int(kind == 'fa_bwd'), size(dtype),
                               size(out_dtype), examples, F, H, dh) == \
        fa.fa_tile_smem(kind, dtype, out_dtype, examples, F, H, dh)


def test_field_attention_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, do, x, w, dx = _fa_inputs(8, 5, 2, 8, torch.float32,
                                       torch.float32, 0)
    with pytest.raises(TypeError):
        fa.fa_fwd(q.half(), k.half(), v.half(), 2)
    with pytest.raises(TypeError):
        fa.fa_fwd(q, k, v, 2, torch.bfloat16)  # f32 in, bf16 out
    with pytest.raises(TypeError):
        fa.fa_fwd(q, k.bfloat16(), v, 2)
    with pytest.raises(ValueError):
        fa.fa_fwd(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, 2)
    with pytest.raises(ValueError):
        fa.fa_fwd(q, k, v.cpu(), 2)
    with pytest.raises(TypeError):
        fa.ab_fwd(x, w.bfloat16(), 2)
    with pytest.raises(TypeError):
        fa.ab_bwd(x, w, dx.bfloat16(), 2)


def test_field_attention_kernels_take_every_shape(cuda):
    """A head of 65 (two slices) and a block whose buffers are 1.9 MB a
    warp, past shared memory: both run and match their plain versions."""
    q, k, v, do, _, _, _ = _fa_inputs(2, 3, 1, 65, torch.float32,
                                      torch.float32, 1)
    _fa_close(fa.fa_fwd(q, k, v, 1), fa.fa_fwd_reference(q, k, v, 1))
    _, _, _, _, x, w, dx = _fa_inputs(2, 400, 1, 64, torch.float32,
                                      torch.float32, 2)
    keep = (fa.ab_mask_margin(x, w, 1) >= 1e-5).cpu()
    _fa_close(fa.ab_bwd(x, w, dx, 1), fa.ab_bwd_reference(x, w, dx, 1), keep)


@pytest.mark.parametrize('extra', [{}, {'layout': 'batch_major'},
                                   {'fuse_projections': True}],
                         ids=['batch_minor', 'batch_major', 'fused'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_multihead_attention_on_cuda_matches_cpu(cuda, extra, dtype):
    from deeptables_torch.ops.interactions import MultiheadAttention
    params = dict({'num_heads': 2}, **extra)
    cpu = MultiheadAttention(16, params,
                             generator=torch.Generator().manual_seed(0))
    card = MultiheadAttention(16, params).to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(37, 22, 16, generator=torch.Generator().manual_seed(1))
    xc = x.to(dtype).cuda().requires_grad_(True)
    names = ('ab_fwd', 'ab_bwd') if extra.get('fuse_projections') \
        else ('fa_fwd', 'fa_bwd')
    kernels = [getattr(fa, n) for n in names]
    before = [f.launches for f in kernels]
    out = card(xc, training=True)
    (out * out.cos()).sum().backward()
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [n + 1 for n in before]
    xh = x.to(dtype).requires_grad_(True)
    ref = cpu(xh, training=True)
    (ref * ref.cos()).sum().backward()
    rtol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), rtol=rtol,
                               atol=rtol * float(ref.detach().abs().max()))
    grads = {'x': (xc.grad, xh.grad)}
    host = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        grads[name] = (p.grad, host[name].grad)
    # a relu input within rounding of 0 may take the other side on the card
    # and move that example's gradient: 1e-2 of the largest gradient
    for name, (card_grad, host_grad) in grads.items():
        torch.testing.assert_close(
            card_grad.float().cpu(), host_grad.float(), rtol=rtol,
            atol=1e-2 * float(host_grad.abs().max()), msg=name)


def _autoint(cuda, extra=None):
    from deeptables_torch.models import (CategoricalColumn, DeepModel,
                                         ModelConfig)
    vocabs = [24, 7, 7, 400, 30, 9]
    cats = tuple(CategoricalColumn(f'C{i}', v, 16)
                 for i, v in enumerate(vocabs))
    config = ModelConfig(
        nets=['autoint_nets'], task='binary', embedding_dropout=0,
        metrics=['AUC'], autoint_params=dict(
            {'num_attention': 3, 'num_heads': 2, 'dropout_rate': 0,
             'use_residual': True}, **(extra or {})))
    gpu = DeepModel('binary', 2, config, cats, (), device=cuda)
    cpu = DeepModel('binary', 2, config, cats, (), device='cpu')
    cpu.build().load_state_dict(gpu.build().state_dict())
    rng = np.random.default_rng(0)
    n = 96
    X = {'cat': np.stack([rng.integers(0, v, n) for v in vocabs],
                         axis=1).astype(np.int32)}
    y = rng.integers(0, 2, n).astype(np.float32)
    return gpu, cpu, X, y


@pytest.mark.parametrize('extra', [None, {'fuse_projections': True}],
                         ids=['unfused', 'fused'])
def test_autoint_fit_on_cuda_matches_cpu(cuda, extra):
    gpu, cpu, X, y = _autoint(cuda, extra)
    fwd, bwd = (fa.ab_fwd, fa.ab_bwd) if extra else (fa.fa_fwd, fa.fa_bwd)
    before = fwd.launches
    proba = gpu.predict(X, batch_size=32)
    assert fwd.launches == before + 9  # three blocks, three batches
    np.testing.assert_allclose(proba, cpu.predict(X, batch_size=32),
                               atol=1e-5)
    val = ({k: v[:32] for k, v in X.items()}, y[:32])
    counts = fwd.launches, bwd.launches
    h_gpu = gpu.fit(X, y, batch_size=48, epochs=1, validation_data=val,
                    shuffle=False, verbose=0)
    assert bwd.launches == counts[1] + 6  # three blocks, two steps
    assert fwd.launches == counts[0] + 9  # ... and one validation batch
    h_cpu = cpu.fit(X, y, batch_size=48, epochs=1, validation_data=val,
                    shuffle=False, verbose=0)
    for key in ('loss', 'val_loss', 'val_auc'):
        np.testing.assert_allclose(h_gpu.history[key], h_cpu.history[key],
                                   rtol=1e-4, err_msg=key)


# ---------------------------------------------------------------- the zoo

ADULT_VOCABS = [9, 16, 7, 15, 6, 5, 2, 42]


def test_emb_grad_kernel_at_the_adult_ids(cuda):
    """Wide&Deep+DCN's table: 8 columns, 102 rows, B=8192: runs of up to
    4096 equal ids (the vocabulary-2 column) through the segment sum and
    the merge; the same bits as the sorted twin."""
    rng = np.random.default_rng(8)
    cat = np.stack([rng.integers(0, v, 8192) for v in ADULT_VOCABS], axis=1)
    offsets = np.concatenate([[0], np.cumsum(ADULT_VOCABS)[:-1]])
    ids = torch.from_numpy((cat + offsets).astype(np.int32).reshape(-1))
    g = torch.from_numpy(rng.normal(size=(len(ids), 16)).astype(np.float32))
    assert emb_grad_design(len(ids), 16, 102, pointer_alignment(g)) == \
        'segment_v4'
    _check_emb_grad(ids.to(cuda), g.to(cuda), sum(ADULT_VOCABS))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fm_kernels_at_the_fgcnn_width(cuda, dtype):
    """fgcnn_fm_nets: FM over the 104 fields of the FGCNN output."""
    gen = torch.Generator().manual_seed(104)
    x = torch.randn(8192, 104, 16, generator=gen).to(dtype).to(cuda)
    g = torch.randn(8192, 1, generator=gen).to(dtype).to(cuda)
    assert fm_design(dtype, 8192, 104, 16, pointer_alignment(x)) == 'vec16'
    out = fm(x)
    dx = fm_backward(x, g)
    torch.cuda.synchronize()
    _close(out, fm_reference(x.float()), x, RTOL[dtype])
    scale = float((g.float().abs().reshape(-1, 1, 1)
                   * x.float().abs().sum(dim=1, keepdim=True)).max())
    np.testing.assert_allclose(
        dx.float().cpu().numpy(),
        fm_backward_reference(x, g).float().cpu().numpy(),
        rtol=RTOL[dtype], atol=RTOL[dtype] * scale)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('G', [104, 64])
def test_cin_kernels_at_the_fgcnn_width(cuda, G, dtype):
    """fgcnn_cin_nets' CIN over the FGCNN output: F=104, G=104 then 64, L=128
    at B=8192 (pair widths 10816 and 6656); both types on the tensor
    cores."""
    B, F, L, D = 8192, 104, 128, 16
    x0, h, w, dz = _cin_inputs(B, F, G, L, D, dtype, G)
    design = 'wgmma' if dtype == torch.bfloat16 else 'wgmma_f32'
    assert fwd_design(dtype, F, G) == bwd_design(dtype, F, G, L) == design
    z = cin_fwd(x0, h, w)
    dx0, dh, dw = cin_bwd(x0, h, w, dz)
    torch.cuda.synchronize()
    _cin_close(z, cin_fwd_reference(x0, h, w),
               cin_fwd_reference(x0.abs(), h.abs(), w.abs()))
    del z
    expected = cin_bwd_reference(x0, h, w, dz)
    scale = cin_bwd_reference(x0.abs(), h.abs(), w.abs(), dz.abs())
    rtol_out = 0. if dtype == torch.float32 else 1e-2
    _cin_close(dx0, expected[0], scale[0].float(), rtol_out)
    _cin_close(dh, expected[1], scale[1].float(), rtol_out)
    _cin_close(dw, expected[2], scale[2])


@pytest.mark.parametrize('nets', [['linear', 'dnn_nets', 'dcn_nets'],
                                  ['fgcnn_cin_nets'], ['fgcnn_fm_nets'],
                                  ['pnn_nets'], ['fibi_dnn_nets'],
                                  ['afm_nets']], ids=lambda n: '+'.join(n))
def test_zoo_nets_on_cuda_match_cpu(cuda, nets):
    """A step's gradients and the inference probabilities of a zoo net on
    the card and on the CPU from the same weights, float32 (rtol 1e-4 with
    1e-4 of each tensor's largest gradient and 1e-6 of the model's)."""
    from deeptables_torch.models import (CategoricalColumn, ContinuousColumn,
                                         DeepModel, ModelConfig)
    from deeptables_torch.ops import losses
    cats = tuple(CategoricalColumn(f'C{i}', v, 16)
                 for i, v in enumerate(ADULT_VOCABS))
    conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
    config = ModelConfig(nets=nets, task='binary', embedding_dropout=0,
                         cin_params={'cross_layer_size': (16, 8)},
                         dnn_params={'hidden_units': ((64, 0, False),
                                                      (32, 0, False))})
    rng = np.random.default_rng(1)
    X = {'cat': np.stack([rng.integers(0, v, 64) for v in ADULT_VOCABS],
                         axis=1).astype(np.int32),
         'input_continuous_all': rng.normal(size=(64, 3)).astype(np.float32)}
    y = torch.from_numpy(rng.integers(0, 2, 64).astype(np.float32))
    models = [DeepModel('binary', 2, config, cats, conts, device=d)
              for d in (cuda, 'cpu')]
    models[1].build().load_state_dict(models[0].build().state_dict())
    grads = []
    for model in models:
        logits, _ = model.module(model.to_device(X), training=True)
        losses.binary_crossentropy(logits, y.to(model.device)).backward()
        grads.append({k: p.grad.cpu() for k, p in
                      model.module.named_parameters() if p.grad is not None})
    assert set(grads[0]) == set(grads[1])
    # plus 1e-6 of the model's largest gradient: the dense BatchNorm's
    # gradient is zero in exact arithmetic where only the next BatchNorm
    # reads the dense inputs (the product nets), rounding on both devices
    floor = 1e-6 * max(float(g.abs().max()) for g in grads[1].values())
    for k, ref in grads[1].items():
        np.testing.assert_allclose(grads[0][k].numpy(), ref.numpy(),
                                   rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()) + floor,
                                   err_msg=k)
    np.testing.assert_allclose(models[0].predict(X), models[1].predict(X),
                               atol=1e-5)


def _zoo_model(cuda, nets, seed=0):
    """A zoo net on the adult vocabularies, D=16, three dense inputs, and
    4096 rows of ids, inputs and labels from ``seed``."""
    from deeptables_torch.models import (CategoricalColumn, ContinuousColumn,
                                         DeepModel, ModelConfig)
    cats = tuple(CategoricalColumn(f'C{i}', v, 16)
                 for i, v in enumerate(ADULT_VOCABS))
    conts = (ContinuousColumn('input_continuous_all', ['I1', 'I2', 'I3']),)
    config = ModelConfig(nets=nets, task='binary', embedding_dropout=0,
                         metrics=['AUC'], dtype_policy='bfloat16',
                         dnn_params={'hidden_units': ((64, 0, False),
                                                      (32, 0, False))})
    rng = np.random.default_rng(seed)
    n = 4096
    X = {'cat': np.stack([rng.integers(0, v, n) for v in ADULT_VOCABS],
                         axis=1).astype(np.int32),
         'input_continuous_all': rng.normal(size=(n, 3)).astype(np.float32)}
    y = rng.integers(0, 2, n).astype(np.float32)
    return DeepModel('binary', 2, config, cats, conts, device=cuda), X, y


ZOO_PAIR_NETS = ['ipnn_nets', 'afm_nets', 'fibi_nets', 'fgcnn_ipnn_nets']


@pytest.mark.parametrize('net', ZOO_PAIR_NETS)
def test_pair_and_fgcnn_nets_fit_deterministically(cuda, net):
    """Two 2-step fits of a net over field pairs (the pair gather's
    backward) or of FGCNN (its convolution's backward) from one seed end
    with the same parameters bit for bit."""
    states = []
    for _ in range(2):
        model, X, y = _zoo_model(cuda, [net])
        model.fit(X, y, batch_size=1024, epochs=1, steps_per_epoch=2,
                  validation_data=(X, y), verbose=0)
        states.append({k: v.detach().cpu().clone()
                       for k, v in model.module.state_dict().items()})
    differ = [k for k, v in states[0].items()
              if not torch.equal(v, states[1][k])]
    assert not differ, differ


ZOO_ALL = ['afm_nets', 'opnn_nets', 'ipnn_nets', 'pnn_nets', 'cross_nets',
           'cross_dnn_nets', 'fg_nets', 'fgcnn_cin_nets', 'fgcnn_fm_nets',
           'fgcnn_afm_nets', 'fgcnn_ipnn_nets', 'fgcnn_dnn_nets', 'fibi_nets',
           'fibi_dnn_nets', 'dcn_nets', 'autoint_nets', 'cin_nets', 'fm_nets']


@pytest.mark.parametrize('net', ZOO_ALL)
def test_zoo_step_has_deterministic_cuda_ops(cuda, net, monkeypatch):
    """One training step of each net under
    ``torch.use_deterministic_algorithms(True)``: PyTorch raises on an op
    whose CUDA backward has no deterministic implementation. (The setting
    is process-wide, so it is set here, in a test, and restored; cuBLAS's
    workspace setting keeps its GEMMs from raising.)"""
    monkeypatch.setenv('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    model, X, y = _zoo_model(cuda, [net])
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        model.fit(X, y, batch_size=1024, epochs=1, steps_per_epoch=1,
                  validation_data=(X, y), verbose=0)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(before)


def _stream_shards(tmp_path, buckets, n_dense, rows=(1500, 1300)):
    """Criteo-format TSV shards: a label, ``n_dense`` integers (10% blank),
    tokens of 8 hex digits."""
    rng = np.random.default_rng(5)
    paths = []
    for i, n in enumerate(rows):
        lines = []
        for _ in range(n):
            dense = ['' if rng.random() < 0.1 else str(rng.integers(0, 5000))
                     for _ in range(n_dense)]
            tokens = [format(int(v), '08x')
                      for v in rng.integers(0, 2 ** 32, len(buckets))]
            lines.append('\t'.join([str(rng.integers(0, 2))] + dense
                                   + tokens))
        path = tmp_path / f'day_{i}.tsv'
        path.write_text('\n'.join(lines) + '\n')
        paths.append(str(path))
    return paths


def test_native_ingest_builds_and_matches_its_twin(cuda, tmp_path):
    """The host parser builds with the card machine's compiler, and parses as
    its Python twin does."""
    from deeptables_torch.data import fast_ingest
    assert fast_ingest.have_native()
    buckets = [100_000, 8192, 97]
    path, = _stream_shards(tmp_path, buckets, 4, rows=(300,))
    data = open(path, 'rb').read()
    native = fast_ingest.parse_criteo_tsv(data, 4, 3, buckets)
    plain = fast_ingest._parse_criteo_py(data, 4, 3,
                                         np.asarray(buckets, np.int64))
    for a, b in zip(native, plain):
        np.testing.assert_array_equal(a, b)


def test_stream_fit_on_cuda_is_deterministic(cuda, tmp_path):
    """Two fits from one seed over a shuffled CriteoStreamLoader give the
    same parameters bit for bit: the loader draws its order on the
    iterating thread and K1 sums without atomics. Each step launches K1 and
    K2-bwd once."""
    from deeptables_torch.data import criteo, fast_ingest
    from deeptables_torch.models import DeepModel, ModelConfig
    from deeptables_torch.ops.kernels import emb_grad as emb_grad_module
    from deeptables_torch.ops.kernels import fm as fm_module
    buckets = [100_000, 8192, 8192, 97, 31]
    paths = _stream_shards(tmp_path, buckets, 4)
    cats, conts = criteo.criteo_columns(buckets, emb_dim=16, n_dense=4)
    config = ModelConfig(nets=['linear', 'fm_nets', 'dnn_nets'],
                         task='binary', embedding_dropout=0, metrics=['AUC'],
                         dtype_policy='bfloat16',
                         dnn_params={'hidden_units': ((64, 0, False),
                                                      (32, 0, False))})
    states = []
    for _ in range(2):
        source = fast_ingest.CriteoTsvSource(paths, n_dense=4, n_cat=5,
                                             hash_buckets=buckets,
                                             chunk_bytes=40_000)
        loader = criteo.CriteoStreamLoader(source, batch_size=256, seed=3)
        model = DeepModel('binary', 2, config, cats, conts, device=cuda)
        bwd = fm_module.fm_backward.launches
        grads = emb_grad_module.emb_grad.launches
        history = model.fit(loader, epochs=2, verbose=0)
        steps = fm_module.fm_backward.launches - bwd
        assert steps > 0 and emb_grad_module.emb_grad.launches - grads \
            == steps
        assert np.isfinite(history.history['loss']).all()
        states.append({k: v.detach().cpu().clone()
                       for k, v in model.module.state_dict().items()})
    for key, value in states[0].items():
        assert torch.equal(value, states[1][key]), key


def test_dae_transform_of_a_cuda_tensor_stays_on_the_card(cuda):
    """``DAE.transform`` of a CUDA tensor gives a CUDA tensor (no copy to
    the host), equal to the numpy path's features on the card."""
    from deeptables_torch.fe import DAE
    X = np.random.default_rng(0).normal(size=(300, 13)).astype(np.float32)
    dae = DAE(encoder_units=(64, 64), feature_units=5, noise_rate=0.1)
    dae.fit(X, batch_size=64, epochs=2, verbose=0, device=cuda)
    assert next(dae.module.parameters()).is_cuda
    out = dae.transform(torch.from_numpy(X).to(cuda), batch_size=64)
    assert out.is_cuda and out.shape == (300, 5)
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  dae.transform(X, batch_size=64))


def _shard_pieces(device, S=2, V=1001, D=16, n=4096, capacity=None):
    """One process's run of the pieces of a row-sharded lookup over S row
    blocks of one (V, D) table, with the exchange done by indexing: each
    block's dispatch of a stripe of the ids, its masked local gather and
    K1 over its rows at the local ids. Returns the blocks' rows and
    gradients and the plans."""
    from deeptables_torch.parallel import sharded_embedding as se
    rng = np.random.default_rng(S + V)
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, V, n).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(n, D)).astype(np.float32))
    R = se.rows_per_shard(V, S)
    stripe = -(-n // S)
    cap = se.a2a_capacity(stripe, S, capacity)
    out = {'plans': [], 'rows': [], 'grads': []}
    for m in range(S):
        shard = se.shard_rows(table, S, m).to(device).requires_grad_()
        mine = ids[m * stripe:(m + 1) * stripe].to(device)
        out['plans'].append([t.cpu() for t in se._dispatch_plan(
            mine, S, cap, R)])
        rows = se._local_gather(shard, ids.to(device), m)
        (rows * g.to(device)).sum().backward()
        out['rows'].append(rows.detach().cpu())
        out['grads'].append(shard.grad.cpu())
    return out, table, ids, g


@pytest.mark.parametrize('S,capacity', [(2, None), (2, 1.5), (4, None)])
def test_sharded_pieces_on_the_card_equal_the_cpu(cuda, S, capacity):
    """The dispatch plan and the masked local gather give the CPU's bits
    on the card; each block's gradient is K1 on its local ids (one launch a
    block), within the K1 tolerance of emb_grad_reference, and the blocks
    put back together are the whole table's gradient."""
    from deeptables_torch.parallel import sharded_embedding as se
    before = emb_grad.launches
    card, table, ids, g = _shard_pieces(cuda, S=S, capacity=capacity)
    torch.cuda.synchronize()
    assert emb_grad.launches == before + S
    cpu, _, _, _ = _shard_pieces(torch.device('cpu'), S=S, capacity=capacity)
    for a, b in zip(card['plans'], cpu['plans']):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for a, b in zip(card['rows'], cpu['rows']):
        assert torch.equal(a, b)
    whole = sum(card['rows'])  # every id owned by exactly one block
    assert torch.equal(whole, table[ids.long()])
    R = se.rows_per_shard(len(table), S)
    for m, grad in enumerate(card['grads']):
        rel = (ids.long() - m * R)
        owned = (rel >= 0) & (rel < R)
        local = rel.clamp(0, R - 1).to(torch.int32)
        g_local = torch.where(owned[:, None], g, torch.zeros(()))
        expected = emb_grad_reference(local, g_local, R)
        row_abs = emb_grad_reference(local, g_local.abs(), R)
        np.testing.assert_allclose(grad.numpy(), expected.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(row_abs.max()) + 1e-30)
        assert torch.equal(grad, emb_grad_sorted_reference(local, g_local,
                                                           R))
    full = se.unshard_rows(card['grads'], len(table))
    np.testing.assert_allclose(
        full.numpy(), emb_grad_reference(ids, g, len(table)).numpy(),
        rtol=1e-5, atol=1e-5)
