# -*- coding:utf-8 -*-
"""The port's checkpoints (``deeptables_torch.utils.checkpoint``, on
``torch.distributed.checkpoint``) and multi-process helpers, the twin of
``tests/test_checkpoint_multihost.py``'s replicated round trip,
``host_info`` and ``per_host_batch``. Beyond the twin: a ``DeepModel``
restored from a checkpoint after two steps takes a third that equals an
uninterrupted three-step fit bit for bit (parameters, BatchNorm statistics
and Adam's moments restored exactly), a stateful loss's state and another
optimizer's state come back, and a checkpoint taken by two ranks of a gloo
process group restores on both."""

import numpy as np
import pytest
import torch

import torch_ranks
from deeptables_torch.parallel import host_info, per_host_batch
from deeptables_torch.utils.checkpoint import (restore_checkpoint,
                                               restore_orbax,
                                               save_checkpoint, save_orbax)


class TestCheckpoint:
    def test_roundtrip_replicated(self, tmp_path):
        tree = {'params': {'w': torch.arange(12.0).reshape(3, 4),
                           'b': torch.ones(4)}}
        path = str(tmp_path / 'ckpt1')
        save_orbax(path, tree)
        restored = restore_orbax(path)
        np.testing.assert_array_equal(restored['params']['w'].numpy(),
                                      np.arange(12.0).reshape(3, 4))
        np.testing.assert_array_equal(restored['params']['b'].numpy(),
                                      np.ones(4))

    def test_roundtrip_into_a_template(self, tmp_path):
        tree = {'table': torch.randn(64, 4, generator=torch.Generator()
                                     .manual_seed(0)), 'step': torch.tensor(3)}
        path = save_checkpoint(tmp_path / 'ckpt2', tree)
        template = {'table': torch.zeros(64, 4),
                    'step': torch.tensor(0)}
        assert restore_checkpoint(path, template) is template
        assert torch.equal(template['table'], tree['table'])
        assert int(template['step']) == 3

    def test_existing_checkpoint_is_replaced_only_with_force(self, tmp_path):
        path = tmp_path / 'ckpt3'
        save_checkpoint(path, {'a': torch.ones(2)})
        with pytest.raises(FileExistsError):
            save_checkpoint(path, {'a': torch.zeros(2)}, force=False)
        save_checkpoint(path, {'a': torch.zeros(2)})
        assert torch.equal(restore_checkpoint(path)['a'], torch.zeros(2))


def _steps(model, X, y, lo, hi):
    rows = {k: v[lo:hi] for k, v in X.items()}
    model.fit(rows, y[lo:hi], batch_size=torch_ranks.BATCH, epochs=1,
              verbose=0, shuffle=False, validation_data=(rows, y[lo:hi]))


@pytest.mark.parametrize('case', ['batchnorm', 'ghmc'])
def test_resumed_step_equals_the_uninterrupted_fit(tmp_path, case):
    B = torch_ranks.BATCH
    X, y, _ = torch_ranks.case_data()
    whole = torch_ranks.case_model(case)
    _steps(whole, X, y, 0, 3 * B)
    first = torch_ranks.case_model(case)
    _steps(first, X, y, 0, 2 * B)
    path = save_checkpoint(tmp_path / 'deepfm', first)
    resumed = torch_ranks.case_model(case)
    restore_checkpoint(path, resumed)
    for k, v in first.module.state_dict().items():
        assert torch.equal(resumed.module.state_dict()[k], v), k
    if case == 'ghmc':
        assert torch.equal(resumed.loss_state, first.loss_state)
    _steps(resumed, X, y, 2 * B, 3 * B)
    for k, v in whole.module.state_dict().items():
        assert torch.equal(resumed.module.state_dict()[k], v), k
    for p, q in zip(whole.optimizer.param_groups[0]['params'],
                    resumed.optimizer.param_groups[0]['params']):
        for key in ('exp_avg', 'exp_avg_sq', 'step'):
            assert torch.equal(whole.optimizer.state[p][key],
                               resumed.optimizer.state[q][key]), key


def test_module_and_optimizer_roundtrip(tmp_path):
    """A module with another optimizer of the port (LAMB)."""
    from deeptables_torch.ops.optimizers import Lamb
    gen = torch.Generator().manual_seed(1)
    module = torch.nn.Sequential(torch.nn.Linear(5, 3), torch.nn.Linear(3, 1))
    opt = Lamb(module.parameters(), lr=1e-2)
    for _ in range(2):
        opt.zero_grad()
        module(torch.randn(8, 5, generator=gen)).square().mean().backward()
        opt.step()
    path = save_checkpoint(tmp_path / 'lamb', module, opt)
    fresh = torch.nn.Sequential(torch.nn.Linear(5, 3), torch.nn.Linear(3, 1))
    fresh_opt = Lamb(fresh.parameters(), lr=1e-2)
    restore_checkpoint(path, fresh, fresh_opt)
    for k, v in module.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    for p, q in zip(module.parameters(), fresh.parameters()):
        for key, value in opt.state[p].items():
            got = fresh_opt.state[q][key]
            assert torch.equal(got, value) if torch.is_tensor(value) \
                else got == value, key


def test_two_ranks_save_and_restore(tmp_path):
    ranks = torch_ranks.run_ranks('checkpoint', tmp_path, 2,
                                  tmp_path / 'ckpt')
    assert all(r['restored_equal'] for r in ranks)
    for key, value in ranks[0]['after'].items():
        np.testing.assert_array_equal(ranks[1]['after'][key], value,
                                      err_msg=key)


class TestMultihost:
    def test_host_info_single(self):
        info = host_info()
        assert info['host_id'] == 0
        assert info['num_hosts'] == 1

    def test_per_host_batch(self):
        assert per_host_batch(1024) == 1024  # single host
        assert per_host_batch(1023) == 1023
