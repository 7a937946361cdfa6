# -*- coding:utf-8 -*-
"""The port's data-parallel training (``deeptables_torch.parallel``), the
twin of ``tests/test_parallel.py``'s mesh fits: the JAX tests shard a batch
over an 8-device virtual mesh in one process; the port runs one process a
device, so these tests start two ranks of a gloo process group
(``tests/torch_ranks.py``: subprocesses with a time limit, a ``file://``
store). A 2-rank ``DataParallel`` fit of DeepFM equals a 1-process fit on
the same global batches, within float32 rounding: the ranks sum their
halves of BatchNorm's statistics, of the loss and of the gradients in
another order than one process does. Tolerance, after six Adam steps at
lr 1e-3: every parameter and BatchNorm statistic rtol 1e-4, atol 1e-5; the
epochs' losses and validation metrics rtol 1e-4, atol 1e-6.
The four cases: BatchNorm (every case has it), sample weights (the loss
divides by the global Σw; a seventh of them 0), the GHMC loss (its
histogram counts the global batch), dropout on (embedding, dense input and
DNN: the masks of the global batch, each rank its rows).
A strategy whose mesh the process group cannot hold raises.
"""

import pickle

import numpy as np
import pytest
import torch

import torch_ranks
from deeptables_torch.parallel import (DATA_AXIS, MODEL_AXIS,
                                       DataAndModelParallel, DataParallel,
                                       DistributionStrategy, build_mesh,
                                       get_strategy, host_info,
                                       initialize_distributed)


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    return torch_ranks.run_ranks('fits', tmp_path_factory.mktemp('ranks'))


@pytest.mark.parametrize('case', list(torch_ranks.CASES))
def test_two_rank_fit_equals_one_process_fit(two_ranks, case):
    state, history = torch_ranks.case_fit(case)
    dp_state, dp_history = two_ranks[0][case]
    other_state, other_history = two_ranks[1][case]
    assert set(dp_state) == set(state)
    for key, value in state.items():
        np.testing.assert_allclose(dp_state[key], value, rtol=1e-4,
                                   atol=1e-5, err_msg=key)
        # the ranks hold the same parameters and running statistics
        np.testing.assert_array_equal(other_state[key], dp_state[key],
                                      err_msg=key)
    assert set(dp_history) == set(history)
    for key, values in history.items():
        np.testing.assert_allclose(dp_history[key], values, rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert other_history == dp_history


def test_two_ranks_host_info(two_ranks):
    for rank, result in enumerate(two_ranks):
        assert result['host_info'] == {'host_id': rank, 'num_hosts': 2,
                                       'local_device_count': 1,
                                       'global_device_count': 2}
        assert result['per_host_batch'] == 512
        assert result['per_host_batch_refused']


def test_single_process_strategies():
    assert type(get_strategy(None)) is DistributionStrategy
    assert get_strategy(None).num_data_shards == 1
    assert get_strategy(None).shard is None
    for name in ('data', 'data_parallel', 'mirrored'):
        assert isinstance(get_strategy(name), DataParallel)
    with pytest.raises(ValueError, match='Unknown distribute_strategy'):
        get_strategy('pipeline')
    mesh = build_mesh()
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1} and mesh.rank == 0
    one = DataParallel(num_devices=1)
    assert one.num_data_shards == 1 and one.shard is None and one.is_chief
    assert DataAndModelParallel(data_parallel=1).num_data_shards == 1


def test_model_axis_raises_naming_item_13b():
    """A model axis is ported (it no longer raises): the strategy keeps
    its axis and threshold, and its mesh needs data × model processes;
    ``tests/test_torch_sharded_embedding.py`` builds the 2×2, 1×4 and 1×2
    meshes on the ranks of a process group and trains on them."""
    strategy = DataAndModelParallel(data_parallel=4, model_parallel=2,
                                    shard_threshold=100)
    assert strategy.model_parallel == 2 and strategy.shard_threshold == 100
    with pytest.raises(ValueError, match='needs 8 processes'):
        strategy.validate('sharded_a2a')
    with pytest.raises(ValueError, match='needs 2 processes'):
        build_mesh(1, 2)
    clone = pickle.loads(pickle.dumps(strategy))
    assert clone.model_parallel == 2 and clone._mesh is None


def test_unknown_embedding_strategy_raises():
    with pytest.raises(ValueError, match='embedding_device_strategy'):
        DataParallel(num_devices=1).validate('striped')
    # sharded tables over a model axis of 1 are the replicated table
    DataParallel(num_devices=1).validate('sharded')
    DataAndModelParallel(data_parallel=1).validate('sharded_a2a')


def test_more_devices_than_processes_raises_in_fit():
    model = torch_ranks.case_model('batchnorm', DataParallel(num_devices=2))
    X, y, _ = torch_ranks.case_data()
    with pytest.raises(ValueError, match='process group has 1'):
        model.fit(X, y, batch_size=128, epochs=1, verbose=0)


def test_data_parallel_of_one_process_equals_the_plain_fit():
    """DataParallel(num_devices=1) runs the plain step: the same bits."""
    plain, _ = torch_ranks.case_fit('dropout')
    one, _ = torch_ranks.case_fit('dropout', DataParallel(num_devices=1))
    for key, value in plain.items():
        np.testing.assert_array_equal(one[key], value, err_msg=key)


def test_strategy_pickles_without_its_group():
    strategy = DataParallel(num_devices=1, group=object())
    assert strategy.mesh.shape[DATA_AXIS] == 1
    clone = pickle.loads(pickle.dumps(strategy))
    assert clone._mesh is None and clone._group is None
    assert clone.num_devices == 1 and clone.num_data_shards == 1


def test_initialize_distributed_is_a_no_op_alone(monkeypatch):
    for name in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() == host_info() == {
        'host_id': 0, 'num_hosts': 1, 'local_device_count': 1,
        'global_device_count': 1}
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(ValueError, match='where the processes meet'):
        initialize_distributed()
