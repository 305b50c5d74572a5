"""The port's rank mesh and data-parallel placement (`voicesplit_tpu_torch/
parallel/`) against the JAX package's `parallel/mesh.py` and `sharding.py`
behaviour, in one process (the multi-process runs are
`tests/test_torch_distributed.py`).
"""

import numpy as np
import pytest
import torch

from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.models.masknet import MaskNet
from voicesplit_tpu_torch.parallel import (
    batch_sharding,
    initialize_distributed,
    local_batch_size,
    make_mesh,
    param_partition_spec,
    put_batch,
    shard_train_state,
)
from voicesplit_tpu_torch.parallel.mesh import group_active, sum_over_ranks_, world_size
from voicesplit_tpu_torch.train import create_train_state, make_optimizer


def test_mesh_shapes_as_jax():
    """`tests/test_parallel.py::test_mesh_shapes` over 8 ranks."""
    ranks = range(8)
    assert make_mesh(ranks=ranks).shape == {"data": 8, "model": 1}
    mesh = make_mesh(model=2, ranks=ranks)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.ranks == tuple(ranks)
    with pytest.raises(ValueError, match=r"mesh 3x2 != 8 ranks"):
        make_mesh(data=3, model=2, ranks=ranks)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        make_mesh(model=3, ranks=ranks)


def test_mesh_of_one_process():
    assert not group_active() and world_size() == 1
    assert make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_mesh(model=2)


@pytest.mark.parametrize("global_batch,want", [(8, 8), (3, 3)])
def test_local_batch_size_of_one_process(global_batch, want):
    assert local_batch_size(global_batch, make_mesh()) == want


def test_initialize_distributed_is_a_no_op_for_one_process():
    assert initialize_distributed() is False
    assert initialize_distributed(None, 1, 0, device="cpu") is False
    assert not group_active()
    with pytest.raises(ValueError, match="coordinator_address and process_id"):
        initialize_distributed(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match=r"process_id 2 not in \[0, 2\)"):
        initialize_distributed("localhost:1", 2, 2, device="cpu")


def test_sum_over_ranks_without_a_group_leaves_the_buffer():
    buf = torch.arange(6, dtype=torch.float32)
    assert sum_over_ranks_(buf) == 1
    assert torch.equal(buf, torch.arange(6, dtype=torch.float32))


def _small_model():
    return MaskNet(num_freq=33, emb_dim=16, lstm_dim=16, fc1_dim=24, fc2_dim=33, conv_channels=8)


def test_param_partition_spec_replicates_and_refuses_the_gate_split():
    """Data parallelism replicates every parameter; the gate split's table
    splits the gates, conv output channels and fc1's inputs (the full check
    against the JAX package's rules is in `tests/test_torch_model_parallel.py`)."""
    model = _small_model()
    specs = param_partition_spec(model, model_parallel=False)
    assert set(specs) == {k for k, _ in model.named_parameters()}
    assert set(specs.values()) == {"replicated"}
    split = param_partition_spec(model, model_parallel=True)
    assert set(split) == set(specs)
    assert {k: split[k] for k in ("lstm.fwd_w_ih", "lstm.bwd_w_hh", "lstm.fwd_b", "fc1.weight",
                                  "conv1.conv.weight", "conv8.conv.bias", "conv3.bn.scale",
                                  "fc1.bias", "fc2.weight", "fc2.bias")} == {
        "lstm.fwd_w_ih": 1, "lstm.bwd_w_hh": 1, "lstm.fwd_b": 0, "fc1.weight": 1,
        "conv1.conv.weight": 0, "conv8.conv.bias": 0, "conv3.bn.scale": 0,
        "fc1.bias": "replicated", "fc2.weight": "replicated", "fc2.bias": "replicated"}


def test_put_batch_in_one_process_is_the_identity():
    rng = np.random.default_rng(0)
    batch = {"mixed_wav": rng.standard_normal((2, 64)).astype(np.float32),
             "wav_len": np.array([64, 60], np.int32)}
    mesh = make_mesh()
    assert batch_sharding(mesh, batch) == {"mixed_wav": "rows", "wav_len": "rows"}
    placed = put_batch(mesh, batch)
    assert set(placed) == set(batch)
    for k, v in batch.items():
        assert placed[k].device.type == "cpu"
        np.testing.assert_array_equal(placed[k].numpy(), v)


def test_shard_train_state_in_one_process_keeps_the_state():
    model = _small_model()
    state = create_train_state(model, make_optimizer(Config(), model))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert shard_train_state(state, make_mesh()) is state
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    # the gate split over ranks this process has no group for
    with pytest.raises(ValueError, match="process group"):
        shard_train_state(state, make_mesh(model=2, ranks=[0, 1]))
