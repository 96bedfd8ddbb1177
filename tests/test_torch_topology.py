"""The JAX package's ``tests/unit/test_topology.py`` on the port's copy
of ``ProcessTopology`` (``deepspeed_tpu_torch/parallel/topology.py``)."""

import pytest

from deepspeed_tpu_torch.parallel import (PipeDataParallelTopology,
                                          PipeModelDataParallelTopology,
                                          ProcessTopology)


def test_topology_2d():
    topo = ProcessTopology(axes=["row", "col"], dims=[2, 2])
    assert topo.world_size() == 4
    assert topo.get_rank(row=0, col=0) == 0
    assert topo.get_rank(row=0, col=1) == 1
    assert topo.get_rank(row=1, col=0) == 2
    assert topo.get_rank(row=1, col=1) == 3
    assert topo.get_axis_list(axis="row", idx=0) == [0, 1]
    assert topo.get_axis_list(axis="row", idx=1) == [2, 3]
    assert topo.get_axis_list(axis="col", idx=0) == [0, 2]
    assert topo.get_axis_list(axis="col", idx=1) == [1, 3]


def test_topology_dims():
    topo = ProcessTopology(axes=["a", "b", "c"], dims=[2, 3, 4])
    assert topo.world_size() == 24
    assert topo.get_dim("a") == 2
    assert topo.get_dim("b") == 3
    assert topo.get_dim("c") == 4


def test_topology_match():
    topo = PipeModelDataParallelTopology(num_pp=2, num_mp=4, num_dp=2)
    ranks = topo.filter_match(pipe=0, data=1)
    assert ranks == [4, 5, 6, 7]
    ranks = topo.filter_match(pipe=0, model=1)
    assert ranks == [1, 5]


def test_topology_rank_repr():
    topo = ProcessTopology(axes=["pipe", "data"], dims=[2, 2])
    assert topo.get_rank_repr(rank=0) == ""
    assert topo.get_rank_repr(rank=0, omit_axes=["pipe"]) == "data_00"
    assert topo.get_rank_repr(rank=1, omit_axes=["pipe"]) == "data_01"

    topo = ProcessTopology(axes=["pipe", "data", "model"], dims=[2, 2, 2])
    assert topo.get_rank_repr(rank=0) == "model_00"
    assert topo.get_rank_repr(rank=1) == "model_01"
    assert topo.get_rank_repr(rank=0, omit_axes=["pipe"]) == "data_00-model_00"
    assert topo.get_rank_repr(rank=3, omit_axes=["pipe"]) == "data_01-model_01"


def test_topology_3d():
    topo = PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2)
    # axes order: pipe, data, model (model innermost)
    assert topo.get_rank(pipe=0, data=0, model=0) == 0
    assert topo.get_rank(pipe=0, data=0, model=1) == 1
    assert topo.get_rank(pipe=0, data=1, model=0) == 2
    assert topo.get_rank(pipe=1, data=0, model=0) == 4

    # model-parallel groups vary fastest
    assert topo.get_axis_comm_lists("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert topo.get_axis_comm_lists("data") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert topo.get_axis_comm_lists("pipe") == [[0, 4], [1, 5], [2, 6], [3, 7]]


def test_topology_comm_list():
    topo = PipeDataParallelTopology(num_pp=2, num_dp=2)
    assert topo.get_rank(pipe=0, data=0) == 0
    assert topo.get_rank(pipe=0, data=1) == 1
    assert topo.get_rank(pipe=1, data=0) == 2
    assert topo.get_rank(pipe=1, data=1) == 3

    pipe_list = [[0, 2], [1, 3]]
    assert topo.get_axis_comm_lists("pipe") == pipe_list
    data_list = [[0, 1], [2, 3]]
    assert topo.get_axis_comm_lists("data") == data_list
    assert topo.get_axis_comm_lists("bogus") == []

    for rank in range(4):
        assert rank in pipe_list[0] or rank in pipe_list[1]
        assert rank in data_list[0] or rank in data_list[1]


def test_get_rank_slices():
    topo = ProcessTopology(axes=["a", "b"], dims=[2, 2])
    with pytest.raises(ValueError):
        topo.get_rank(a=0)
