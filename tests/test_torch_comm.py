"""The JAX package's ``tests/unit/test_comm.py`` and ``test_csr.py`` on
the port: the named-axis verbs over ``torch.distributed``, the mesh and
its ``mpu`` facade, CSR row-sparse gradients and the engine's
``sparse_gradients`` exchange.

Where the JAX tests ran ``shard_map`` over a virtual 8-device mesh, the
port's run on 4 gloo processes (:func:`tests.torch_dist.run_ranks`; the
rank function is :func:`tests.torch_dp_workers.collectives`), spawned
once for the module.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.bert import (
    BertConfig, BertForPreTraining, BertForQuestionAnsweringTPU,
    BertForSequenceClassificationTPU)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.parallel import (DATA_AXIS, Mesh, MeshGrid,
                                          data_parallel_process_info,
                                          make_mesh)
from deepspeed_tpu_torch.runtime.csr_tensor import (CSRTensor,
                                                    csr_allreduce_reference)

from . import torch_dp_workers as W
from . import torch_pipe_workers as P
from .torch_dist import run_ranks
from .torch_simple_model import SimpleModel, base_config

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(W.collectives, WORLD,
                     tmp_path_factory.mktemp("collectives"))


# ------------------------------------------------------------- test_comm
def test_make_mesh_infers_data(ranks):
    """``-1`` takes the world: 4 gloo ranks, or one process without
    ``torch.distributed``, where the axes have no process group."""
    for rank, got in enumerate(ranks):
        assert got["inferred"] == WORLD
        assert got["process_info"] == (WORLD, rank)
    mesh = make_mesh({"data": -1})
    assert mesh.shape["data"] == 1 and mesh.group(DATA_AXIS) is None
    assert data_parallel_process_info(mesh) == (1, 0)


def test_psum_and_axis_index(ranks):
    total = sum(range(WORLD))
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got["psum"], [total])
        np.testing.assert_allclose(got["pmean"], [total / WORLD])
        np.testing.assert_allclose(got["pmax"], [WORLD - 1])
        np.testing.assert_allclose(got["pmin"], [0.0])
        assert got["axis_index"] == rank and got["axis_size"] == WORLD


def test_reduce_scatter_allgather_roundtrip(ranks):
    """Every rank holds the full vector: the reduce-scatter leaves each
    with the sum of its piece; the all-gather reassembles (concatenated,
    or stacked with ``tiled=False``)."""
    full = np.arange(16, dtype=np.float32)
    per = 16 // WORLD
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got["scattered"],
                                   WORLD * full[rank * per:(rank + 1) * per])
        np.testing.assert_allclose(got["roundtrip"], WORLD * full)
        np.testing.assert_allclose(got["stacked"],
                                   WORLD * full.reshape(WORLD, per))
        np.testing.assert_allclose(got["psum_inplace"], WORLD * full)


def test_ppermute_ring(tmp_path):
    """Point-to-point (the pipeline's, ROADMAP A13) runs: on a 2-rank
    gloo ring each member gets its neighbour's tensor, the shift back
    restores its own, and a member no pair sends to gets zeros, as
    ``jax.lax.ppermute``; the ring attention's rotation round the seq
    axis (ported, A10) gives each member its neighbour's tensor through
    an asynchronous ``send_recv``; all-to-all runs on the data axis
    (1-bit Adam's compressed all-reduce): over one member it returns its
    input, tiled or stacked as ``jax.lax.all_to_all``."""
    got = run_ranks(P.ppermute_ring, 2, tmp_path)
    for rank, r in enumerate(got):
        other = 1 - rank
        np.testing.assert_array_equal(r["fwd"], [10.0 * other,
                                                 10.0 * other + 1])
        np.testing.assert_array_equal(r["back"], [10.0 * rank,
                                                  10.0 * rank + 1])
    np.testing.assert_array_equal(got[1]["partial"], [0.0, 1.0])
    np.testing.assert_array_equal(got[0]["partial"], [0.0, 0.0])
    assert [r["sends"] for r in got] == [3, 2]
    for rank, r in enumerate(got):
        other = 1 - rank
        np.testing.assert_array_equal(r["seq_shift"], [10.0 * other,
                                                       10.0 * other + 1])
    x = torch.arange(8.0)
    one = Mesh({"data": 1})
    assert torch.equal(comm.all_to_all(x, DATA_AXIS, 0, 0, mesh=one), x)
    y = x.view(2, 4)
    # the split dim (of the axis size) goes, a dim of it comes at 1
    assert torch.equal(comm.all_to_all(y[None], DATA_AXIS, 0, 1,
                                       tiled=False, mesh=one), y[:, None])


def test_all_to_all_and_async_collectives(ranks):
    """On 4 ranks: rank r's chunk i goes to rank i, joined in rank order
    (``tiled`` along dim 0, and stacked on a new dim 0 from a split dim
    1); the asynchronous reduce-scatter and all-gather give the blocking
    ones' results after ``wait``."""
    for rank, got in enumerate(ranks):
        want = np.stack([100 * src + 2 * rank + np.arange(2)
                         for src in range(WORLD)]).astype(np.float32)
        np.testing.assert_array_equal(got["a2a"], want.reshape(-1))
        np.testing.assert_array_equal(got["a2a_stacked"], want[:, None])
        assert got["a2a_u8"].dtype == np.uint8
        np.testing.assert_array_equal(got["a2a_u8"], want.reshape(-1)
                                      .astype(np.uint8))
        np.testing.assert_array_equal(got["async_rs"], got["scattered"])
        np.testing.assert_array_equal(got["async_ag"], got["roundtrip"])


def test_mesh_grid_mpu_interface():
    mesh = Mesh({"pipe": 2, "data": 2, "model": 2})
    grid = MeshGrid(mesh)
    assert grid.get_data_parallel_world_size() == 2
    assert grid.get_model_parallel_world_size() == 2
    assert grid.get_pipe_parallel_world_size() == 2
    assert grid.get_data_parallel_group() == "data"
    assert grid.get_model_parallel_group() == "model"
    assert grid.world_size == 8
    assert grid.is_first_stage()
    # the model, expert and seq axes are ported (A10): their coordinates
    # and sizes; a model or seq axis of 2 needs two processes
    grid = MeshGrid(Mesh({"data": 2, "model": 2, "expert": 2}, rank=5))
    assert grid.get_expert_parallel_world_size() == 2
    assert grid.get_expert_parallel_group() == "expert"
    assert (grid.get_data_parallel_rank(), grid.get_model_parallel_rank(),
            grid.get_expert_parallel_rank()) == (1, 0, 1)
    with pytest.raises(ValueError, match="need 2 processes"):
        make_mesh({"model": 2, "data": 1})
    grid = MeshGrid(Mesh({"data": 2, "seq": 2, "model": 2}, rank=6))
    assert grid.seq_parallel_size == grid.get_seq_parallel_world_size() == 2
    assert grid.get_seq_parallel_group() == "seq"
    assert (grid.get_data_parallel_rank(), grid.get_seq_parallel_rank(),
            grid.get_model_parallel_rank()) == (1, 1, 0)
    with pytest.raises(ValueError, match="need 2 processes"):
        make_mesh({"seq": 2, "data": 1})
    # a seq axis trains a model that cuts its sequence (the port's
    # GPT-2 and BERT, any attention core); one without would run
    # replicated over seq, which is not ported: refused naming A22
    with pytest.raises(NotImplementedError, match="A22"):
        tds.initialize(model=SimpleModel(W.HIDDEN), config=base_config(),
                       mesh=Mesh({"seq": 2, "data": 2}), device="cpu")


class _Mpu:
    """A Megatron-style mpu of one data rank and two model ranks."""

    def __init__(self, model_rank):
        self.model_rank = model_rank

    def get_data_parallel_world_size(self):
        return 1

    def get_data_parallel_rank(self):
        return 0

    def get_data_parallel_group(self):
        return "dp-group"

    def get_model_parallel_world_size(self):
        return 2

    def get_model_parallel_rank(self):
        return self.model_rank

    def get_model_parallel_group(self):
        return "mp-group"


@pytest.mark.parametrize("model_rank", [0, 1])
def test_mesh_from_an_mpu_takes_its_model_axis(model_rank):
    """``Mesh.from_mpu`` of an mpu with two model ranks: the model axis
    of 2 with the mpu's group and this rank's coordinate (model
    innermost, as the reference's mpu lays ranks out)."""
    mesh = Mesh.from_mpu(_Mpu(model_rank))
    assert mesh.shape["model"] == 2 and mesh.shape["data"] == 1
    assert mesh.index("model") == model_rank
    assert mesh.group("model") == "mp-group"
    assert mesh.group("data") == "dp-group"
    # a tuple of axes names the group of its axes above one member
    assert mesh.group(("data", "model", "expert")) == "mp-group"


def test_an_mpu_with_data_parallel_ranks_is_accepted(ranks):
    """``initialize(mpu=...)`` with dp = 4, a ``MeshGrid`` or an mpu
    whose data-parallel group is a process group, trains as
    ``initialize(mesh=...)`` does."""
    for got in ranks:
        assert got["mesh_dp"] == got["grid_dp"] == got["mpu_dp"] == WORLD
        assert got["grid_losses"] == got["mesh_losses"]
        assert got["mpu_losses"] == got["mesh_losses"]


# -------------------------------------------------------------- test_csr
def test_roundtrip():
    d = W.csr_dense()
    csr = CSRTensor.from_dense(torch.from_numpy(d), max_rows=8)
    assert csr.nnz == 8
    np.testing.assert_allclose(csr.to_dense().numpy(), d, rtol=1e-6)
    assert csr.sparsity() == 1.0 - 8 / 64


def test_roundtrip_full_budget():
    d = W.csr_dense()
    csr = CSRTensor.from_dense(torch.from_numpy(d))
    np.testing.assert_allclose(csr.to_dense().numpy(), d, rtol=1e-6)


def test_duplicate_indices_add():
    csr = CSRTensor(indices=torch.tensor([5, 5], dtype=torch.int32),
                    values=torch.ones((2, 4)), dense_shape=(8, 4))
    np.testing.assert_allclose(csr.to_dense().numpy()[5], 2.0 * np.ones(4))


def test_csr_allreduce_matches_dense(ranks):
    """The all-gather exchange of (indices, values) equals the dense sum
    of the ranks' CSR tensors on every rank (the reference's
    csr_allreduce contract, ``engine.py:1203-1241``)."""
    host = [CSRTensor(indices=torch.from_numpy(got["csr_local"][0]),
                      values=torch.from_numpy(got["csr_local"][1]),
                      dense_shape=(64, 8)) for got in ranks]
    ref = csr_allreduce_reference(host)
    want = sum(W.csr_dense(touched=(r, 2 * r + 1, 50), seed=r)
               for r in range(WORLD))
    np.testing.assert_allclose(ref, want, rtol=1e-6)
    for got in ranks:
        np.testing.assert_allclose(got["csr_sum"], ref, rtol=1e-5)


def test_engine_sparse_gradients_wiring():
    engine, *_ = tds.initialize(model=SimpleModel(16, nlayers=2),
                                config=base_config(sparse_gradients=True),
                                device="cpu")
    assert engine.sparse_gradients_enabled()
    config2 = base_config(sparse_gradients=True,
                          zero_optimization={"stage": 2})
    with pytest.raises(ValueError, match=r"sparse_gradients: true requires "
                                         r"ZeRO stage 0"):
        tds.initialize(model=SimpleModel(16, nlayers=2), config=config2,
                       device="cpu")


def test_model_declares_sparse_paths():
    """Tied-head leaves are NOT row-sparse: the vocab projection's
    backward puts gradient on every row.  Only lookup-only embeddings
    qualify."""
    cfg = BertConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                     num_attention_heads=2, intermediate_size=32,
                     max_position_embeddings=16)
    assert "bert/embeddings/word" not in BertForPreTraining(
        cfg).sparse_gradient_paths()
    assert "bert/embeddings/word" in BertForQuestionAnsweringTPU(
        cfg).sparse_gradient_paths()
    assert "bert/embeddings/word" in BertForSequenceClassificationTPU(
        cfg).sparse_gradient_paths()
    gpt = GPT2LMHead(GPT2Config(vocab_size=64, hidden_size=16, num_layers=1,
                                num_heads=2, max_position_embeddings=16))
    assert "wte" not in gpt.sparse_gradient_paths()


def test_from_dense_overflow_detection():
    """A budget under the true support is detectable: the dropped-row
    count comes back beside the compressed tensor."""
    d = W.csr_dense(touched=(1, 5, 9, 13, 21))
    csr, dropped = CSRTensor.from_dense(torch.from_numpy(d), max_rows=3,
                                        return_dropped=True)
    assert int(dropped) == 2
    csr, dropped = CSRTensor.from_dense(torch.from_numpy(d), max_rows=8,
                                        return_dropped=True)
    assert int(dropped) == 0
    np.testing.assert_allclose(csr.to_dense().numpy(), d, rtol=1e-6)


def test_sparse_gradients_numerics_match_dense(ranks):
    """``sparse_gradients`` changes the exchange (the declared embedding
    rides csr_allreduce with a budget of the rank's tokens, 2 rows x 4
    tokens = 8, not the 64-row table) and not the numbers."""
    for got in ranks:
        assert got["dense_calls"] == []
        (losses_d, master_d), (losses_s, master_s) = (got["dense"],
                                                      got["sparse"])
        calls = got["sparse_calls"]
        assert calls and all(c == (8, (W.TinyEmbModel.VOCAB,
                                       W.TinyEmbModel.HID)) for c in calls)
        np.testing.assert_allclose(losses_s, losses_d, rtol=1e-5)
        np.testing.assert_allclose(master_s, master_d, rtol=1e-4,
                                   atol=1e-6)


def test_sparse_gradients_tied_head_fails_loud(ranks):
    """A declared-sparse leaf whose gradient overflows the token budget
    poisons the step with NaN on every rank instead of training on a
    truncated gradient."""
    assert all(got["tied_nan"] for got in ranks)


# ------------------------------------------------- utils/distributed.py
ENV_KEYS = ("DS_COORDINATOR", "DS_NUM_PROCESSES", "DS_PROCESS_ID", "RANK",
            "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "OMPI_COMM_WORLD_RANK",
            "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE", "LOCAL_RANK")


@pytest.mark.parametrize("env,want", [
    ({}, (None, None, None)),
    ({"DS_COORDINATOR": "host0:1234", "DS_NUM_PROCESSES": "4",
      "DS_PROCESS_ID": "2"}, ("tcp://host0:1234", 4, 2)),
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "29500", "RANK": "1",
      "WORLD_SIZE": "2"}, ("env://", 2, 1)),
    ({"MASTER_ADDR": "n0", "MASTER_PORT": "29500",
      "OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "8"},
     ("env://", 8, 3)),
    ({"DS_COORDINATOR": "h:1", "PMI_RANK": "5", "PMI_SIZE": "6"},
     ("tcp://h:1", 6, 5))],
    ids=["none", "launcher", "torchrun", "openmpi", "pmi"])
def test_init_distributed_reads_the_launchers_environment(monkeypatch, env,
                                                          want):
    """The JAX launcher's ``DS_*`` contract, torchrun's variables and
    MPI's rank and size (JAX ``utils/distributed.py:20-45``)."""
    from deepspeed_tpu_torch.utils import distributed as tdist

    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert tdist._resolve_env() == want


def test_init_distributed_without_a_world_is_a_no_op(monkeypatch):
    """One process needs no process group; a world of several without a
    rendezvous raises; the backend follows the device and nothing
    switches it on its own."""
    from deepspeed_tpu_torch.utils import distributed as tdist

    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert tdist.init_distributed(device="cpu") is False
    assert tdist.get_rank() == 0 and tdist.get_world_size() == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="rendezvous"):
        tdist.init_distributed(device="cpu")
    assert tdist.backend_for("cpu") == "gloo"
    assert tdist.backend_for(None) == tdist.backend_for("cuda:1") == "nccl"
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tdist.get_local_rank() == 3


@pytest.mark.parametrize("local_rank,device,want", [
    ("3", None, 3), ("3", "cuda", 3), ("1", "cuda:2", 2)],
    ids=["default", "cuda", "explicit-index"])
def test_init_distributed_makes_the_ranks_card_current(monkeypatch,
                                                       local_rank, device,
                                                       want):
    """Under NCCL the rank's card (``LOCAL_RANK``, unless the device
    names one) is the current device and the process group's own, so
    nothing that takes the current device lands on card 0; the CUDA
    calls and the group are stand-ins here."""
    from deepspeed_tpu_torch.utils import distributed as tdist
    from deepspeed_tpu_torch.utils.device import resolve_device

    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("LOCAL_RANK", local_rank)
    current, groups = [], []
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tdist.dist, "is_initialized", lambda: bool(groups))
    monkeypatch.setattr(tdist.dist, "init_process_group",
                        lambda **kw: groups.append(kw))
    assert tdist.init_distributed(init_method="file:///nowhere",
                                  world_size=4, rank=1, device=device)
    card = torch.device("cuda", want)
    assert current == [card]
    assert groups[0]["backend"] == "nccl"
    assert groups[0]["device_id"] == card
    if device is None:
        assert resolve_device(None, "test") == card
