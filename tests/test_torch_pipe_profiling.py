"""The ledgers and the flops profiler under the port's ``PipelineEngine``
(ROADMAP A23), at ``{pipe: 2}`` on a gloo pair, a stack of eight tanh
Linear layers (``tests/torch_pipe_workers.py``), four micro-batches:

- the comm ledger records the first batch's schedule as ``fwd_bwd`` and
  the step as ``apply_update``; ``fwd_bwd``'s point-to-point bytes are
  ``2·M`` boundaries with the neighbour (stage 0 sends M activations and
  receives M gradients; stage 1 the other way round) plus the metadata
  tensor ahead of the batch's first activation, and every transfer is a
  ``p2p_transfer`` node of its overlap summary (blocking: serialized);
  the receipts count ``fwd_bwd`` once a step;
- the memory ledger records each stage's forward, backward and apply;
- the flops profiler counts the ``profile_step``-th batch: the two
  stages' forward-backward FLOPs sum to the ``DeepSpeedEngine``'s count
  for the same model (``tests/torch_simple_model.py``'s eight-layer
  stack) and micro-batches, its matmul FLOPs exactly;
- losses with the ledgers and the profiler on are bitwise those
  without.
"""

import math

import numpy as np
import pytest

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.runtime.pipe import engine as pipe_engine

from . import torch_pipe_workers as P
from .torch_dist import run_ranks
from .torch_profiling_workers import pipe_profiling_runs
from .torch_simple_model import SimpleModel

WORLD = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe_profiling")
    return run_ranks(pipe_profiling_runs, WORLD, root / "ranks", str(root))


def test_losses_are_bitwise_with_the_plane_on(runs):
    for r in runs:
        assert r["profiled"]["losses"] == r["plain"]["losses"]
        assert r["plain"]["fb_flops"] is None


def test_p2p_bytes_are_two_m_boundaries_with_the_neighbour(runs):
    boundary = P.MB_SIZE * P.HIDDEN * 4
    meta = pipe_engine._META_LEN * 8
    M = P.MICRO_BATCHES
    for r in runs:
        entries = r["profiled"]["entries"]
        assert set(entries) == {"fwd_bwd", "apply_update"}
        fb = entries["fwd_bwd"]
        assert fb["p2p_transfer_bytes"] == 2 * M * boundary + meta
        assert fb["p2p_transfers"] == 2 * M + 1
        s = fb["overlap"]
        assert s["p2p_transfers"]["total"] == 2 * M + 1
        assert s["p2p_transfers"]["serialized"] == 2 * M + 1
        assert s["exposed_by_kind"]["p2p_transfer"] > 0
        assert s["compute_seconds"] > 0
        # the step's stats all-reduce over pipe is apply_update's
        assert entries["apply_update"]["ops"]["all-reduce"]["max_group"] \
            == WORLD
        assert r["profiled"]["comm_receipt"]["wire_bytes"] == \
            fb["wire_bytes"] + entries["apply_update"]["wire_bytes"]
        ov = r["profiled"]["overlap_receipt"]
        assert math.isclose(ov["wire_seconds"], s["wire_seconds"]
                            + entries["apply_update"]["overlap"]
                            ["wire_seconds"], rel_tol=1e-12)
        att = r["profiled"]["attribution"]
        assert att["program"] == "stepwise"
        assert math.isclose(sum(att["phases"].values()),
                            att["measured_step_seconds"], rel_tol=1e-12)


def test_memory_ledger_records_each_stage(runs):
    for r in runs:
        assert set(r["profiled"]["memory"]) == {"forward", "backward",
                                                "apply_update"}


def deepspeed_engine_flops():
    """The ``DeepSpeedEngine``'s profile of the same stack and batch."""
    model = SimpleModel(P.HIDDEN, nlayers=8)
    cfg = P.config(flops_profiler={"enabled": True, "profile_step": 1})
    engine, *_ = tds.initialize(model=model, model_parameters=model.init(0),
                                config=cfg, device="cpu")
    engine.train_batch(iter(P.linear_data()))
    prof = engine.flops_profiler.profile
    return prof.by_phase["forward_backward"], prof.matmul_flops


def test_profile_step_counts_the_deepspeed_engines_flops(runs):
    fb, matmul = deepspeed_engine_flops()
    got = [r["profiled"] for r in runs]
    assert sorted(r["stage"] for r in got) == [0, 1]
    assert sum(r["fb_flops"] for r in got) == fb
    assert sum(r["matmul_flops"] for r in got) == matmul
    assert all(r["step_flops"] > 0 for r in got)
    assert np.all(np.isfinite([r["losses"] for r in got]))
