"""The rank functions of the port's profiling tests (jax-free: the
spawned gloo ranks import neither jax nor the JAX package), each run on
the ranks of one :func:`tests.torch_dist.run_ranks` call:

- :func:`comm_ledger_runs`: every case of :data:`LEDGER_CASES`, each a
  tiny GPT-2 engine with the comm ledger and telemetry on for two steps,
  returning the ledger's entries and the flat layout's sizes;
- :func:`overlap_runs`: ZeRO-2 at dp=2 with the bucketed exchange and its
  fused control (:data:`OVERLAP_CASES`), the comm ledger on and off,
  under :data:`SHARED_SPECS`: the entries, the receipts, the losses;
- :func:`pipe_profiling_runs`: a tanh stack at ``{pipe: 2}`` with the
  memory and comm ledgers and the flops profiler on and off."""

import os

import torch

from deepspeed_tpu_torch.parallel import DATA_AXIS, PIPE_AXIS, make_mesh

from . import torch_pipe_workers as P
from .torch_dp_workers import (MICRO, dp_config, gpt2_batches,
                               port_engine, rank_slice)
from .torch_zero_workers import train, zero_config

# (label, ZeRO stage, overlap_comm, accumulation, cpu_offload)
LEDGER_CASES = [("zero2_fused", 2, False, 1, False),
                ("zero2_bucketed", 2, True, 1, False),
                ("zero1_acc2", 1, False, 2, False),
                ("zero2_offload", 2, False, 1, True)]


def ledger_config(stage, overlap, acc, offload, world, run_dir):
    cfg = dp_config(stage, "Adam", acc, 1.0, world, steps_per_print=1,
                    telemetry={"enabled": True, "run_dir": run_dir},
                    profiling={"comm_ledger": True})
    cfg["zero_optimization"] = {"stage": stage, "overlap_comm": overlap,
                                "cpu_offload": offload}
    return cfg


def comm_ledger_runs(rank, world, seed, root):
    mesh = make_mesh({DATA_AXIS: world})
    out = {}
    for label, stage, overlap, acc, offload in LEDGER_CASES:
        run_dir = os.path.join(root, label)
        engine = port_engine("gpt2", ledger_config(stage, overlap, acc,
                                                   offload, world, run_dir),
                             mesh)
        it = iter([rank_slice(b, rank, world)
                   for b in gpt2_batches(2 * acc, MICRO * world, seed=seed)])
        for _ in range(2):
            engine.train_batch(it)
        flat = engine.flat
        out[label] = {
            "entries": engine.comm_ledger.entries(),
            "step": engine.comm_ledger.step_entry(acc),
            "flat_elements": int(torch.Size(flat.flat_shape).numel()),
            "shard_elements": int(torch.Size(flat.shard_shape).numel()),
            "compute_bytes": engine.compute_dtype.itemsize,
            "host_state_bytes": engine.host_state_bytes_per_step(),
            "run_dir": run_dir}
        engine.close()
    return out


# (label, overlap_comm): the bucketed exchange and its fused control, at
# the small buckets of the overlap tests (8 reduce-scatters, 4 gathers)
OVERLAP_CASES = [("bucketed", True), ("fused", False)]
# one spec table for both packages' overlap models: a link fast enough
# that every bucket's wire is far below the compute around it (the JAX
# table's name for the link rate, ``ici_gbps``, too)
SHARED_SPECS = {"peak_tflops": 989.0, "hbm_gbps": 3350.0,
                "link_gbps": 1e9, "ici_gbps": 1e9, "host_gbps": 64.0}


def shared_chip_specs(device_kind=""):
    return dict(SHARED_SPECS, device_kind=device_kind or "")


def overlap_runs(rank, world, seed, root):
    from deepspeed_tpu_torch.profiling import overlap

    overlap.chip_specs = shared_chip_specs
    mesh = make_mesh({DATA_AXIS: world})
    out = {}
    for label, on in OVERLAP_CASES:
        for ledger in (True, False):
            cfg = zero_config(2, on, 1, 0.0, world,
                              profiling={"comm_ledger": ledger})
            engine = port_engine("gpt2", cfg, mesh)
            losses = train(engine, rank, world, 2)
            if not ledger:
                out[label]["plain_losses"] = losses
                continue
            out[label] = {
                "losses": losses,
                "entries": engine.comm_ledger.entries(),
                "receipt": engine.overlap_receipt(),
                "comm_receipt": engine.comm_receipt(),
                "schedule": engine.declared_collective_schedule()}
    return out


PIPE_PROFILE_CONFIG = {
    "flops_profiler": {"enabled": True, "profile_step": 1},
    "profiling": {"comm_ledger": True, "memory_ledger": True},
    "steps_per_print": 1}


def pipe_profiling_runs(rank, world, seed, root):
    mesh = make_mesh({PIPE_AXIS: world})
    data = P.linear_data()
    out = {}
    for label, extra in (("profiled", dict(
            PIPE_PROFILE_CONFIG,
            telemetry={"enabled": True,
                       "run_dir": os.path.join(root, "pipe")})),
            ("plain", {})):
        engine = P.engine(P.linear_specs(), None, P.config(**extra), mesh)
        losses = P.train(engine, data, 3)
        prof = (engine.flops_profiler.profile
                if engine.flops_profiler is not None else None)
        out[label] = {
            "losses": losses,
            "entries": engine.comm_ledger.entries(),
            "memory": engine.memory_ledger.entries(),
            "fb_flops": prof.by_phase["forward_backward"] if prof else None,
            "matmul_flops": prof.matmul_flops if prof else None,
            "step_flops": prof.by_phase["step"] if prof else None,
            "overlap_receipt": engine.overlap_receipt(),
            "comm_receipt": engine.comm_receipt(),
            "attribution": engine.attribution_receipt(),
            "stage": engine.stage_id}
        engine.close()
    return out
