"""The rank function of the port's comm-ledger test (jax-free: the
spawned gloo ranks import neither jax nor the JAX package): every case of
:data:`LEDGER_CASES` on one rank of :func:`tests.torch_dist.run_ranks`,
each a tiny GPT-2 engine with the comm ledger and telemetry on for two
steps, returning the ledger's entries and the flat layout's sizes."""

import os

import torch

from deepspeed_tpu_torch.parallel import DATA_AXIS, make_mesh

from .torch_dp_workers import (MICRO, dp_config, gpt2_batches,
                               port_engine, rank_slice)

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
