"""The rank functions of the port's bucketed-exchange, ZeRO-3 and 1-bit
Adam tests (jax-free: the spawned gloo ranks import neither jax nor the
JAX package).  Each runs on one rank of :func:`tests.torch_dist.run_ranks`
and returns numpy arrays and plain values; the inputs come from numpy
seeds through the helpers of :mod:`tests.torch_dp_workers`, which the
parent tests use too.
"""

import os

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm import compression
from deepspeed_tpu_torch.parallel import DATA_AXIS, make_mesh

from .torch_dp_workers import (MICRO, STEPS, dp_config, gpt2_batches,
                               port_engine, rank_slice, state)

# several buckets a block and two to three buckets a group
SMALL_BUCKETS = {"reduce_bucket_size": 20000, "allgather_bucket_size": 40000}
# one bucket and one group per transformer block of the tiny GPT-2 (a
# block is 49,984 elements) and one for ln_f, wpe and wte: the groups
# follow the forward, so peak residency is measurable
BLOCK_BUCKETS = {"reduce_bucket_size": 50000, "allgather_bucket_size": 50000}

# (ZeRO stage, overlap_comm, accumulation, clipping), the tiny GPT-2
# with Adam, against the JAX engine at dp=2
JAX_CASES = [(2, True, 1, 1.0), (2, True, 2, 0.0), (3, False, 1, 1.0),
             (3, True, 1, 0.0), (3, True, 2, 1.0)]
# the port's fused exchange, the bitwise control of the bucketed one
FUSED_CASES = [(2, False, 1, 0.0), (2, False, 2, 0.0), (2, False, 1, 1.0)]
# ZeRO-3 with overlap under activation checkpointing: the recompute in
# the backward reads the params again
REMAT_CASE = (3, True, 1, 0.0)
REMAT = {"remat": True}


def zero_config(stage, overlap, acc, clip, world, buckets=SMALL_BUCKETS,
                **extra):
    cfg = dp_config(stage, "Adam", acc, clip, world, **extra)
    cfg["zero_optimization"] = dict(stage=stage, overlap_comm=overlap,
                                    **buckets)
    return cfg


def gpt2_global(n, world, seed=1):
    return gpt2_batches(n, MICRO * world, seed=seed)


def train(engine, rank, world, steps, acc=1, seed=1):
    it = iter([rank_slice(b, rank, world)
               for b in gpt2_global(steps * acc, world, seed)])
    return [float(engine.train_batch(it)) for _ in range(steps)]


def overlap_trajectories(rank, world, seed):
    """Every case of :data:`JAX_CASES` and :data:`FUSED_CASES`, and
    :data:`REMAT_CASE` under remat: ``STEPS`` steps on this rank's
    slices; then the collectives and the gathers of one step under the
    block-aligned buckets (ZeRO-3 with and without remat)."""
    mesh = make_mesh({DATA_AXIS: world})
    out = {}
    for case in JAX_CASES + FUSED_CASES:
        stage, overlap, acc, clip = case
        engine = port_engine("gpt2", zero_config(*case, world), mesh)
        assert engine.comm_overlap_enabled() == overlap
        out[case] = {"losses": train(engine, rank, world, STEPS, acc),
                     **state(engine)}
    engine = port_engine("gpt2", zero_config(*REMAT_CASE, world), mesh,
                         model_kw=REMAT)
    out[("remat", REMAT_CASE)] = {
        "losses": train(engine, rank, world, STEPS), **state(engine)}
    for stage, model_kw in ((2, None), (3, None), (3, REMAT)):
        engine = port_engine("gpt2", zero_config(
            stage, True, 1, 1.0, world, BLOCK_BUCKETS), mesh,
            model_kw=model_kw)
        plan = engine.flat.plan
        z3 = engine._z3
        train(engine, rank, world, 1)
        comm.counter.reset()
        if z3 is not None:
            z3.gathers.clear()
            z3.peak_bytes = z3.live_bytes
        train(engine, rank, world, 1, seed=2)
        out[("counts", stage) if model_kw is None
            else ("counts", stage, "remat")] = {
            "calls": dict(comm.counter.calls),
            "bytes": dict(comm.counter.bytes),
            "n_buckets": plan.n_buckets, "n_groups": len(plan.ag_groups),
            "schedule": engine.collective_schedule(),
            "rows": plan.rows,
            "gathers": dict(z3.gathers) if z3 else None,
            "peak": z3.peak_bytes if z3 else None,
            "group_bytes": ([z3.group_bytes(g)
                             for g in range(len(plan.ag_groups))]
                            if z3 else None)}
    return out


def overlap_checkpoints(rank, world, seed, jax_dir, out_dir):
    """A ZeRO-3 bucketed engine's checkpoint after 3 steps (its state),
    loaded into ZeRO-2 fused and bucketed and ZeRO-3 without overlap at
    dp=2 (their states); the JAX engine's bucketed ZeRO-2 checkpoint in
    ``jax_dir`` loaded into the port's ZeRO-3 bucketed engine (its
    state, and its next loss)."""
    mesh = make_mesh({DATA_AXIS: world})
    out = {}
    engine = port_engine("gpt2", zero_config(3, True, 1, 0.0, world), mesh)
    train(engine, rank, world, 3)
    engine.save_checkpoint(os.path.join(out_dir, "z3"), sync=True)
    engine.wait_checkpoint()
    out["saved"] = state(engine)
    for stage, overlap in ((2, False), (2, True), (3, False)):
        other = port_engine("gpt2", zero_config(stage, overlap, 1, 0.0,
                                                world), mesh)
        other.load_checkpoint(os.path.join(out_dir, "z3"), strict=True)
        out[(stage, overlap)] = state(other)
    other = port_engine("gpt2", zero_config(3, True, 1, 0.0, world), mesh)
    other.load_checkpoint(jax_dir, strict=True)
    out["from_jax"] = state(other)
    out["from_jax_loss"] = train(other, rank, world, 1, seed=3)
    return out


# ------------------------------------------------------------ 1-bit Adam
ONEBIT_FREEZE = 3
ONEBIT_STEPS = 8


def allreduce_inputs(world, n, seed=0):
    """Per-rank buffers and error buffers for ``compressed_allreduce`` of
    ``n`` elements (the error buffers at the padded size)."""
    rng = np.random.default_rng(seed)
    n_pad = compression.padded_size(n, world)
    bufs = rng.normal(size=(world, n)).astype(np.float32)
    werrs = (rng.normal(size=(world, n_pad)) * 0.1).astype(np.float32)
    serrs = (rng.normal(size=(world, n_pad // world)) * 0.1).astype(
        np.float32)
    return bufs, werrs, serrs


ALLREDUCE_SIZES = (1024, 100, 1000)


def onebit_config(world, freeze=ONEBIT_FREEZE, **extra):
    cfg = dp_config(0, "OneBitAdam", 1, 0.0, world, **extra)
    cfg["optimizer"]["params"] = {"lr": 1e-3, "freeze_step": freeze}
    return cfg


def onebit_state(engine):
    out = state(engine)
    opt = engine.opt_state
    out["worker_error"] = opt.worker_error.numpy().copy()
    out["server_error"] = opt.server_error.numpy().copy()
    return out


def onebit_runs(rank, world, seed, jax_dir, out_dir):
    """``compressed_allreduce`` of :data:`ALLREDUCE_SIZES` on this rank's
    rows; a OneBitAdam trajectory through ``freeze_step`` with the
    collectives of each step; a checkpoint in the compressed phase and 3
    more steps; the JAX engine's compressed-phase checkpoint in
    ``jax_dir`` resumed for 3 steps."""
    mesh = make_mesh({DATA_AXIS: world})
    out = {}
    for n in ALLREDUCE_SIZES:
        bufs, werrs, serrs = allreduce_inputs(world, n)
        res = compression.compressed_allreduce(
            torch.from_numpy(bufs[rank]), torch.from_numpy(werrs[rank]),
            torch.from_numpy(serrs[rank]), DATA_AXIS, mesh=mesh)
        out[("allreduce", n)] = tuple(t.numpy() for t in res)
    engine = port_engine("gpt2", onebit_config(world), mesh)
    it = iter([rank_slice(b, rank, world)
               for b in gpt2_global(ONEBIT_STEPS, world)])
    losses, calls = [], []
    for step in range(ONEBIT_STEPS):
        comm.counter.reset()
        losses.append(float(engine.train_batch(it)))
        calls.append((dict(comm.counter.calls), dict(comm.counter.bytes)))
        if step == ONEBIT_STEPS - 4:
            engine.save_checkpoint(os.path.join(out_dir, "onebit"),
                                   sync=True)
            engine.wait_checkpoint()
    out["losses"], out["calls"] = losses, calls
    out["state"] = onebit_state(engine)
    out["n_flat"] = engine.master.numel()
    engine = port_engine("gpt2", onebit_config(world), mesh)
    engine.load_checkpoint(jax_dir, strict=True)
    out["from_jax"] = onebit_state(engine)
    it = iter([rank_slice(b, rank, world)
               for b in gpt2_global(3, world, seed=4)])
    out["from_jax_losses"] = [float(engine.train_batch(it))]
    out["from_jax_1"] = onebit_state(engine)
    out["from_jax_losses"] += [float(engine.train_batch(it))
                               for _ in range(2)]
    return out
