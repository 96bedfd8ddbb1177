"""The rank functions of the port's ZeRO-Offload tests above one rank.

One world of 4 gloo ranks (:func:`tests.torch_dist.run_ranks`) serves
the whole module: first two ``{data: 2}`` groups side by side (ranks 0
and 1, ranks 2 and 3, each a mesh of its own), then the world as
``{data: 2, model: 2}``, ``{pipe: 2, data: 2}`` and ``{data: 2, seq:
2}``.  This module imports neither jax nor the JAX package; the inputs
are the other worker modules' seeded helpers, so the parent test makes
the same ones and holds the results against the JAX eager-offload
engine or against the port's own runs.
"""

import torch.distributed as dist

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.op_common import LANES
from deepspeed_tpu_torch.parallel import DATA_AXIS, Mesh, make_mesh
from deepspeed_tpu_torch.runtime import engine as engine_module
from deepspeed_tpu_torch.runtime.zero import coordinator

from . import torch_dp_workers as DP
from . import torch_pipe_workers as PIPE
from . import torch_seq_workers as SEQ
from . import torch_tp_workers as TP

WORLD = 4
STEPS = 10
CKPT_STEPS = 3
OFFLOAD = {"stage": 2, "cpu_offload": True}
# rows of a streamed chunk: the tiny models' shards take several, the
# last one ragged (a chunk of whole MB would be the whole shard)
CHUNK_ROWS = 16
# a checkpoint's gather of host rows: 16 fp32 rows of each of 2 ranks a
# chunk, so the tiny models' shards take several
GATHER_BYTES = 2 * CHUNK_ROWS * LANES * 4
BF16_EF = {"momentum": "bf16", "variance": "bf16", "master": "bf16",
           "error_feedback": True}
# (name, optimizer) of the {data: 2} trajectories against the JAX engine
DATA2_OPTIMIZERS = (("adam", "Adam"), ("lamb", "Lamb"),
                    ("cpu_adam", "CPUAdam"))


def offload(**extra):
    return {"zero_optimization": dict(OFFLOAD, **extra)}


def pair_mesh(rank):
    """``{data: 2}`` over this rank's pair (ranks 0, 1 or ranks 2, 3):
    every rank makes both groups, in one order."""
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    return Mesh({DATA_AXIS: 2}, groups={DATA_AXIS: groups[rank // 2]},
                rank=rank % 2)


def unpadded(eng):
    """The gathered unpadded master and moments, and the step (a
    collective)."""
    eng._sync_host()
    opt = eng.opt_state
    return {"master": eng._gather_unpadded(eng.master),
            "exp_avg": eng._gather_unpadded(opt.exp_avg),
            "exp_avg_sq": eng._gather_unpadded(opt.exp_avg_sq),
            "step": int(opt.step)}


def host_shapes(eng):
    """Every host buffer's shape, with the layout's rows."""
    shapes = {"master": tuple(eng.master.shape),
              "exp_avg": tuple(eng.opt_state.exp_avg.shape),
              "exp_avg_sq": tuple(eng.opt_state.exp_avg_sq.shape)}
    shapes.update((f"res/{k}", tuple(v.shape)) for k, v in eng._qres.items())
    if eng._host_grad is not None:
        shapes["grad"] = tuple(eng._host_grad.shape)
    return {"shapes": shapes, "shard_rows": eng.flat.shard_rows,
            "rows": eng.segments.rows, "lanes": LANES,
            "chunks": len(eng.host_stream.jobs)}


def simple_run(mesh, opt, zero, steps=STEPS, world=2, rank=0, **extra):
    eng = DP.port_engine("simple", DP.dp_config(2, opt, 1, 1.0, world,
                                                zero_optimization=zero,
                                                **extra), mesh)
    batches = DP.global_batches("simple", steps, world)
    it = iter([DP.rank_slice(b, rank, world) for b in batches])
    return eng, [float(eng.train_batch(it)) for _ in range(steps)]


def gpt2_run(mesh, opt, zero, rank, steps=STEPS, dp=2, same_rows=False,
             clip=1.0):
    """The tiny GPT-2 of the data-parallel tests at ``dp`` ranks: each
    its rows of the global batches, or (``same_rows``) every rank the
    whole of each."""
    cfg = DP.dp_config(2, opt, 1, clip, dp, zero_optimization=zero)
    rows = DP.MICRO * 2
    if same_rows:
        cfg.update(train_batch_size=rows * dp,
                   train_micro_batch_size_per_gpu=rows)
    eng = DP.port_engine("gpt2", cfg, mesh)
    batches = DP.gpt2_batches(steps, rows)
    mine = (batches if same_rows else
            [DP.rank_slice(b, rank % dp, dp) for b in batches])
    it = iter(mine)
    return eng, [float(eng.train_batch(it)) for _ in range(steps)]


def data2_pair0(rank, mesh):
    """The first pair: SimpleModel's trajectories under Adam, Lamb and
    CPUAdam; GPT-2 under offload against the run without it (Adam and
    Lamb) and ``offload_gradients`` against offload alone, bitwise; the
    host buffers' shapes."""
    out = {}
    for name, opt in DATA2_OPTIMIZERS:
        eng, losses = simple_run(mesh, opt, OFFLOAD, rank=rank)
        out[f"simple_{name}"] = {"losses": losses, **unpadded(eng)}
    # the host kernel without offload: on the CPU engine's master rows
    eng, losses = simple_run(mesh, "CPUAdam", {"stage": 2}, rank=rank)
    out["simple_cpu_adam_none"] = {"losses": losses, **unpadded(eng)}
    for opt in ("Adam", "Lamb"):
        for zero in ({"stage": 2}, OFFLOAD):
            eng, losses = gpt2_run(mesh, opt, zero, rank)
            kind = "offload" if zero.get("cpu_offload") else "none"
            key = f"gpt2_{opt.lower()}_{kind}"
            out[key] = {"losses": losses, **unpadded(eng)}
            if zero.get("cpu_offload"):
                out[key]["host"] = host_shapes(eng)
    # one gather of the host master: a collective a chunk of rows
    comm.counter.reset()
    eng._gather_unpadded(eng.master)
    out["gather_calls"] = {"calls": comm.counter.calls.get("all_gather"),
                           "bytes": comm.counter.bytes.get("all_gather"),
                           "shard_rows": eng.flat.shard_rows}
    eng, losses = gpt2_run(mesh, "Adam",
                           dict(OFFLOAD, offload_gradients=True), rank)
    out["gpt2_offload_gradients"] = {"losses": losses, **unpadded(eng),
                                     "host": host_shapes(eng)}
    # ZeRO-3: the compute params gathered from the host rows before each
    # forward, freed after the backward
    eng, losses = gpt2_run(mesh, "Adam", dict(OFFLOAD, stage=3), rank)
    out["gpt2_zero3_offload"] = {"losses": losses, **unpadded(eng),
                                 "freed": eng._compute.untyped_storage()
                                 .nbytes() == 0}
    return out


def data2_pair1(rank, mesh, save_dir, jax_dir):
    """The second pair: error feedback at dp 2 against dp 1 (both ranks
    on the same rows, no clip: the two degrees' gradients are then the
    same bits), fp16's skips, and checkpoints across degrees and from
    the JAX engine."""
    out = {}
    one = Mesh({DATA_AXIS: 1})
    ef = OFFLOAD | {"offload_state_dtype": BF16_EF}
    for dp, m in ((2, mesh), (1, one)):
        eng, losses = gpt2_run(m, "Adam", ef, rank, dp=dp, same_rows=True,
                               clip=0.0)
        eng._sync_host()
        out[f"ef_dp{dp}"] = {
            "losses": losses, **unpadded(eng),
            "res": {k: eng._gather_unpadded(v)
                    for k, v in eng._qres.items()}}
        if dp == 2:
            out["ef_dp2"]["host"] = host_shapes(eng)

    eng = DP.port_engine("simple", DP.dp_config(
        2, "Adam", 1, 0.0, 2, zero_optimization=OFFLOAD,
        fp16=dict(DP.FP16)), mesh)
    losses, scales, skipped = [], [], []
    for batch in DP.fp16_batches(2):
        losses.append(float(eng.train_batch(
            iter([DP.rank_slice(batch, rank % 2, 2)]))))
        scales.append(float(eng.loss_scale))
        skipped.append(int(eng.skipped_steps))
    out["fp16"] = {"losses": losses, "scales": scales, "skipped": skipped}

    # dp 2 -> dp 1: the pair's rank 0 writes, each rank loads alone
    d2 = f"{save_dir}/dp2"
    eng, _ = gpt2_run(mesh, "Adam", OFFLOAD, rank, steps=CKPT_STEPS)
    eng.save_checkpoint(d2, sync=True)
    eng.wait_checkpoint(d2)
    out["ckpt_dp2"] = unpadded(eng)
    eng = DP.port_engine("gpt2", DP.dp_config(2, "Adam", 1, 1.0, 1,
                                              zero_optimization=OFFLOAD),
                         one)
    eng.load_checkpoint(d2, strict=True)
    out["ckpt_dp2_at_dp1"] = unpadded(eng)
    # dp 1 -> dp 2: each rank writes its own directory, the pair loads
    # its rank 0's
    d1 = f"{save_dir}/dp1-rank{rank}"
    eng, _ = gpt2_run(one, "Adam", OFFLOAD, 0, steps=CKPT_STEPS, dp=1)
    eng.save_checkpoint(d1, sync=True)
    out["ckpt_dp1"] = unpadded(eng)
    eng = DP.port_engine("gpt2", DP.dp_config(2, "Adam", 1, 1.0, 2,
                                              zero_optimization=OFFLOAD),
                         mesh)
    eng.load_checkpoint(f"{save_dir}/dp1-rank{rank - rank % 2}",
                        strict=True)
    out["ckpt_dp1_at_dp2"] = unpadded(eng)
    # the packages: the JAX engine's dp 2 checkpoint in, the port's out
    eng = DP.port_engine("simple", DP.dp_config(2, "Adam", 1, 1.0, 2,
                                                zero_optimization=OFFLOAD),
                         mesh)
    eng.load_checkpoint(jax_dir, strict=True)
    out["from_jax"] = unpadded(eng)
    eng, _ = simple_run(mesh, "Adam", OFFLOAD, steps=CKPT_STEPS,
                        rank=rank % 2)
    eng.save_checkpoint(f"{save_dir}/for_jax", sync=True)
    eng.wait_checkpoint(f"{save_dir}/for_jax")
    out["for_jax"] = unpadded(eng)
    return out


def offload_world(rank, world, seed, save_dir, jax_dir, lin_weights):
    """Every case on one world of 4 ranks; see the module docstring."""
    engine_module.chunk_rows_for = lambda mb: CHUNK_ROWS
    coordinator.HOST_GATHER_BYTES = GATHER_BYTES
    mesh = pair_mesh(rank)
    out = (data2_pair0(rank, mesh) if rank < 2 else
           data2_pair1(rank, mesh, save_dir, jax_dir))
    dist.barrier()

    d2m2 = make_mesh({"data": 2, "model": 2})
    model, params = TP.gpt2()
    eng = TP.engine(model, params, TP.config(TP.ADAM, dp=2, **offload()),
                    d2m2)
    out["d2m2"] = {"losses": TP.train(eng, TP.gpt2_batches(STEPS), STEPS),
                   "master": TP.whole_master(eng),
                   "host": host_shapes(eng)}
    # Lamb's per-tensor norms over the data rows and the model slices
    for kind, zero in (("none", {"stage": 2}), ("offload", OFFLOAD)):
        model, params = TP.gpt2()
        eng = TP.engine(model, params, TP.config(
            TP.LAMB, dp=2, zero_optimization=zero), d2m2)
        out[f"d2m2_lamb_{kind}"] = {
            "losses": TP.train(eng, TP.gpt2_batches(STEPS), STEPS),
            **unpadded(eng)}

    p2d2 = make_mesh({"pipe": 2, "data": 2})
    eng = PIPE.engine(PIPE.linear_specs(), lin_weights,
                      PIPE.config(2, **offload()), p2d2)
    out["p2d2"] = {"losses": PIPE.train(eng, PIPE.linear_data(), STEPS),
                   "master": eng._gather_unpadded(eng.master),
                   "host": host_shapes(eng)}

    d2s2 = make_mesh({"data": 2, "seq": 2})
    model, params = SEQ.gpt2()
    eng = SEQ.engine(model, params, SEQ.config(SEQ.ADAM, dp=2, **offload()),
                     d2s2)
    out["d2s2"] = {"losses": SEQ.train(eng, SEQ.gpt2_batches(STEPS), STEPS),
                   "master": SEQ.whole_master(eng),
                   "host": host_shapes(eng)}
    return out
