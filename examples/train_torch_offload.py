#!/usr/bin/env python3
"""GPT-2 under ZeRO-Offload on the PyTorch/CUDA port, one process a rank,
the host state sharded over the data ranks.

    torchrun --nproc-per-node 1 examples/train_torch_offload.py
    torchrun --nproc-per-node 4 examples/train_torch_offload.py --data 4
    torchrun --nproc-per-node 4 examples/train_torch_offload.py --data 4 --optimizer cpu_adam
    torchrun --nproc-per-node 4 examples/train_torch_offload.py --pipe 2 --data 2
    torchrun --nproc-per-node 4 examples/train_torch_offload.py --xl --data 4
    torchrun --nproc-per-node 2 examples/train_torch_offload.py --data 2 --cpu

Each process joins the ``torch.distributed`` world that torchrun
describes (NCCL with one card a rank, or gloo with ``--cpu``) and builds
the mesh ``{pipe, data}``.  The model is bench.py's offload leg (chip
smoke phase 27): GPT-2-large (36 layers, hidden 1280, seq 1024) in
bf16 at dropout 0 with remat and ``loss_chunk`` 256, Adam lr 1e-4,
ZeRO-2 with ``cpu_offload`` (fp32 host state, 512 MB chunks), on a
global batch of ``--batch`` rows from ``--batch-seed``, the same every
step, each data rank taking its rows.  ``--optimizer cpu_adam`` updates
the host state in the host kernel instead; ``--xl`` is GPT-2-xl at its
48 layers with ``offload_gradients`` (phase 28's leg at full depth);
``--pipe`` > 1 runs ``examples/train_torch_pipe.py``'s
``PipelineModule`` on ``--micro-batches`` micro-batches; ``--cpu``
makes the model tiny and fp32.  The weights are ``random_params(config,
--seed)``, drawn whole on every rank.

``--threads`` sets the host kernel's OpenMP team: ``split`` (the
default: the host's CPUs over the ranks that share it,
``ops/adam/cpu_adam.py``'s ``host_threads``), ``inherit`` (OpenMP's own
choice: torchrun's ``OMP_NUM_THREADS=1`` above one local rank) or
``all`` (every CPU in each rank: what a rank inherits where nothing
sets ``OMP_NUM_THREADS``, as under the port's launcher).

``--no-mesh`` builds the engine without a mesh at one rank (the master
whole, not a partition of one).  ``--save-peak`` ends the run with a
checkpoint's gather (``capture_engine_snapshot``: all of a save that
touches the card; the serialization is host work) and records its
seconds and the card's peak memory during it beside the steps' peak.

Rank 0 prints one JSON line: the mesh, the losses (``--steps`` untimed
steps, then ``--timed`` steps, each between two synchronizations), step
ms, and for every rank its host kernel ms a step, the host stream's
copy times a step (``host_stream.timing_report()``), its pinned host
bytes and ``MemAvailable`` before its engine.  With ``--reference
PATH`` (a JSON-lines file this script wrote at one rank) the first
``--steps`` losses are held to the one-rank run's of the same model and
optimizer at ``--rtol``, and the script exits 1 above it.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import deepspeed_tpu_torch as tds  # noqa: E402
from deepspeed_tpu_torch.checkpoint import (  # noqa: E402
    capture_engine_snapshot)
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,  # noqa: E402
                                             GPT2LMHead, random_params)
from deepspeed_tpu_torch.ops.adam import cpu_adam  # noqa: E402
from deepspeed_tpu_torch.parallel import make_mesh  # noqa: E402
from deepspeed_tpu_torch.utils.distributed import (  # noqa: E402
    get_rank, get_world_size, init_distributed)
import train_torch_pipe as pipe_example  # noqa: E402

# bench.py's offload legs (chip_smoke.BENCH_OFFLOAD_MODEL, OFFLOAD)
MODEL = dict(embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0,
             remat=True, loss_chunk=256)
CHUNK_MB = 512
TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)


def model_config(args):
    if args.cpu:
        return GPT2Config(**TINY)
    make = GPT2Config.gpt2_xl if args.xl else GPT2Config.gpt2_large
    return make(max_position_embeddings=args.seq, **MODEL)


def ds_config(args, micro, acc):
    opt = {"type": "CPUAdam" if args.optimizer == "cpu_adam" else "Adam",
           "params": {"lr": 1e-4}}
    zero = {"stage": 2, "cpu_offload": True, "offload_chunk_mb": CHUNK_MB,
            "offload_gradients": args.xl}
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": acc, "steps_per_print": 10 ** 9,
           "optimizer": opt, "zero_optimization": zero}
    if not args.cpu:
        cfg["bf16"] = {"enabled": True}
    return cfg


def build(args, cfg, mesh, device):
    """The engine and this rank's micro-batches of the global batch."""
    dp_rank = mesh.index("data")
    batches = pipe_example.token_batches(
        cfg.vocab_size, args.batch, cfg.max_position_embeddings,
        args.micro_batches if args.pipe > 1 else 1, args.batch_seed)
    params = random_params(cfg, args.seed)
    if args.pipe > 1:
        model = pipe_example.gpt2_pipeline_module(
            cfg, activation_checkpoint_interval=int(cfg.remat))
        params = pipe_example.pipe_params_from_gpt2(params)
        micro = args.batch // args.micro_batches // args.data
        config = ds_config(args, micro, args.micro_batches)
        batches = pipe_example.rank_rows(batches, dp_rank, args.data)
    else:
        model = GPT2LMHead(cfg)
        config = ds_config(args, args.batch // args.data, 1)
        batches = [{"input_ids": ids} for ids, _ in
                   pipe_example.rank_rows(batches, dp_rank, args.data)]
    engine, *_ = tds.initialize(model=model, model_parameters=params,
                                config=config,
                                mesh=None if args.no_mesh else mesh,
                                device=device)
    return engine, batches


def mem_available():
    """``MemAvailable`` of ``/proc/meminfo``, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return None


def host_buffers(engine):
    out = [engine.master, engine.opt_state.exp_avg,
           engine.opt_state.exp_avg_sq, *engine._qres.values()]
    return out + ([engine._host_grad] if engine._host_grad is not None
                  else [])


def save_peak(engine, cuda):
    """A checkpoint's gather after the steps (a collective): its
    seconds, the card's memory in use before it and its peak during
    it."""
    def sync():
        if cuda:
            torch.cuda.synchronize(engine.device)

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(engine.device)
    before = torch.cuda.memory_allocated(engine.device) if cuda else None
    t0 = time.perf_counter()
    snapshot = capture_engine_snapshot(engine, "peak")
    sync()
    seconds = time.perf_counter() - t0
    del snapshot
    return {"seconds": seconds, "allocated_before_bytes": before,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(
                engine.device) if cuda else None)}


def reference_losses(path, args, n):
    """The first ``n`` losses of the one-rank run of this model and
    optimizer in the JSON-lines file ``path`` (None where it has none):
    a pipeline is held to the one-rank run without one."""
    if not path or not os.path.exists(path):
        return None
    ref = None
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if (r.get("world") == 1 and r.get("mesh") is not None
                    and r.get("xl") == args.xl
                    and r.get("optimizer") == args.optimizer):
                ref = r["losses"][:n]
    return ref


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="gloo on the CPU, a tiny GPT-2 in fp32")
    parser.add_argument("--data", type=int, default=1)
    parser.add_argument("--pipe", type=int, default=1)
    parser.add_argument("--optimizer", choices=("adam", "cpu_adam"),
                        default="adam")
    parser.add_argument("--xl", action="store_true",
                        help="GPT-2-xl with offload_gradients")
    parser.add_argument("--threads", choices=("split", "inherit", "all"),
                        default="split",
                        help="the host kernel's OpenMP team")
    parser.add_argument("--seq", type=int, default=1024)
    parser.add_argument("--batch", type=int, default=4,
                        help="global batch rows")
    parser.add_argument("--micro-batches", type=int, default=2,
                        help="micro-batches of a step at --pipe > 1")
    parser.add_argument("--steps", type=int, default=3,
                        help="untimed steps first (the compared losses)")
    parser.add_argument("--timed", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch-seed", type=int, default=1)
    parser.add_argument("--reference", help="a JSON-lines file of this "
                        "script's one-rank runs to compare losses with")
    parser.add_argument("--rtol", type=float, default=2e-3,
                        help="the losses' tolerance against --reference")
    parser.add_argument("--no-mesh", action="store_true",
                        help="one rank, the engine built without a mesh")
    parser.add_argument("--save-peak", action="store_true",
                        help="time a checkpoint's gather and its peak "
                        "card memory after the steps")
    parser.add_argument("--out", help="also append the JSON line here")
    args = parser.parse_args(argv)

    device = "cpu" if args.cpu else None
    init_distributed(device=device)
    if args.threads == "inherit":
        cpu_adam.host_threads = lambda env=None: 0
    elif args.threads == "all":
        cpus = len(os.sched_getaffinity(0))
        cpu_adam.host_threads = lambda env=None: cpus
    dims = {"pipe": args.pipe, "data": args.data}
    mesh = make_mesh(dims)
    cfg = model_config(args)
    avail = mem_available()
    engine, batches = build(args, cfg, mesh, device)
    whole_params = engine._param_count()   # a collective under a pipe
    cuda = engine.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(engine.device)

    losses = [float(engine.train_batch(iter(batches)))
              for _ in range(args.steps)]
    sync()
    if cuda:
        engine.host_stream.timing = True
    kernel_s0 = cpu_adam.ds_adam_step.seconds
    step_ms = []
    for _ in range(args.timed):
        sync()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(iter(batches))))
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    timed = max(args.timed, 1)
    stream = engine.host_stream.timing_report() if cuda else None
    if stream is not None:
        stream = {k: (v / timed if k.endswith(("_ms", "_bytes")) else v)
                  for k, v in stream.items()}
    peak = torch.cuda.max_memory_allocated(engine.device) if cuda else None
    save = save_peak(engine, cuda) if args.save_peak else None
    rank = {"rank": get_rank(), "coords": {ax: mesh.index(ax)
                                           for ax in dims},
            "mem_available_bytes": avail,
            "pinned_host_bytes": sum(b.nbytes for b in host_buffers(engine)),
            "host_rows": engine.flat.shard_rows,
            "host_kernel_ms": (1e3 * (cpu_adam.ds_adam_step.seconds
                                      - kernel_s0) / timed
                               if args.optimizer == "cpu_adam" else None),
            "host_kernel_threads": cpu_adam.host_threads(),
            "stream_per_step": stream,
            "peak_memory_bytes": peak, "save": save,
            "card": pipe_example.card_line()}
    ranks = [None] * get_world_size()
    if dist.is_initialized():
        dist.all_gather_object(ranks, rank)
    else:
        ranks = [rank]
    if get_rank() != 0:
        return 0
    result = {"world": get_world_size(),
              "mesh": None if args.no_mesh else dims,
              "optimizer": args.optimizer, "xl": args.xl,
              "threads": args.threads, "global_batch": args.batch,
              "seq": cfg.max_position_embeddings,
              "layers": cfg.num_layers, "hidden": cfg.hidden_size,
              "dtype": "fp32" if args.cpu else "bf16",
              "offload_gradients": args.xl,
              "whole_parameters": whole_params, "losses": losses,
              "step_ms": step_ms,
              "step_ms_median": float(np.median(step_ms)) if step_ms
              else None, "host_cpus": len(os.sched_getaffinity(0)),
              "ranks": ranks}
    ref = reference_losses(args.reference, args, args.steps)
    if ref is not None and get_world_size() > 1:
        rel = np.abs(np.asarray(losses[:len(ref)]) - ref) / np.abs(ref)
        result.update(reference_losses=ref,
                      max_rel_diff_to_reference=float(rel.max()),
                      rtol=args.rtol,
                      within_rtol=bool(rel.max() <= args.rtol))
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if result.get("within_rtol", True) else 1


if __name__ == "__main__":
    sys.exit(main())
