#!/usr/bin/env python3
"""GPT-2 with pipeline × data parallelism on the PyTorch/CUDA port, one
process a rank (the port's counterpart of ``examples/gpt2_pipeline.py``).

    torchrun --nproc-per-node 4 examples/train_torch_pipe.py --pipe 4
    torchrun --nproc-per-node 4 examples/train_torch_pipe.py --pipe 2 --data 2
    torchrun --nproc-per-node 2 examples/train_torch_pipe.py --pipe 2 --cpu

Each process joins the ``torch.distributed`` world that torchrun
describes: NCCL with one card a rank, or gloo with ``--cpu``.  The model
is GPT-2 as a ``PipelineModule``: the token and position embedding
(``Embedding``, its ``wte`` tied to the LM head), ``--layers``
``TransformerLayer`` blocks, the final layernorm and the tied head, split
by ``type:TransformerLayer`` so each stage gets the same number of
blocks (the embedding rides on the first stage, the head on the last).
By default it is GPT-2-medium (24 layers, hidden 1024, 16 heads, vocab
50304, seq 1024) in bf16 with Lamb and ZeRO-``--zero``; ``--cpu`` makes
it tiny and fp32.  The weights are ``models/gpt2.py``'s
``random_params(config, --seed)`` carried into the pipeline's tree
(:func:`pipe_params_from_gpt2`), and the global batch is ``--batch``
rows of token ids from ``--batch-seed``, the same every step, split
into ``--micro-batches`` micro-batches (each split over the data
ranks): the set-up of ``chip_smoke.py``'s pipe phase, so at dropout 0
the first losses match its one-stage run (``--reference`` reads them
from its ``--out`` file).

Rank 0 prints one JSON line: the losses, step ms (the wall of a step
between two synchronizations, median of the timed steps), each stage's
peak memory and point-to-point bytes a step, and two readings of where
a stage's step goes:

- ``trace``: ``--trace-steps`` more steps under ``torch.profiler``,
  untouched: the card's busy ms a step (the union of its kernels and
  copies other than NCCL's, whose point-to-point kernels spin while
  they wait for the neighbour), the NCCL kernels' ms, and the idle
  share ``1 - busy / wall`` of the traced steps' wall and of the timed
  steps' median (the profiler's host work lengthens a step that the
  host paces, not the card's kernels), beside the schedule's bubble
  ``(stages - 1) / (micro_batches + stages - 1)``;
- ``instructions``: one more step with every instruction of the
  engine's interpreter timed between two synchronizations (this
  script wraps the engine's ``_exec`` and ``_exec_comm``): the ms of
  each kind, the point-to-point ms with the wait for the neighbour.
  The synchronizations lengthen that step, so its shares are not the
  untouched step's.
"""

import collections

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import deepspeed_tpu_torch as tds  # noqa: E402
from deepspeed_tpu_torch import comm  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,  # noqa: E402
                                             random_params)
from deepspeed_tpu_torch.comm import copy_to  # noqa: E402
from deepspeed_tpu_torch.models.layers import (  # noqa: E402
    TransformerLayer, dropout, layer_norm, vocab_parallel_cross_entropy,
    vocab_parallel_embedding)
from deepspeed_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS,  # noqa: E402
                                          PIPE_AXIS, make_mesh)
from deepspeed_tpu_torch.runtime.pipe import (LayerSpec,  # noqa: E402
                                              PipelineModule, TiedLayerSpec)
from deepspeed_tpu_torch.utils.distributed import (  # noqa: E402
    get_rank, init_distributed)

TIED_KEY = "embed"


class Embedding:
    """Token and position embeddings, with the embedding dropout; the
    token table is vocab-parallel under a ``model`` axis."""

    def __init__(self, vocab, hidden, max_pos, dropout_rate=0.0,
                 initializer_range=0.02):
        self.vocab, self.hidden, self.max_pos = vocab, hidden, max_pos
        self.dropout_rate = dropout_rate
        self.initializer_range = initializer_range

    def init(self, seed):
        rng = np.random.default_rng(seed)
        r = np.float32(self.initializer_range)
        return {"wte": rng.standard_normal((self.vocab, self.hidden),
                                           dtype=np.float32) * r,
                "wpe": rng.standard_normal((self.max_pos, self.hidden),
                                           dtype=np.float32) * r}

    @staticmethod
    def partition_specs():
        return {"wte": ("model", None), "wpe": (None, None)}

    def apply(self, params, ids, rng=None, deterministic=True):
        s = ids.shape[1]
        x = vocab_parallel_embedding(params["wte"], ids) \
            + params["wpe"][None, :s]
        return dropout(rng, x, self.dropout_rate, deterministic)


class FinalNorm:
    def __init__(self, hidden, eps=1e-5):
        self.hidden, self.eps = hidden, eps

    def init(self, seed):
        return {"scale": np.ones((self.hidden,), np.float32),
                "bias": np.zeros((self.hidden,), np.float32)}

    def apply(self, params, x):
        return layer_norm(params, x, self.eps)


def lm_head(params, x):
    """Decode with the tied token embedding, transposed (under a
    ``model`` axis, this rank's vocab slice of the logits)."""
    return copy_to(x, MODEL_AXIS) @ params["wte"].T.to(x.dtype)


def lm_loss(logits, labels):
    return vocab_parallel_cross_entropy(logits, labels, ignore_index=-100)


def gpt2_pipeline_module(cfg, **module_kw):
    """GPT-2 of ``cfg`` (``models/gpt2.py``'s config) as a
    ``PipelineModule``: ``cfg.num_layers + 3`` layers."""
    h = cfg.hidden_size
    embed = (TIED_KEY, Embedding, cfg.vocab_size, h,
             cfg.max_position_embeddings)
    specs = ([TiedLayerSpec(*embed, dropout_rate=cfg.embd_dropout,
                            tied_weight_attr="wte")]
             + [LayerSpec(TransformerLayer, h, cfg.num_heads, causal=True,
                          attn_dropout_ratio=cfg.attn_dropout,
                          hidden_dropout_ratio=cfg.resid_dropout,
                          pre_layer_norm=True,
                          initializer_range=cfg.initializer_range,
                          layer_norm_eps=cfg.layer_norm_eps)
                for _ in range(cfg.num_layers)]
             + [LayerSpec(FinalNorm, h, cfg.layer_norm_eps),
                TiedLayerSpec(*embed, forward_fn=lm_head,
                              tied_weight_attr="wte")])
    module_kw.setdefault("partition_method", "type:TransformerLayer")
    return PipelineModule(specs, loss_fn=lm_loss, **module_kw)


def pipe_params_from_gpt2(tree):
    """``models/gpt2.py``'s param tree as the pipeline module's (no
    copies): ``wte`` is the tied param, ``wpe`` the embedding's own, the
    blocks one layer each, ``ln_f`` the final norm's.  The head's use of
    the tied embedding keeps a ``wpe`` of its own that nothing reads (the
    JAX example's layout); it gets the embedding's values."""
    n = len(tree["blocks"])
    layers = ([{"wpe": tree["wpe"]}]
              + [tree["blocks"][f"layer_{i}"] for i in range(n)]
              + [tree["ln_f"], {"wpe": tree["wpe"]}])
    return {"layers": tuple(layers), "tied": {TIED_KEY: tree["wte"]}}


def token_batches(vocab, rows, seq, micro_batches, seed):
    """The global batch's micro-batches: ``(ids, labels)`` with the
    labels the ids shifted left and -100 at the end (GPT-2's own
    labels)."""
    ids = np.random.default_rng(seed).integers(0, vocab, size=(rows, seq))
    labels = np.concatenate([ids[:, 1:], np.full((rows, 1), -100)], axis=1)
    per = rows // micro_batches
    return [(ids[i * per:(i + 1) * per], labels[i * per:(i + 1) * per])
            for i in range(micro_batches)]


def rank_rows(batches, rank, world):
    def cut(x):
        per = x.shape[0] // world
        return x[rank * per:(rank + 1) * per]

    return [(cut(x), cut(y)) for x, y in batches]


def card_line():
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if not torch.cuda.is_available():
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i",
             str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name()


def union_us(spans):
    """The length of the union of ``[(start, end)]`` (microseconds)."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def trace_steps(engine, batches, steps, sync, losses):
    """``steps`` steps under ``torch.profiler`` (their losses appended
    to ``losses``): their wall ms a step, the card's busy ms a step
    outside NCCL's kernels, NCCL's, and the idle share.  Only the device
    work queued inside the steps counts (from the start of a
    ``record_function`` range around them), not the barrier's kernel
    that waits for the other ranks before them."""
    from torch.autograd import DeviceType

    sync()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        if dist.is_initialized():
            # the ranks' profilers start at different moments: without
            # this, the early ranks' walls include the wait for the last
            dist.barrier()
            sync()
        with torch.profiler.record_function("traced_steps"):
            t0 = time.perf_counter()
            out = [engine.train_batch(iter(batches)) for _ in range(steps)]
            sync()
            wall_us = 1e6 * (time.perf_counter() - t0)
    losses += [float(x) for x in out]
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == "traced_steps")
    # the range's own device-side annotation spans the whole window
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in events if e.device_type == DeviceType.CUDA
             and e.time_range.start >= start and e.name != "traced_steps"]
    nccl = [(a, b) for n, a, b in spans if "nccl" in n.lower()]
    busy = union_us([(a, b) for n, a, b in spans if "nccl" not in n.lower()])
    return {"steps": steps, "step_ms": wall_us / 1e3 / steps,
            "busy_ms": busy / 1e3 / steps,
            "nccl_ms": union_us(nccl) / 1e3 / steps,
            "device_events": len(spans),
            "idle_share": 1.0 - busy / wall_us if spans else None}


class timed_instructions:
    """Within the block, each instruction the engine's interpreter runs
    is timed between two synchronizations and its seconds added to
    ``secs`` by name (a step's transfers under ``comm``)."""

    def __init__(self, engine, secs, sync):
        self.engine, self.secs, self.sync = engine, secs, sync

    def wrap(self, fn, name_of):
        def timed(arg):
            self.sync()
            t0 = time.perf_counter()
            out = fn(arg)
            self.sync()
            self.secs[name_of(arg)] += time.perf_counter() - t0
            return out

        return timed

    def __enter__(self):
        e = self.engine
        e._exec = self.wrap(e._exec, lambda cmd: cmd.name)
        e._exec_comm = self.wrap(e._exec_comm, lambda cmds: "comm")
        return self

    def __exit__(self, *exc):
        del self.engine._exec, self.engine._exec_comm


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="gloo on the CPU, a tiny GPT-2 in fp32")
    parser.add_argument("--pipe", type=int, default=2)
    parser.add_argument("--data", type=int, default=1)
    parser.add_argument("--interleave", type=int, default=1)
    parser.add_argument("--layers", type=int, default=None)
    parser.add_argument("--hidden", type=int, default=None)
    parser.add_argument("--heads", type=int, default=None)
    parser.add_argument("--vocab", type=int, default=None)
    parser.add_argument("--seq", type=int, default=None)
    parser.add_argument("--batch", type=int, default=8,
                        help="global batch rows")
    parser.add_argument("--micro-batches", type=int, default=4)
    parser.add_argument("--dropout", type=float, default=0.0)
    parser.add_argument("--zero", type=int, default=2)
    parser.add_argument("--remat", type=int, default=0,
                        help="activation_checkpoint_interval")
    parser.add_argument("--steps", type=int, default=3,
                        help="untimed steps first (the compared losses)")
    parser.add_argument("--timed", type=int, default=5)
    parser.add_argument("--trace-steps", type=int, default=2,
                        help="steps under torch.profiler (0: none)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch-seed", type=int, default=1)
    parser.add_argument("--reference", help="chip_smoke.py's --out file: "
                        "compare the first losses with its pipe phase's")
    parser.add_argument("--out", help="also write the JSON line here")
    args = parser.parse_args(argv)

    device = "cpu" if args.cpu else None
    init_distributed(device=device)
    if args.cpu:
        base = GPT2Config(vocab_size=256, hidden_size=64, num_layers=4,
                          num_heads=4, max_position_embeddings=32)
    else:
        base = GPT2Config.gpt2_medium()
    cfg = GPT2Config(
        vocab_size=args.vocab or base.vocab_size,
        hidden_size=args.hidden or base.hidden_size,
        num_layers=args.layers or base.num_layers,
        num_heads=args.heads or base.num_heads,
        max_position_embeddings=args.seq or base.max_position_embeddings,
        embd_dropout=args.dropout, attn_dropout=args.dropout,
        resid_dropout=args.dropout)
    seq = cfg.max_position_embeddings
    mesh = make_mesh({PIPE_AXIS: args.pipe, DATA_AXIS: args.data})
    module = gpt2_pipeline_module(cfg, interleave=args.interleave,
                                  activation_checkpoint_interval=args.remat)
    micro = args.batch // args.micro_batches // args.data
    engine, *_ = tds.initialize(
        model=module,
        model_parameters=pipe_params_from_gpt2(random_params(cfg,
                                                             args.seed)),
        config={"train_micro_batch_size_per_gpu": micro,
                "gradient_accumulation_steps": args.micro_batches,
                "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Lamb", "params": {"lr": 1e-4}},
                "zero_optimization": {"stage": args.zero},
                "bf16": {"enabled": not args.cpu}},
        mesh=mesh, device=device)
    batches = rank_rows(token_batches(cfg.vocab_size, args.batch, seq,
                                      args.micro_batches, args.batch_seed),
                        engine.dp_rank, engine.dp_world_size)
    cuda = engine.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(engine.device)

    losses = [float(engine.train_batch(iter(batches)))
              for _ in range(args.steps)]
    if cuda:
        torch.cuda.reset_peak_memory_stats(engine.device)
    comm.counter.reset()
    step_ms = []
    for _ in range(args.timed):
        sync()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(iter(batches))))
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    timed = max(args.timed, 1)
    p2p_bytes = (comm.counter.bytes.get("send", 0)
                 + comm.counter.bytes.get("recv", 0)) / timed
    trace = (trace_steps(engine, batches, args.trace_steps, sync, losses)
             if cuda and args.trace_steps else None)
    if trace is not None and step_ms:
        trace["idle_share_of_timed_wall"] = (
            1.0 - trace["busy_ms"] / float(np.median(step_ms)))
    secs = collections.Counter()
    with timed_instructions(engine, secs, sync):
        sync()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(iter(batches))))
        sync()
        wall = time.perf_counter() - t0
    work = sum(secs[k] for k in ("LoadMicroBatch", "ForwardPass",
                                 "BackwardPass", "OptimizerStep"))
    stage = {"rank": get_rank(), "stage": engine.stage_id,
             "data_rank": engine.dp_rank, "layers": engine.stage_layers,
             "parameters": int(sum(engine.segments.sizes)),
             "peak_memory_bytes": (torch.cuda.max_memory_allocated(
                 engine.device) if cuda else None),
             "p2p_bytes_per_step": p2p_bytes,
             "trace": trace,
             "instructions": {
                 "step_ms": 1e3 * wall,
                 "ms": {k: 1e3 * v for k, v in secs.items()},
                 "p2p_ms": 1e3 * secs["comm"],
                 "outside_work_share": 1.0 - work / wall},
             "card": card_line()}
    stages = [None] * dist.get_world_size() if dist.is_initialized() \
        else [stage]
    if dist.is_initialized():
        dist.all_gather_object(stages, stage)
    if get_rank() != 0:
        return 0
    S, M = engine.pipe_world_size, engine.micro_batches
    result = {"pipe": S, "data": engine.dp_world_size,
              "interleave": engine.interleave, "micro_batches": M,
              "global_batch": args.batch, "seq": seq,
              "layers": cfg.num_layers, "hidden": cfg.hidden_size,
              "vocab": cfg.vocab_size, "dropout": args.dropout,
              "dtype": "fp32" if args.cpu else "bf16", "losses": losses,
              "step_ms": step_ms,
              "step_ms_median": float(np.median(step_ms)) if step_ms
              else None,
              "bubble_share": (S - 1) / (M + S - 1), "stages": stages}
    if args.reference:
        with open(args.reference) as f:
            ref = json.load(f)["pipe"]["parity"]["pipe_losses"]
        n = min(len(ref), args.steps)
        result["reference_losses"] = ref[:n]
        result["max_rel_diff_to_reference"] = float(np.max(
            np.abs(np.asarray(losses[:n]) - ref[:n]) / np.abs(ref[:n])))
    line = json.dumps(result)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
