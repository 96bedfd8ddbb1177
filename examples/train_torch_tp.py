#!/usr/bin/env python3
"""GPT-2 (optionally with MoE blocks) with tensor, expert, pipeline and
data parallelism on the PyTorch/CUDA port, one process a rank.

    torchrun --nproc-per-node 4 examples/train_torch_tp.py --model 4
    torchrun --nproc-per-node 4 examples/train_torch_tp.py --model 2 --data 2
    torchrun --nproc-per-node 4 examples/train_torch_tp.py --pipe 2 --model 2
    torchrun --nproc-per-node 4 examples/train_torch_tp.py --experts 8 --expert-axis 4
    torchrun --nproc-per-node 4 examples/train_torch_tp.py --sparse --model 2 --data 2
    torchrun --nproc-per-node 4 examples/train_torch_tp.py --bert --optimizer onebit --data 2 --model 2
    torchrun --nproc-per-node 4 examples/train_torch_tp.py --pipe 2 --data 2 --zero 3
    torchrun --nproc-per-node 2 examples/train_torch_tp.py --model 2 --cpu

Each process joins the ``torch.distributed`` world that torchrun
describes (NCCL with one card a rank, or gloo with ``--cpu``) and builds
the mesh ``{pipe, data, model, expert}`` from the flags.  The model is
GPT-2-medium (24 layers, hidden 1024, 16 heads, vocab 50304, seq 1024)
in bf16 at dropout 0, with ``--experts`` E > 0 routed experts in every
second block (top-2, capacity factor 1.25); ``--cpu`` makes it tiny and
fp32.  The weights are ``models/gpt2.py``'s ``random_params(config,
--seed)``, drawn whole on every rank and cut to the rank's Megatron
slices by the engine; the global batch is ``--batch`` rows of token ids
from ``--batch-seed``, the same every step, each data rank taking its
rows (at ``--pipe`` > 1, ``examples/train_torch_pipe.py``'s
``PipelineModule`` on ``--micro-batches`` micro-batches).  Lamb for the
dense model, Adam for MoE, ZeRO-2, lr 1e-4; ``--optimizer onebit`` is
OneBitAdam (lr 1e-5, ``--freeze-step``, ZeRO 0) and ``--zero`` another
stage.  ``--sparse``: GPT-2-medium at seq 4096 (global batch 2) with
block-sparse attention (Fixed unidirectional, 256-row blocks, a global
pattern for each of four groups of heads, so a model rank runs its
heads' rows of the layout); ``--bert``: BERT-large pretraining at seq
128, global batch 64 (MLM 20 a row and NSP, no padding).

Rank 0 prints one JSON line: the mesh, the losses (``--steps`` untimed
steps, then the timed ones), step ms (median of ``--timed`` steps
between two synchronizations), each rank's peak memory, the
collectives and bytes a step by verb (``comm.counter``), and
``--trace-steps`` more steps under ``torch.profiler``: the card's busy
ms a step outside NCCL, NCCL's ms and its share of the step.  With
``--reference PATH`` (a JSON-lines file this script wrote at one rank)
the first ``--steps`` losses are compared with the one-rank run's of the
same model.
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
from deepspeed_tpu_torch import comm  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,  # noqa: E402
                                             GPT2LMHead, random_params)
from deepspeed_tpu_torch.parallel import make_mesh  # noqa: E402
from deepspeed_tpu_torch.utils.distributed import (  # noqa: E402
    get_rank, get_world_size, init_distributed)
import train_torch_pipe as pipe_example  # noqa: E402


SPARSE_LAYOUT = dict(block=256, different_layout_per_head=True,
                     num_local_blocks=4, num_global_blocks=1,
                     num_different_global_patterns=4,
                     attention="unidirectional")
BERT_PRED = 20


def model_config(args):
    if args.bert:
        from deepspeed_tpu_torch.models.bert import BertConfig
        if args.cpu:
            return BertConfig(vocab_size=256, hidden_size=64,
                              num_hidden_layers=args.layers or 4,
                              num_attention_heads=4, intermediate_size=128,
                              max_position_embeddings=64,
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0,
                              max_predictions_per_seq=BERT_PRED)
        cfg = BertConfig.bert_large(
            vocab_size=30528, max_position_embeddings=args.seq or 128,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_predictions_per_seq=BERT_PRED)
        cfg.num_hidden_layers = args.layers or cfg.num_hidden_layers
        return cfg
    if args.cpu:
        base = dict(vocab_size=256, hidden_size=64, num_layers=4,
                    num_heads=4, max_position_embeddings=32)
    else:
        base = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                    num_heads=16, max_position_embeddings=1024)
    if args.layers:
        base["num_layers"] = args.layers
    if args.seq:
        base["max_position_embeddings"] = args.seq
    moe = (dict(moe_experts=args.experts, moe_every=2, moe_k=2,
                moe_capacity_factor=1.25) if args.experts else {})
    sparse = {}
    if args.sparse:
        from deepspeed_tpu_torch.ops.sparse_attention import \
            FixedSparsityConfig
        layout = dict(SPARSE_LAYOUT, block=64 if args.cpu else 256)
        sparse = dict(attn_impl="sparse", sparsity_config=FixedSparsityConfig(
            num_heads=base["num_heads"], **layout))
    return GPT2Config(embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0,
                      **base, **moe, **sparse)


def kind(args):
    """The model a line is of, for matching a reference line."""
    return "bert" if args.bert else "gpt2-sparse" if args.sparse else "gpt2"


def ds_config(args, micro, acc):
    if args.optimizer == "onebit":
        # no bias correction in the warmup: a first step moves every
        # weight by about 3·lr, which at 1e-4 sends BERT-large's loss
        # from 11.25 to 13.87 on one card (H100); 1e-5 keeps the
        # compared warmup losses out of that jump
        opt = {"type": "OneBitAdam",
               "params": {"lr": 1e-5, "freeze_step": args.freeze_step}}
    else:
        opt = {"type": args.optimizer or ("Adam" if args.experts
                                          else "Lamb"),
               "params": {"lr": 1e-4}}
    zero = args.zero if args.zero is not None else (
        0 if args.optimizer == "onebit" else 2)
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": acc, "steps_per_print": 10 ** 9,
            "optimizer": opt, "zero_optimization": {"stage": zero},
            "bf16": {"enabled": not args.cpu}}


def bert_batches(args, cfg, dp_rank):
    """This data rank's rows of one bing_bert batch: token ids, token
    types 0 then 1 by halves, exactly ``BERT_PRED`` MLM labels a row,
    NSP labels, no padding."""
    rng = np.random.default_rng(args.batch_seed)
    s = cfg.max_position_embeddings
    ids = rng.integers(0, cfg.vocab_size, size=(args.batch, s))
    labels = np.full((args.batch, s), -100, np.int64)
    for r in range(args.batch):
        pos = rng.permutation(s)[:BERT_PRED]
        labels[r, pos] = ids[r, pos]
    batch = {"input_ids": ids,
             "token_type_ids": np.repeat((np.arange(s) >= s // 2)[None],
                                         args.batch, 0).astype(np.int64),
             "masked_lm_labels": labels,
             "next_sentence_labels": rng.integers(0, 2, size=(args.batch,))}
    per = args.batch // args.data
    return [{k: v[dp_rank * per:(dp_rank + 1) * per]
             for k, v in batch.items()}]


def build(args, cfg, mesh, device):
    """The engine and this rank's micro-batches of the global batch."""
    seq = cfg.max_position_embeddings
    dp_rank = mesh.index("data")
    if args.bert:
        from deepspeed_tpu_torch.models.bert import (BertForPreTraining,
                                                     random_params as bp)
        engine, *_ = tds.initialize(
            model=BertForPreTraining(cfg), model_parameters=bp(cfg,
                                                               args.seed),
            config=ds_config(args, args.batch // args.data, 1), mesh=mesh,
            device=device)
        return engine, bert_batches(args, cfg, dp_rank)
    batches = pipe_example.token_batches(
        cfg.vocab_size, args.batch, seq,
        args.micro_batches if args.pipe > 1 else 1, args.batch_seed)
    params = random_params(cfg, args.seed)
    if args.pipe > 1:
        model = pipe_example.gpt2_pipeline_module(cfg)
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
                                config=config, mesh=mesh, device=device)
    return engine, batches


def reference_losses(path, args, cfg, n):
    """The first ``n`` losses of the one-rank run of this model (and
    optimizer) in the JSON-lines file ``path`` (None where it has
    none)."""
    if not path or not os.path.exists(path):
        return None
    ref = None
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if (r.get("world") == 1
                    and r.get("experts") == getattr(cfg, "moe_experts", 0)
                    and r.get("kind", "gpt2") == kind(args)
                    and r.get("optimizer") == args.optimizer):
                ref = r["losses"][:n]
    return ref


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="gloo on the CPU, a tiny GPT-2 in fp32")
    parser.add_argument("--model", type=int, default=1)
    parser.add_argument("--data", type=int, default=1)
    parser.add_argument("--pipe", type=int, default=1)
    parser.add_argument("--experts", type=int, default=0,
                        help="routed experts in every second block")
    parser.add_argument("--expert-axis", type=int, default=1)
    parser.add_argument("--sparse", action="store_true",
                        help="GPT-2 with block-sparse attention (seq 4096 "
                        "unless --seq)")
    parser.add_argument("--bert", action="store_true",
                        help="BERT-large pretraining at seq 128")
    parser.add_argument("--optimizer", choices=("lamb", "adam", "onebit"),
                        default=None, help="default: Lamb, Adam for MoE")
    parser.add_argument("--freeze-step", type=int, default=2,
                        help="OneBitAdam's dense steps")
    parser.add_argument("--zero", type=int, default=None,
                        help="ZeRO stage (default 2, 0 for OneBitAdam)")
    parser.add_argument("--seq", type=int, default=None)
    parser.add_argument("--layers", type=int, default=None)
    parser.add_argument("--batch", type=int, default=8,
                        help="global batch rows")
    parser.add_argument("--micro-batches", type=int, default=4,
                        help="micro-batches of a step at --pipe > 1")
    parser.add_argument("--steps", type=int, default=3,
                        help="untimed steps first (the compared losses)")
    parser.add_argument("--timed", type=int, default=5)
    parser.add_argument("--trace-steps", type=int, default=2,
                        help="steps under torch.profiler (0: none)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch-seed", type=int, default=1)
    parser.add_argument("--reference", help="a JSON-lines file of this "
                        "script's one-rank runs to compare losses with")
    parser.add_argument("--rtol", type=float, default=2e-3,
                        help="the losses' tolerance against --reference")
    parser.add_argument("--out", help="also append the JSON line here")
    args = parser.parse_args(argv)
    if args.sparse and not args.seq:
        args.seq = 256 if args.cpu else 4096
    if args.sparse and not args.cpu and args.batch == 8:
        args.batch = 2      # chip_smoke.py's sparse train cell
    if args.bert and not args.cpu and args.batch == 8:
        args.batch = 64

    device = "cpu" if args.cpu else None
    init_distributed(device=device)
    dims = {"pipe": args.pipe, "data": args.data, "model": args.model,
            "expert": args.expert_axis}
    mesh = make_mesh(dims)
    cfg = model_config(args)
    engine, batches = build(args, cfg, mesh, device)
    whole_params = engine._param_count()   # a collective under a pipe
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
    calls = {k: v / timed for k, v in comm.counter.calls.items()}
    nbytes = {k: v / timed for k, v in comm.counter.bytes.items()}
    trace = (pipe_example.trace_steps(engine, batches, args.trace_steps,
                                      sync, losses)
             if cuda and args.trace_steps else None)
    if trace is not None:
        trace["nccl_share_of_step"] = trace["nccl_ms"] / trace["step_ms"]
    rank = {"rank": get_rank(), "coords": {ax: mesh.index(ax) for ax in
                                           dims},
            "parameters": int(sum(engine.segments.sizes)),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(
                engine.device) if cuda else None),
            "collectives_per_step": calls, "bytes_per_step": nbytes,
            "trace": trace, "card": pipe_example.card_line()}
    ranks = [None] * get_world_size()
    if dist.is_initialized():
        dist.all_gather_object(ranks, rank)
    else:
        ranks = [rank]
    if get_rank() != 0:
        return 0
    result = {"world": get_world_size(), "mesh": dims, "kind": kind(args),
              "optimizer": args.optimizer,
              "zero": engine.zero_stage,
              "experts": getattr(cfg, "moe_experts", 0),
              "global_batch": args.batch,
              "seq": cfg.max_position_embeddings,
              "layers": getattr(cfg, "num_layers", None)
              or cfg.num_hidden_layers, "hidden": cfg.hidden_size,
              "vocab": cfg.vocab_size,
              "dtype": "fp32" if args.cpu else "bf16",
              "whole_parameters": whole_params, "losses": losses,
              "step_ms": step_ms,
              "step_ms_median": float(np.median(step_ms)) if step_ms
              else None, "ranks": ranks}
    ref = reference_losses(args.reference, args, cfg, args.steps)
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
