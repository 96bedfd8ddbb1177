#!/usr/bin/env python3
"""GPT-2 (or BERT) with sequence parallelism over the ``seq`` axis,
composed with data, tensor and expert parallelism, on the PyTorch/CUDA
port, one process a rank.

    torchrun --nproc-per-node 4 examples/train_torch_ring.py --seq 4
    torchrun --nproc-per-node 4 examples/train_torch_ring.py --seq 2 --data 2
    torchrun --nproc-per-node 4 examples/train_torch_ring.py --seq 2 --model 2
    torchrun --nproc-per-node 4 examples/train_torch_ring.py --seq 4 --core dense
    torchrun --nproc-per-node 4 examples/train_torch_ring.py --seq 4 --bert-sparse
    torchrun --nproc-per-node 4 examples/train_torch_ring.py --seq 2 --expert 2 --moe 4
    torchrun --nproc-per-node 1 examples/train_torch_ring.py --dense
    torchrun --nproc-per-node 2 examples/train_torch_ring.py --seq 2 --cpu

``--core`` picks the attention core over ``seq``: ``ring`` (the
default), or ``dense`` and ``sparse``, the gather cores (K/V gathered,
the kernels at each chunk's query-row offset); ``--dense`` is the dense
core at one rank.  ``--bert-sparse`` trains BERT-large pretraining with
the sparse core (Fixed bidirectional 128-row blocks, one layout a head:
chip_smoke's ``BERT_SPARSE_LAYOUT``, G = 4) on MLM batches of 640
labelled positions a row, no padding; ``--moe E`` gives GPT-2 E experts
in every second block (top-2), sharded over ``--expert``.  The port's
runner (``python3 -m deepspeed_tpu_torch.launcher.runner``) launches it
the same way, one rank a card.

Each process joins the ``torch.distributed`` world that torchrun
describes (NCCL with one card a rank, or gloo with ``--cpu``) and builds
the mesh ``{data, seq, model}`` from the flags.  The model is
GPT-2-medium (24 layers, hidden 1024, 16 heads, vocab 50304) at
``--seq-len`` positions (``max_position_embeddings`` too, 4096 by
default) in bf16 at dropout 0, with ``attn_impl="ring"`` (``--dense``:
the dense core, at one rank); ``--cpu`` makes it tiny and fp32.  The
weights are ``models/gpt2.py``'s ``random_params(config, --seed)``; the
global batch is ``--micro-batch`` × ``--data`` rows of token ids from
``--batch-seed``, the same every step, each data rank taking its rows
whole and each seq rank of it its chunk of them.  Lamb, ZeRO-2, lr
1e-4; ``--remat`` recomputes every layer in backward.

Rank 0 prints one JSON line: the mesh, the losses (``--steps`` untimed
steps, then the timed ones), step ms (median of ``--timed`` steps
between two synchronizations), each rank's peak memory, the collectives
and bytes a step by verb (``comm.counter``: the ring's ``send`` and
``recv``, the gradient's all-reduce and reduce-scatter), and
``--trace-steps`` more steps under ``torch.profiler``: the card's busy
ms a step outside NCCL, NCCL's ms and its share of the step, and each
card's name and power limit.  With ``--reference PATH`` (a JSON-lines
file this script wrote at one rank) the first ``--steps`` losses are
compared with the one-rank run's on the same global batch.
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
from deepspeed_tpu_torch.models.bert import (  # noqa: E402
    BertConfig, BertForPreTraining)
from deepspeed_tpu_torch.models.bert import \
    random_params as bert_params  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,  # noqa: E402
                                             GPT2LMHead, random_params)
from deepspeed_tpu_torch.ops.sparse_attention import \
    FixedSparsityConfig  # noqa: E402
from deepspeed_tpu_torch.parallel import make_mesh  # noqa: E402
from deepspeed_tpu_torch.utils.distributed import (  # noqa: E402
    get_rank, get_world_size, init_distributed)
import train_torch_pipe as pipe_example  # noqa: E402


def model_config(args):
    if args.bert_sparse:
        return bert_config(args)
    if args.cpu:
        base = dict(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4)
    else:
        base = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
                    num_heads=16)
    if args.layers:
        base["num_layers"] = args.layers
    sparse = {}
    if args.core == "sparse":
        sparse["sparsity_config"] = FixedSparsityConfig(
            num_heads=base["num_heads"], block=16 if args.cpu else 256,
            num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional")
    moe = (dict(moe_experts=args.moe, moe_every=2, moe_k=2) if args.moe
           else {})
    return GPT2Config(embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0,
                      max_position_embeddings=args.seq_len,
                      attn_impl="auto" if args.dense else (
                          "auto" if args.core == "dense" else args.core),
                      remat=args.remat, **base, **sparse, **moe)


def bert_config(args):
    """BERT-large (or a tiny BERT with ``--cpu``) with the sparse core at
    dropout 0."""
    if args.cpu:
        base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=256)
        block = 16
    else:
        base = dict(vocab_size=30528, hidden_size=1024,
                    num_hidden_layers=24, num_attention_heads=16,
                    intermediate_size=4096)
        block = 128
    if args.layers:
        base["num_hidden_layers"] = args.layers
    layout = FixedSparsityConfig(
        num_heads=base["num_attention_heads"], block=block,
        different_layout_per_head=True, num_local_blocks=4,
        num_global_blocks=1, attention="bidirectional",
        num_different_global_patterns=4)
    return BertConfig(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0,
                      max_position_embeddings=args.seq_len,
                      max_predictions_per_seq=args.seq_len * 5 // 32,
                      attn_impl="sparse", sparsity_config=layout, **base)


def bert_batch(cfg, rows, seq_len, seed):
    """MLM + NSP rows: ids, token types, ``max_predictions_per_seq``
    labelled positions a row, no padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(rows, seq_len))
    labels = np.full((rows, seq_len), -100, np.int64)
    for r in range(rows):
        pos = rng.permutation(seq_len)[:cfg.max_predictions_per_seq]
        labels[r, pos] = ids[r, pos]
    return {"input_ids": torch.from_numpy(ids),
            "token_type_ids": torch.from_numpy(
                (np.arange(seq_len)[None] >= seq_len // 2)
                .repeat(rows, 0).astype(np.int64)),
            "masked_lm_labels": torch.from_numpy(labels),
            "next_sentence_labels": torch.from_numpy(
                rng.integers(0, 2, size=rows))}


def ds_config(args):
    return {"train_micro_batch_size_per_gpu": args.micro_batch,
            "gradient_accumulation_steps": 1, "steps_per_print": 10 ** 9,
            "optimizer": {"type": "Lamb", "params": {"lr": 1e-4}},
            "zero_optimization": {"stage": 2},
            "bf16": {"enabled": not args.cpu}}


def reference_losses(path, rows, seq_len, n, model="gpt2", moe=0):
    """The first ``n`` losses of a one-rank run of ``model`` (with
    ``moe`` experts) on ``rows`` rows of ``seq_len`` positions in the
    JSON-lines file ``path`` (None where it has none)."""
    if not path or not os.path.exists(path):
        return None
    ref = None
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if (r.get("world") == 1 and r.get("global_batch") == rows
                    and r.get("seq") == seq_len
                    and r.get("model", "gpt2") == model
                    and r.get("moe", 0) == moe):
                ref = r["losses"][:n]
    return ref


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="gloo on the CPU, a tiny GPT-2 in fp32")
    parser.add_argument("--seq", type=int, default=1)
    parser.add_argument("--data", type=int, default=1)
    parser.add_argument("--model", type=int, default=1)
    parser.add_argument("--expert", type=int, default=1)
    parser.add_argument("--core", choices=("ring", "dense", "sparse"),
                        default="ring", help="the attention core over seq")
    parser.add_argument("--dense", action="store_true",
                        help="the dense attention core (one rank)")
    parser.add_argument("--bert-sparse", action="store_true",
                        help="BERT-large pretraining, the sparse core")
    parser.add_argument("--moe", type=int, default=0,
                        help="experts in every second GPT-2 block")
    parser.add_argument("--remat", action="store_true",
                        help="recompute every layer in backward")
    parser.add_argument("--layers", type=int, default=None)
    parser.add_argument("--seq-len", type=int, default=None,
                        help="positions a row (4096; 64 with --cpu)")
    parser.add_argument("--micro-batch", type=int, default=2,
                        help="rows a data rank")
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
    if args.seq_len is None:
        args.seq_len = 64 if args.cpu else 4096

    device = "cpu" if args.cpu else None
    init_distributed(device=device)
    dims = {"data": args.data, "seq": args.seq, "model": args.model,
            "expert": args.expert}
    mesh = make_mesh(dims) if get_world_size() > 1 else None
    cfg = model_config(args)
    rows = args.micro_batch * args.data
    dp_rank = mesh.index("data") if mesh is not None else 0
    mine = slice(dp_rank * args.micro_batch, (dp_rank + 1) * args.micro_batch)
    if args.bert_sparse:
        batch = bert_batch(cfg, rows, args.seq_len, args.batch_seed)
        batches = [{k: v[mine] for k, v in batch.items()}]
        model, params = BertForPreTraining(cfg), bert_params(cfg, args.seed)
    else:
        (ids, _), = pipe_example.token_batches(
            cfg.vocab_size, rows, args.seq_len, 1, args.batch_seed)
        batches = [{"input_ids": ids[mine]}]
        model, params = GPT2LMHead(cfg), random_params(cfg, args.seed)
    engine, *_ = tds.initialize(model=model, model_parameters=params,
                                config=ds_config(args), mesh=mesh,
                                device=device)
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
    rank = {"rank": get_rank(),
            "coords": {ax: (mesh.index(ax) if mesh is not None else 0)
                       for ax in dims},
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(
                engine.device) if cuda else None),
            "collectives_per_step": calls, "bytes_per_step": nbytes,
            "trace": trace, "card": pipe_example.card_line()}
    ranks = [None] * get_world_size()
    if dist.is_initialized() and get_world_size() > 1:
        dist.all_gather_object(ranks, rank)
    else:
        ranks = [rank]
    if get_rank() != 0:
        return 0
    result = {"world": get_world_size(), "mesh": dims,
              "model": "bert" if args.bert_sparse else "gpt2",
              "moe": args.moe, "attn_impl": cfg.attn_impl,
              "remat": getattr(cfg, "remat", False),
              "global_batch": rows, "seq": args.seq_len,
              "layers": getattr(cfg, "num_layers", None)
              or cfg.num_hidden_layers, "hidden": cfg.hidden_size,
              "vocab": cfg.vocab_size,
              "dtype": "fp32" if args.cpu else "bf16",
              "parameters": engine._param_count(), "losses": losses,
              "step_ms": step_ms,
              "step_ms_median": float(np.median(step_ms)) if step_ms
              else None, "ranks": ranks}
    ref = reference_losses(args.reference, rows, args.seq_len, args.steps,
                           result["model"], args.moe)
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
