#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on
one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources, holds
each against its plain PyTorch version on the card, serves GPT-2-medium
at full width through the port's ``InferenceEngine``, checks greedy
tokens on the card against a CPU serve of the same weights, trains
GPT-2-medium at full width and depth through ``initialize`` and
``train_batch``, checks a short training run on the card against the
CPU, does the same two things again at seq 4096 with block-sparse
attention, pretrains BERT-large, dense at seq 128 and block-sparse at
seq 4096 through the super-tile kernels, saves GPT-2-medium between
steps and resumes it bitwise, then trains GPT-2-medium and BERT-large in
fp16 under the dynamic loss scaler, rolls GPT-2-medium back to its
checkpoint after a forced divergence, trains GPT-2-medium under
activation checkpointing and the chunked LM loss (up to micro-batch 32),
BERT-large under remat and Progressive Layer Drop, fine-tunes
BERT-large on SQuAD- and MNLI-shaped batches, trains with the state on
the host (ZeRO-Offload), and trains GPT-2-medium and BERT-large again
through the data-parallel mesh on NCCL.  Phases, in order; any
failure raises, so the script exits non-zero:

1. env      — card name and power limit, torch/CUDA versions, kernel
              build (one nvcc per source, all started together);
2. kernel   — B1, the flash-attention forward (bf16 on the tensor
              cores, fp32 scalar), vs ``flash_attention_reference`` in
              fp32 and bf16, out and lse (bf16 lse also to 1e-4), two
              runs bitwise equal: at each prefill bucket on strided
              views of a fused QKV projection, as the prefill passes
              them, and at the edges of the 64-row tiles (s=65, kv_len
              201 under dropout, causal kv_len > s, d=128 at s=1024 on
              fused-QKV views, a fully masked row at s=1024: out 0 and
              lse MAX_FLOOR, BERT's 21 gathered rows with a key mask
              and dropout); its device time per launch at each bucket
              (median of 20 runs of 10 back-to-back launches between
              CUDA events) beside the plain version's,
              ``reference_attention``'s (the dispatch's other path,
              behind ``FLASH_MIN_ROWS``), ``scaled_dot_product_attention``'s
              (a yardstick the port never calls) and the card's bound;
3. backward — B2a+B2b and B3 (the backward kernels) and B4 (in-kernel
              dropout) vs ``flash_attention_bwd_reference`` with the
              ``philox_keep_mask`` mask, fp32 (TF32 off) and bf16: the
              buckets on fused-QKV views, causal and not, a fully masked
              batch row (exactly zero grads, also at s=1024), masked keys
              (exactly zero dk, dv), ragged s (65: one row past a 64-row
              tile), kv_len != s, causal with kv_len > s, kv_len 201
              under dropout, d=128 (at s=1024 on fused-QKV views),
              dropout 0.1; two runs bitwise equal; B4's mask read back
              from the fp32 and the bf16 B1 equal to the plain version's
              with a binomial keep rate; B1+B4 (two runs bitwise
              equal), B2a and B2b again at GPT-2-medium's training
              attention (b=8, s=1024, bf16, dropout 0.1), B3 at the
              train-parity phase's, and B1+B3 at the BERT train phase's
              (b=64 and b=8, s=128, and its last layer's 21 gathered rows
              against 128 keys); device times at the training attentions
              beside the plain version's, SDPA's (forward and backward,
              with and without dropout) and the bound, B1 and B2a+B2b
              with and without dropout with the spread of their 20
              repeats and the SM clock and power draw before and after,
              B1 at BERT's b=64 beside SDPA's forward, and B3 (bf16 on
              the tensor cores) against B2a+B2b at BERT's shapes on one
              precomputed Δ and with Δ, beside SDPA's backward and the
              bound: ``use_fused_backward``'s bf16 rule must take B3
              exactly where it measured faster;
4. serve    — GPT-2-medium, bf16, random weights from a fixed numpy seed,
              16 staggered requests; every request gets its 32 tokens and
              B1 runs once per layer per prefill;
5. parity   — the same GPT-2-medium in fp32 served on the card and on the
              CPU: greedy tokens must agree;
6. train    — GPT-2-medium (24 layers, hidden 1024, vocab 50304), seq
              1024, micro-batch 8, dropout 0.1, Lamb, ZeRO-2, bf16: 2
              warm-up and 5 timed steps; finite, falling losses, one
              B1, B2a and B2b launch per layer per step; step ms,
              samples/s, tokens/s, MFU, peak memory;
7. train parity — 2 layers at GPT-2-medium width, fp32, seq 128, Adam +
              WarmupLR, accumulation 2, clipping 1.0: 3 steps on the card
              (through B3) and on the CPU agree to rtol 1e-3;
8. sparse kernel — B5a and B5b (block-sparse flash forward and backward;
              in bf16 on B6's tensor-core kernels at G = 1, in fp32
              scalar) vs ``flash_block_sparse_reference``
              and ``flash_block_sparse_bwd_reference``, fp32 (TF32 off)
              and bf16, on fused-QKV views, over ten layouts; two runs
              bitwise equal; device times at the sparse training
              attention (b=2, h=16, s=4096, d=64, bf16) beside the plain
              versions', SDPA's with the layout as a boolean mask and
              the bound, and dense B1 and B2a+B2b at the same shape;
              B5a's kernel and B5b's two in their launch order
              (longest blocks first) against grid order, in turns, with
              bitwise-equal outputs; and "auto" at 128- and 16-row
              blocks and q_agg=2 at 256 launch B6, not B5;
9. sparse train — GPT-2-medium with ``attn_impl="sparse"`` (Fixed
              unidirectional, 256-row blocks), 4096 positions, seq 4096,
              micro-batch 2, dropout 0.1, Lamb, ZeRO-2, bf16: 2 warm-up
              and 3 timed steps; finite, falling losses, one B5a and one
              B5b launch per layer per step and no other;
10. sparse train parity — 2 layers at GPT-2-medium width, fp32, seq 1024,
              256-row blocks, dropout 0: 3 steps on the card (B5a, B5b)
              and on the CPU (the gather path) agree to rtol 1e-3;
11. agg kernel — B6a, B6b and B6c (the G×G super-tile kernels; bf16
              on the tensor cores, fp32 scalar) vs
              ``flash_block_sparse_agg_reference`` and
              ``flash_block_sparse_agg_bwd_reference`` and vs B5 on the
              same inputs, fp32 (TF32 off) and bf16, fused-QKV views:
              the BERT train and parity layouts, BigBird at blk 64,
              Fixed at blk 16, blk 24 at G=3, blk 256 at G=2, a per-head
              layout with an empty super-row (out and dq exactly 0, lse
              NEG_INF) and an empty row inside an active one (lse
              MAX_FLOOR), d=128, G=5, causal and not; dq, dk and dv
              exactly 0 where no pair is seen; two runs bitwise equal;
              device times at the BERT sparse attention (b=2, h=16,
              s=4096, d=64, bf16) beside the plain versions', SDPA's
              with the layout as a boolean mask and the bound, with the
              spread of the 20 repeats and the SM clock and power draw
              before and after; B6b and B6c in their launch order
              (longest blocks first) against grid order, in turns, with
              bitwise-equal grads; and B6 against B5 at 128-, 64- and
              16-row blocks;
12. bert train — BERT-large (24 layers, hidden 1024, 16 heads, vocab
              30528), seq 128, micro-batch 64, attention mask of ones,
              MLM gather of 20 + NSP, dropout 0.1, Lamb, ZeRO-2, bf16: 2
              warm-up and 5 timed steps; finite, falling losses, B1 and
              one backward per layer per step (B3 or B2a+B2b, as
              ``use_fused_backward`` picks for bf16); step ms,
              samples/s, MFU, peak memory;
13. bert sparse train — the same model with 4096 positions and
              ``attn_impl="sparse"`` (Fixed bidirectional, 128-row
              blocks: G = 4), seq 4096, micro-batch 2, no attention mask,
              MLM 640 + NSP: 2 warm-up and 3 timed steps; finite, falling
              losses, exactly one B6a, B6b and B6c per layer per step and
              no other kernel; tokens/s, peak memory;
14. bert parity — 2 layers at BERT-large width, fp32, dropout 0: dense
              at seq 128 with padding and the MLM gather (B1, B3), and
              sparse at seq 1024 in 128-row blocks (B6 on the card, the
              gather path on the CPU); 3 steps on the card and on the CPU
              agree to rtol 1e-3;
15. checkpoint — GPT-2-medium at full width and depth on phase 6's
              config plus WarmupLR and a dataloader over 6 distinct
              micro-batches (numpy seed 0): run A takes 3 steps, saves
              asynchronously (4.97 GB, under ``build/`` in the
              checkout, which needs 12 GB free; deleted at the end) and
              takes 3 more while the commit runs; run B, a fresh engine
              from other weights, loads it strictly and takes 3 steps.
              ``verify_checkpoint`` ok, the JAX package's keys and byte
              sizes, the model states decoding to run A's step-3 bf16
              params bitwise, run B's losses and final master bitwise
              run A's, one B1, B2a and B2b a layer a step in both runs;
              the file sizes, the blocking snapshot ms, the commit s,
              the checksum algorithm, the load s and the step ms with
              the commit in flight beside phase 6's; the directory stays
              for phase 20;

16. fp16 kernel — B1, B2a, B2b and B3 in fp16 (the tensor-core kernels'
              fp16 instantiations), B4 through dropout 0.1, against their
              plain versions: B1+B2a+B2b at GPT-2-medium's training
              attention (fused QKV views) and B1+B3 at BERT's (b=64,
              s=128, key mask), at bf16's tolerances; device times beside
              the bf16 kernels' of phase 3, the bound (989 TFLOP/s fp16),
              the plain versions' and SDPA's in fp16; B3 against B2a+B2b
              at BERT's shape (``use_fused_backward``'s fp16 rule must
              take B3 exactly where it measured faster); an inf in dO
              and a NaN in q give non-finite grads, out and lse in
              exactly the plain version's (batch, head) slices;
17. fp16 train — phase 6's GPT-2-medium in fp16 under DeepSpeed's
              default dynamic scaler (scale 2^32, window 1000, hysteresis
              2, min 1): steps until the scale settles (3 applied in a
              row), the scale trace, then 2 warm-up and 5 timed steps;
              finite, falling losses, one fp16 B1, B2a, B2b a layer a
              step and no other attention launch; step ms, MFU and peak
              memory beside phase 6's;
18. fp16 bert train — phase 12's BERT-large the same way: one fp16 B1
              and B3 a layer a step; beside phase 12's;
19. fp16 parity — 2 layers at GPT-2-medium width (vocab cut to 4096,
              one 32-token sequence a step: the host's fp16 matmuls are
              slow), fp16 from scale 2^16, an inf in one compute
              parameter before step 3:
              card and CPU skip the same step with the same scale trace,
              applied losses to rtol 1e-2;
20. rollback — a fresh GPT-2-medium (bf16, resilience policy rollback,
              patience 2, phase 15's checkpoint dir) with one master
              element set to inf: two skipped steps, a rollback to
              global_step3 (its wall time beside phase 15's load), then
              3 steps bitwise equal to phase 15's run A;
21. remat    — phase 6's GPT-2-medium under the
              ``activation_checkpointing`` config block, 5 steps each on
              one batch: (a) remat alone, losses and the master after
              every step bitwise the run without it, B1 (B4 inside)
              twice a layer a step (forward and recompute); (b) with
              ``loss_chunk`` 128, the first loss within rtol 1e-5 of the
              full-logits one; (c) with ``cpu_checkpointing`` too,
              losses bitwise (b)'s; (d) micro-batch 32 (which the step
              without remat cannot hold in 80 GB), 2 warm-up and 3 timed
              steps; step ms, tokens/s, MFU (recompute not counted) and
              peak memory of each beside the run without remat;
22. bert pld — phase 12's BERT-large under remat and Progressive Layer
              Drop (θ̄ 0.5, γ 0.001, DeepSpeed's bing_bert tutorial): 2
              warm-up and 5 timed steps, θ on its schedule after each,
              B1 twice a layer a step at 128 rows (PLD turns the MLM
              query gather off); without the gather, PLD at θ = 1 is
              bitwise the run without PLD over 3 steps;
23. squad    — BERT-large SQuAD fine-tuning (``BertForQuestionAnsweringTPU``,
              BingBertSquad's seq 384, batch 24, Adam lr 3e-5, bf16,
              dropout 0.1), prompts padded from random lengths in
              [128, 384] (ragged key padding through B1, B2a, B2b), 2
              rows with answers past the window, which the loss ignores:
              2 warm-up and 5 timed steps;
24. mnli     — BERT-large sequence classification (3 labels, seq 128,
              batch 32, padded from random lengths in [32, 128]) through
              B1 and B3: 2 warm-up and 3 timed steps;
25. remat parity — 2 layers at BERT-large width, fp32, seq 128 with
              padding and the MLM gather: remat, each memory knob, PLD
              at θ 0 and 1, and the QA and MNLI heads under remat: the
              card against the CPU (loss rtol 1e-3, each gradient to
              1e-3 of its largest element), and, with dropout 0.1 on the
              card, each bitwise the model without it;
26. offload parity — phase 6's GPT-2-medium with Adam lr 1e-4 (the
              optimizer of bench.py's offload legs) under
              ``cpu_offload``, ``offload_chunk_mb`` 512 (3 chunks, the
              last ragged), 5 steps each: losses and master bitwise the
              run without offload, prefetch depth 1 against 2 bitwise,
              the bf16 SR host state at depth 1 against 2 bitwise; B1,
              B2a, B2b and B4 a step as phase 6; every host buffer
              pinned;
27. offload large — bench.py's GPT-2-large offload leg
              (``bench.py:514-526``: 36 layers, hidden 1280, seq 1024,
              batch 4, dropout 0, remat, ``loss_chunk`` 256, Adam lr
              1e-4, ZeRO-2, bf16): (a) no offload, (b) fp32 host state,
              (c) bf16 SR, (d) bf16 with error feedback, (e)
              DeepSpeedCPUAdam; 2 warm-up and 5 timed steps each,
              finite and falling; step ms (median, spread), device peak,
              pinned bytes, host-state bytes a step, the stream's H2D
              and D2H GB/s and its wall against the sum of its copies,
              (e)'s host-kernel ms and its two ways back for the params;
              each offload row's peak below (a)'s; then the host kernel
              on (e)'s pinned buffers against its plain version, with
              the host's copy rate for its bound;
28. offload xl — bench.py's GPT-2-xl leg (``bench.py:589-612``: 1.56 B
              parameters, ``offload_gradients``, bf16, remat,
              ``loss_chunk`` 256, batch 4), after ``MemAvailable``: 2
              warm-up and 3 timed steps;
29. offload parity cpu — 2 layers at GPT-2-medium width, fp32, fp32
              streamed offload in 1 MB chunks: 10 steps on the card
              within rtol 1e-3 of the CPU's;
30. dp       — ``torch.distributed`` on NCCL at world size 1 through a
              ``file://`` store under ``build/`` (the NCCL version
              printed); phase 6's GPT-2-medium and phase 12's BERT-large
              through ``initialize(mesh=make_mesh({"data": 1}))``, the
              ZeRO-2 sharded path (reduce-scatter of the gradient, the
              rank's rows of the master and Lamb state, all-gather of
              the bf16 params), 2 + 3 steps each: losses bitwise the
              first five of phases 6 and 12, the same attention launches
              a step, 1 reduce-scatter, 2 all-reduces and 1 all-gather a
              step, their bytes, and the exchange's device ms (the
              collectives replayed on the engine's buffers) beside the
              step ms; then the tiny GPT-2 at dp=2 on two gloo CPU
              processes against one rank on the same global batches
              (losses to rtol 1e-5, the master's update to 1e-4), which
              checks this machine's torch build.

Phases 9, 10, 13 and 14 go through the layer, whose ``q_agg="auto"``
follows the JAX package: G = 1 at 256-row layout blocks (the work-list
kernels B5a/B5b replace) and G = 4 at 128 (the super-tile kernels B6a,
B6b, B6c replace).  The bf16 B5b launches the super-tile backward
kernels at G = 1 through its own wrapper and counter.

Then one ``{"kernels": [...], "host_kernels": [...]}`` JSON line (the
host C++ kernel of DeepSpeedCPUAdam apart from the CUDA kernels), the
card's name and power limit,
and last the line ``{"ok": true, "device": {...}}``.  With ``--out PATH``
the per-case numbers also go to PATH as JSON.  Needs one card and no
network; imports nothing of JAX.
"""

import argparse
import gc
import json
import math
import multiprocessing
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

import deepspeed_tpu_torch
from deepspeed_tpu_torch import checkpoint as ckpt
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models.bert import (
    BertConfig, BertForPreTraining, BertForQuestionAnsweringTPU,
    BertForSequenceClassificationTPU)
from deepspeed_tpu_torch.models.bert import random_params as bert_params
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.adam import cpu_adam
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_block_sparse as fbs
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, FixedSparsityConfig)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer.attention import (
    FLASH_MIN_ROWS, key_padding_to_additive, reference_attention,
    takes_flash)
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_bwd_fused, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_reference, philox_keep_mask)
from deepspeed_tpu_torch.parallel import DATA_AXIS, make_mesh
from deepspeed_tpu_torch.utils.distributed import init_distributed
from deepspeed_tpu_torch.utils.params import params_from_numpy, tree_leaves

DEVICE = torch.device("cuda")
# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
# fp16 rounds where bf16 does (P before P·V, the outputs), with three
# more mantissa bits: held to bf16's bounds
TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
# bf16 B1's lse against the plain version's, absolute plus relative: both
# take fp32 scores of the same bf16 operands, so only the summation order
# and the exponential differ; a base-2 slip or a wrong running max would
# pass 2e-2 but not this
BF16_LSE_TOL = 1e-4
BUCKETS = (128, 256, 512, 1024)
SEED = 0
CSRC = "deepspeed_tpu_torch/csrc/transformer/"
REF = "deepspeed_tpu/ops/transformer/flash_attention.py"
FLASH_SOURCE = CSRC + "flash_attention_fwd.cu"
FLASH_REPLACES = REF + ":183"
# the backward kernels' grads: fp32 at the flash tests' grad tolerance
# (tests/unit/test_flash_attention.py); in bf16 kernel and plain version
# round dS and P to bf16 at the same points, but after fp32 sums taken in
# another order, which can flip one rounding (2^-8 relative) of a term
GRAD_TOLS = {torch.float32: 5e-4, torch.bfloat16: 1e-2,
             torch.float16: 1e-2}
# GPT-2-medium's training attention: b=8, h=16, s=1024, d=64, causal
TRAIN_ATTN = (8, 16, 1024, 64)
DROPOUT = 0.1
# the sparse training attention: b=2, h=16, s=4096, d=64 (the 8192 tokens
# a step of the dense train phase), under SPARSE_LAYOUT
SPARSE_ATTN = (2, 16, 4096, 64)
SPARSE_LAYOUT = dict(num_heads=16, block=256, num_local_blocks=4,
                     num_global_blocks=1, attention="unidirectional")
# the sparse train-parity phase's: seq 1024 in four such blocks
PARITY_LAYOUT = dict(SPARSE_LAYOUT, num_local_blocks=2)
PARITY_SEQ = 1024
SPARSE_REF = "deepspeed_tpu/ops/sparse_attention/flash_block_sparse.py"
AGG_SOURCE = "deepspeed_tpu_torch/csrc/sparse_attention/" \
    "flash_block_sparse_agg.cu"
# BERT-large pretraining, bench.py's headline leg (bench.py:249-347):
# seq 128, bing_bert's max_predictions_per_seq 20 (bench.py:291), the
# vocab padded to 30528; micro-batch 64 (8192 tokens, as the other train
# phases)
BERT_SEQ, BERT_BATCH, BERT_PRED, BERT_VOCAB = 128, 64, 20, 30528
# the sparse BERT phase: seq 4096, micro-batch 2 (8192 tokens), the
# bing_bert 20/128 label ratio, and the reference tutorial's Fixed BERT
# layout with its block moved from 16 to 128 rows, where the JAX layer's
# q_agg="auto" takes G = 4 and runs the super-tile kernels B6
BERT_SPARSE_PRED = 640
BERT_SPARSE_LAYOUT = dict(num_heads=16, block=128,
                          different_layout_per_head=True,
                          num_local_blocks=4, num_global_blocks=1,
                          attention="bidirectional",
                          num_different_global_patterns=4)
BERT_PARITY_SEQ = 1024
# ~10 ms of spinning at the H100's clock, doubled where the host needs
# longer to queue a timed run
SPIN_CYCLES = 20_000_000


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_times(fn, calls=10, repeats=20, warmup=3):
    """Device time per call, in ms, of each of ``repeats`` runs of
    ``calls`` back-to-back calls between two CUDA events.  A spin kernel
    holds the stream until the host has queued the whole run, so no host
    time is in it; a run whose start event already fired when its last
    call was queued is retried with a longer spin."""
    for _ in range(warmup):
        fn()
    spin = SPIN_CYCLES
    times = []
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            times.append(start.elapsed_time(end) / calls)
        else:
            spin *= 2
            check(spin <= 64 * SPIN_CYCLES, "the host cannot queue a "
                  "timed run within the spin")
    return times


def device_ms(fn, calls=10, repeats=20, warmup=3):
    """The median of :func:`device_times`."""
    return statistics.median(device_times(fn, calls, repeats, warmup))


def clocks_line():
    """The card's SM clock, its maximum and the power draw, as
    ``nvidia-smi`` reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def visible_pairs(q, k, mask, causal):
    """(query, key) pairs the masks leave visible, over the batch (the
    work this data needs; heads not counted)."""
    b, s = q.shape[:2]
    kv_len = k.shape[1]
    vis = (torch.ones(b, kv_len) if mask is None
           else (mask.float().cpu() > 0).float())
    if causal:
        rows = torch.arange(s)[:, None] >= torch.arange(kv_len)[None, :]
        return float((rows[None].float() * vis[:, None, :]).sum())
    return float(vis.sum()) * s


def bound_ms(nbytes, flops, dtype):
    """Least time (ms) and what bounds it: bytes over the memory rate
    against operations over the peak rate for the dtype."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def attention_bound(q, k, mask, causal):
    """Least time (ms) the card could take for one flash forward, and
    what bounds it: each input read once and each output written once
    over the memory rate, against the multiply-adds this data needs
    (visible keys only) over the peak rate for the dtype."""
    b, s, h, d = q.shape
    kv_len = k.shape[1]
    esize = q.element_size()
    nbytes = (2 * b * s * h * d + 2 * b * kv_len * h * d) * esize \
        + b * h * s * 4 + (0 if mask is None else b * kv_len * 4)
    flops = 4.0 * d * h * visible_pairs(q, k, mask, causal)
    return bound_ms(nbytes, flops, q.dtype)


def backward_bound(kind, q, k, mask, causal):
    """The bound of one backward launch.  Reads q, k, v, dO once (and lse,
    Δ, the mask); writes dq (B2a), dk and dv (B2b) or all three (B3).
    Flops per visible pair: Q·Kᵀ and dO·Vᵀ (2d each) plus dS·K (B2a),
    Pᵀ·dO and dSᵀ·Q (B2b), or all three products (B3)."""
    b, s, h, d = q.shape
    kv_len = k.shape[1]
    esize = q.element_size()
    q_bytes, kv_bytes = b * s * h * d * esize, b * kv_len * h * d * esize
    out_bytes = {"dq": q_bytes, "dkv": 2 * kv_bytes,
                 "fused": q_bytes + 2 * kv_bytes}[kind]
    nbytes = 2 * q_bytes + 2 * kv_bytes + 2 * b * h * s * 4 \
        + (0 if mask is None else b * kv_len * 4) + out_bytes
    per_pair = {"dq": 6, "dkv": 8, "fused": 10}[kind] * d
    return bound_ms(nbytes, per_pair * h * visible_pairs(q, k, mask, causal),
                    q.dtype)


# ------------------------------------------------------------------ kernel
def kernel_cases():
    """(label, b, h, s, kv_len, d, causal, mask kind, fused, dropout rate).
    The bucket cases are the prefill's: q, k and v are strided views of
    one fused [b, s, 3, h, d] projection, as ``inference/model.py`` passes
    them."""
    cases = [(f"bucket{s}", 1, 16, s, s, 64, True, "tail", True, 0.0)
             for s in BUCKETS]
    cases += [("b2_full_masked_row", 2, 16, 256, 256, 64, False, "row",
               False, 0.0),
              ("ragged_s300", 1, 16, 300, 300, 64, True, "tail", False, 0.0),
              ("kv_len_ne_s", 2, 8, 256, 384, 64, False, "tail", False, 0.0),
              ("kv_len_ne_s_causal", 1, 8, 200, 320, 64, True, "none",
               False, 0.0),
              ("d128", 1, 8, 512, 512, 128, True, "tail", False, 0.0),
              # edges of the bf16 kernel's 64-row tiles
              ("s65", 1, 16, 65, 65, 64, True, "tail", False, 0.0),
              ("dropout_kv201", 1, 8, 100, 201, 64, False, "tail", False,
               DROPOUT),
              ("causal_kv_gt_s", 1, 8, 128, 256, 64, True, "none", False,
               0.0),
              ("d128_s1024", 1, 16, 1024, 1024, 128, True, "none", True,
               0.0),
              ("full_masked_row_s1024", 2, 16, 1024, 1024, 64, False, "row",
               False, 0.0),
              # BERT's last layer: its 21 gathered rows against 128 keys
              ("bert_gathered_s21", BERT_BATCH, 16, BERT_PRED + 1, BERT_SEQ,
               64, False, "tail", False, DROPOUT)]
    return cases


def make_case(b, h, s, kv_len, d, mask_kind, fused, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if fused:
        qkv = torch.randn(b, s, 3, h, d, generator=g).to(DEVICE, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        check(q.stride(1) == 3 * h * d and not q.is_contiguous(),
              "fused case: q is not a strided view of the projection")
    else:
        q, k, v = (torch.randn(b, n, h, d, generator=g).to(DEVICE, dtype)
                   for n in (s, kv_len, kv_len))
    mask = None
    if mask_kind != "none":
        mask = torch.ones(b, kv_len)
        if mask_kind == "tail":   # a padded prompt: the last fifth hidden
            mask[:, kv_len - kv_len // 5:] = 0.0
        else:                     # batch row 1 sees no key at all
            mask[1] = 0.0
        mask = mask.to(DEVICE)
    return q, k, v, mask


def phase_kernel(card, results):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("kernel: fp32 matmuls in full fp32 (allow_tf32 False for "
          "matmul and cuDNN); tolerances fp32 2e-5, bf16 2e-2 (P is "
          "rounded to bf16 before P·V, as on the TPU), bf16 lse 1e-4")
    max_err = 0.0
    timings = {}
    for i, (label, b, h, s, kv_len, d, causal, kind, fused, rate) in \
            enumerate(kernel_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = make_case(b, h, s, kv_len, d, kind, fused,
                                      dtype, SEED + i)
            seed = seed_words(SEED + 400 + i) if rate else None
            out, lse = flash_attention_fwd(q, k, v, mask, causal, rate, seed)
            again = flash_attention_fwd(q, k, v, mask, causal, rate, seed)
            torch.cuda.synchronize()
            check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                  f"{label}: two runs are not bitwise equal")
            keep, inv_keep = plain_keep(q, k, rate, seed)
            ref_out, ref_lse = flash_attention_reference(q, k, v, mask,
                                                         causal, keep,
                                                         inv_keep)
            del keep
            check(out.shape == ref_out.shape and lse.shape == ref_lse.shape,
                  f"{label}: shapes {out.shape}/{lse.shape}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"{label}: non-finite output")
            tol = TOLS[dtype]
            torch.testing.assert_close(out.float(), ref_out.float(),
                                       atol=tol, rtol=tol)
            torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
            if dtype == torch.bfloat16:
                torch.testing.assert_close(
                    lse, ref_lse, atol=BF16_LSE_TOL, rtol=BF16_LSE_TOL,
                    msg=lambda m: f"{label} bf16 lse: {m}")
            err_out = float((out.float() - ref_out.float()).abs().max())
            err_lse = float((lse - ref_lse).abs().max())
            max_err = max(max_err, err_out)
            if kind == "row":   # batch row 1 sees no key at all
                check(bool((out[1] == 0).all()), "masked row is not zero")
                check(bool((lse.view(b, h, s)[1] == fa.MAX_FLOOR).all()),
                      "masked row's lse is not MAX_FLOOR")
            row = {"case": label, "dtype": str(dtype).split(".")[-1],
                   "b": b, "h": h, "s": s, "kv_len": kv_len, "d": d,
                   "causal": causal, "fused_qkv_views": fused,
                   "dropout": rate, "max_abs_err_out": err_out,
                   "max_abs_err_lse": err_lse}
            print(f"kernel {label} {row['dtype']}: max |out-plain| "
                  f"{err_out:.3g}, max |lse-plain| {err_lse:.3g}, "
                  f"bitwise-repeatable ok")
            if dtype == torch.bfloat16 and label.startswith("bucket"):
                bound, bound_by = attention_bound(q, k, mask, causal)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                # the dispatch's other path for a prefill:
                # reference_attention over the padding as an additive mask
                additive = key_padding_to_additive(mask)[:, None, None, :]
                row.update(
                    kernel_ms=device_ms(lambda: flash_attention_fwd(
                        q, k, v, mask, causal=causal)),
                    plain_ms=device_ms(lambda: flash_attention_reference(
                        q, k, v, mask, causal)),
                    reference_attention_ms=device_ms(
                        lambda: reference_attention(q, k, v, mask=additive,
                                                    causal=causal)),
                    library_ms=device_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True)),
                    bound_ms=bound, bound_by=bound_by,
                    takes_flash=takes_flash("cuda", s, False, False))
                timings[s] = row
                print(f"bucket s={s} (b=1 h=16 d=64 causal bf16, fused "
                      f"QKV views): "
                      f"kernel_ms={row['kernel_ms']:.4f} "
                      f"plain_ms={row['plain_ms']:.4f} "
                      f"reference_attention_ms="
                      f"{row['reference_attention_ms']:.4f} "
                      f"library_ms={row['library_ms']:.4f} "
                      f"bound_ms={bound:.5f} ({bound_by}); the dispatch "
                      f"(FLASH_MIN_ROWS={FLASH_MIN_ROWS}) takes "
                      f"{'B1' if row['takes_flash'] else 'reference_attention'}"
                      f" [{card}]")
            results["kernel"].append(row)
    return max_err, timings


# ---------------------------------------------------------------- backward
def seed_words(seed):
    """Two int32 dropout seed words on the card."""
    return torch.tensor([seed, 7919 * seed + 1], dtype=torch.int32,
                        device=DEVICE)


def kernel_chain(q, k, v, dout, mask, causal, rate, seed, fused):
    """out, lse by B1 and dq, dk, dv by B3 or by B2a then B2b."""
    out, lse = flash_attention_fwd(q, k, v, mask, causal, rate, seed)
    if fused:
        grads = flash_attention_bwd_fused(q, k, v, out, lse, dout, mask,
                                          causal, rate, seed)
    else:
        dq = flash_attention_bwd_dq(q, k, v, out, lse, dout, mask, causal,
                                    rate, seed)
        grads = (dq,) + flash_attention_bwd_dkv(q, k, v, out, lse, dout,
                                                mask, causal, rate, seed)
    return (out, lse) + tuple(grads)


def plain_keep(q, k, rate, seed):
    if not rate:
        return None, 1.0
    b, s, h, _ = q.shape
    keep = philox_keep_mask(seed, b * h, s, k.shape[1], rate)
    return keep.view(b, h, s, k.shape[1]), fa.dropout_thresh(rate)[1]


def backward_cases():
    """(label, b, h, s, kv_len, d, causal, mask kind, fused QKV views,
    dropout rate)."""
    cases = [(f"bucket{s}", 1, 16, s, s, 64, True, "tail", True, 0.0)
             for s in BUCKETS]
    cases += [
        ("b2_full_masked_row", 2, 16, 256, 256, 64, False, "row", False, 0.0),
        ("b3_full_masked_row", 2, 16, 128, 128, 64, False, "row", False, 0.0),
        # the train-parity phase's attention, which takes B3
        ("train_parity_shape", 2, 16, 128, 128, 64, True, "none", True, 0.0),
        ("ragged_s300", 1, 16, 300, 300, 64, True, "tail", False, 0.0),
        ("kv_len_ne_s", 2, 8, 256, 384, 64, False, "tail", False, 0.0),
        ("kv_len_ne_s_causal", 1, 8, 200, 320, 64, True, "none", False, 0.0),
        ("d128", 1, 8, 512, 512, 128, True, "tail", False, 0.0),
        ("d128_b3", 2, 8, 64, 64, 128, True, "tail", False, 0.0),
        ("dropout_s1024", 1, 16, 1024, 1024, 64, True, "none", True, DROPOUT),
        ("dropout_s128", 2, 16, 128, 128, 64, True, "tail", True, DROPOUT),
        ("dropout_kv_ne_s", 1, 8, 200, 320, 64, False, "tail", False,
         DROPOUT),
        # edges of the bf16 kernels' 64-row tiles
        ("s65", 1, 16, 65, 65, 64, True, "tail", False, 0.0),
        ("dropout_kv201", 1, 8, 100, 201, 64, False, "tail", False,
         DROPOUT),
        ("causal_kv_gt_s", 1, 8, 128, 256, 64, True, "none", False, 0.0),
        ("d128_s1024", 1, 16, 1024, 1024, 128, True, "none", True, 0.0),
        ("full_masked_row_s1024", 2, 16, 1024, 1024, 64, False, "row",
         False, 0.0)]
    return cases


def check_backward_case(row, label, path, dtype, q, k, v, dout, mask,
                        causal, rate, seed, kind):
    fused = path == "b3"
    got = kernel_chain(q, k, v, dout, mask, causal, rate, seed, fused)
    torch.cuda.synchronize()
    again = kernel_chain(q, k, v, dout, mask, causal, rate, seed, fused)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{label} {path}: two runs are not bitwise equal")
    out, lse, dq, dk, dv = got
    keep, inv_keep = plain_keep(q, k, rate, seed)
    ref_out, ref_lse = flash_attention_reference(q, k, v, mask, causal, keep,
                                                 inv_keep)
    # the plain backward takes the kernel's own out and lse, so the grads
    # measure the backward kernels alone
    ref = flash_attention_bwd_reference(q, k, v, out, lse, dout, mask,
                                        causal, keep, inv_keep)
    tol, gtol = TOLS[dtype], GRAD_TOLS[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    errs = {}
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        check(bool(torch.isfinite(g.float()).all()),
              f"{label} {path}: non-finite {name}")
        torch.testing.assert_close(g.float(), r.float(), atol=gtol,
                                   rtol=gtol, msg=lambda m: f"{label} {path} "
                                   f"{name}: {m}")
        errs[name] = float((g.float() - r.float()).abs().max())
    if kind == "row":   # batch row 1 sees no key: exactly zero grads
        check(all(bool((g[1] == 0).all()) for g in (dq, dk, dv)),
              f"{label} {path}: the fully masked row has non-zero grads")
    if kind == "tail":  # padded keys get exactly zero dk and dv
        kv_len = k.shape[1]
        check(bool((dk[:, kv_len - kv_len // 5:] == 0).all())
              and bool((dv[:, kv_len - kv_len // 5:] == 0).all()),
              f"{label} {path}: masked keys have non-zero dk/dv")
    row[path] = dict(errs, max_abs_err_out=float(
        (out.float() - ref_out.float()).abs().max()))
    print(f"backward {label} {path} {row['dtype']}: max |grad-plain| "
          f"dq {errs['dq']:.3g} dk {errs['dk']:.3g} dv {errs['dv']:.3g}, "
          f"bitwise-repeatable ok")
    return max(errs.values())


def check_keep_mask(card, results):
    """B4's keep mask read back from B1 itself, from the fp32 kernel and
    from the bf16 one: with q = 0 every score is 0, and with V the
    identity over kv_len = head_dim keys each output element is
    keep·inv_keep/kv_len.  The mask must equal the plain version's, keep
    the binomial rate within 5 sigma, and change with the seed."""
    b, h, s, d = 1, 16, 4096, 64
    thresh, _ = fa.dropout_thresh(DROPOUT)
    p_keep = 1.0 - thresh / 2.0 ** 32
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q = torch.zeros(b, s, h, d, device=DEVICE, dtype=dtype)
        k = torch.randn(b, d, h, d, device=DEVICE).to(dtype)
        v = torch.eye(d, device=DEVICE)[None, :, None, :].expand(
            b, d, h, d).contiguous().to(dtype)
        masks = []
        for seed in (11, 12):
            out, _ = flash_attention_fwd(q, k, v, None, False, DROPOUT,
                                         seed_words(seed))
            kept = out.permute(0, 2, 1, 3).reshape(b * h, s, d) > 0
            check(torch.equal(kept, philox_keep_mask(seed_words(seed), b * h,
                                                     s, d, DROPOUT)),
                  f"B4: the {name} kernel's keep mask differs from "
                  f"philox_keep_mask")
            masks.append(kept)
        check(not torch.equal(masks[0], masks[1]), "B4: another seed gives "
              "the same mask")
        n = masks[0].numel()
        rate = float(masks[0].float().mean())
        sigma = math.sqrt(p_keep * (1 - p_keep) / n)
        check(abs(rate - p_keep) <= 5 * sigma, f"B4: keep rate {rate} is "
              f"{abs(rate - p_keep) / sigma:.1f} sigma from {p_keep}")
        print(f"B4 keep mask from {name} B1 ({n} elements): equals the plain "
              f"version for two seeds, keep rate {rate:.6f} vs {p_keep:.6f} "
              f"({abs(rate - p_keep) / sigma:.2f} sigma) [{card}]")
        results["keep_mask" if dtype == torch.float32
                else f"keep_mask_{name}"] = {
            "elements": n, "keep_rate": rate, "expected": p_keep,
            "sigmas": abs(rate - p_keep) / sigma}


def check_train_shape(card, q, k, v, out, lse, dout, seed, plain_bwd,
                      max_err):
    """B1 with B4, then B2a and B2b, at the train phase's attention
    against their plain versions with the same Philox mask, at the bf16
    tolerances of the backward phase; the errors join ``max_err``."""
    again = flash_attention_fwd(q, k, v, None, True, DROPOUT, seed)
    check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
          "train shape: two B1 runs with dropout are not bitwise equal")
    del again
    keep, inv_keep = plain_keep(q, k, DROPOUT, seed)
    ref_out, ref_lse = flash_attention_reference(q, k, v, None, True, keep,
                                                 inv_keep)
    del keep
    tol, gtol = TOLS[torch.bfloat16], GRAD_TOLS[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=BF16_LSE_TOL,
                               rtol=BF16_LSE_TOL)
    errs = {"out": float((out.float() - ref_out.float()).abs().max()),
            "lse": float((lse - ref_lse).abs().max())}
    del ref_out, ref_lse
    args = (q, k, v, out, lse, dout, None, True, DROPOUT, seed)
    grads = (flash_attention_bwd_dq(*args),) + flash_attention_bwd_dkv(*args)
    for name, g, r in zip(("dq", "dk", "dv"), grads, plain_bwd()):
        check(bool(torch.isfinite(g.float()).all()),
              f"train shape: non-finite {name}")
        torch.testing.assert_close(g.float(), r.float(), atol=gtol,
                                   rtol=gtol, msg=lambda m: f"train shape "
                                   f"{name}: {m}")
        errs[name] = float((g.float() - r.float()).abs().max())
    grad_err = max(errs["dq"], errs["dk"], errs["dv"])
    max_err["b1_train"] = errs["out"]
    max_err["b2"] = max(max_err["b2"], grad_err)
    max_err["dropout"] = max(max_err["dropout"], grad_err, errs["out"])
    print(f"backward train shape (b=8 h=16 s=1024 d=64 causal bf16, fused "
          f"QKV views, dropout 0.1): B1+B4 max |out-plain| {errs['out']:.3g}"
          f" |lse-plain| {errs['lse']:.3g}, two runs bitwise equal; B2a+B2b "
          f"max |grad-plain| dq "
          f"{errs['dq']:.3g} dk {errs['dk']:.3g} dv {errs['dv']:.3g} ok "
          f"[{card}]")
    return errs


def time_backward(card, results, max_err):
    """Checks the kernels at GPT-2-medium's training attention (b=8,
    h=16, s=1024, d=64, causal, bf16, fused QKV views, dropout 0.1)
    against their plain versions, then takes device times at the shapes
    the main paths give the kernels: B1, B2a, B2b and B4 at that
    attention (B2a and B2b with and without dropout, the spread of their
    repeats, SDPA's forward and backward with and without dropout, the
    SM clock and power draw before and after), and B3 at the
    train-parity phase's (b=2, h=16, s=128, fp32, no dropout)."""
    b, h, s, d = TRAIN_ATTN
    g = torch.Generator().manual_seed(SEED + 5)
    qkv = torch.randn(b, s, 3, h, d, generator=g).to(DEVICE, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn(b, s, h, d, generator=g).to(DEVICE, torch.bfloat16)
    seed = seed_words(SEED + 6)
    out, lse = flash_attention_fwd(q, k, v, None, True, DROPOUT, seed)
    args = (q, k, v, out, lse, dout, None, True, DROPOUT, seed)

    def plain_bwd():
        keep, inv_keep = plain_keep(q, k, DROPOUT, seed)
        return flash_attention_bwd_reference(q, k, v, out, lse, dout, None,
                                             True, keep, inv_keep)

    results["train_shape_check"] = check_train_shape(
        card, q, k, v, out, lse, dout, seed, plain_bwd, max_err)
    clocks = {"before": clocks_line()}
    print(f"backward timing: clocks.sm, clocks.max.sm, power.draw before: "
          f"{clocks['before']} [{card}]")
    timings = {}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = dout.transpose(1, 2)
    sdpa = {}
    for rate in (0.0, DROPOUT):
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                dropout_p=rate)
        sdpa[rate] = device_ms(lambda: torch.autograd.grad(
            o_sdpa, (qt, kt, vt), dot, retain_graph=True))
        del o_sdpa
    plain_ms = device_ms(plain_bwd, calls=1, repeats=3, warmup=1)
    # the kernels alone: Δ once, outside the timed runs, as
    # flash_attention_bwd computes it once for both
    delta = fa._delta(out, dout)
    out0, lse0 = flash_attention_fwd(q, k, v, None, True)
    no_drop = (q, k, v, out0, lse0, dout, None, True, 0.0, None)
    delta0 = fa._delta(out0, dout)
    for kind, fn in (("dq", flash_attention_bwd_dq),
                     ("dkv", flash_attention_bwd_dkv)):
        bound, by = backward_bound(kind, q, k, None, True)
        times = device_times(lambda: fn(*args, delta=delta))
        timings[kind] = {"kernel_ms": statistics.median(times),
                         "kernel_ms_min": min(times),
                         "kernel_ms_max": max(times),
                         "kernel_ms_no_dropout": device_ms(
                             lambda: fn(*no_drop, delta=delta0)),
                         "plain_ms": plain_ms, "library_ms": sdpa[0.0],
                         "library_ms_dropout": sdpa[DROPOUT],
                         "bound_ms": bound, "bound_by": by}
    fwd_bound, fwd_by = attention_bound(q, k, None, True)
    fwd_clocks = {"before": clocks_line()}
    fwd_times = device_times(lambda: flash_attention_fwd(
        q, k, v, None, True, DROPOUT, seed))
    fwd_times0 = device_times(lambda: flash_attention_fwd(q, k, v, None,
                                                          True))
    fwd_clocks["after"] = clocks_line()
    timings["fwd_train"] = {
        "kernel_ms": statistics.median(fwd_times),
        "kernel_ms_min": min(fwd_times), "kernel_ms_max": max(fwd_times),
        "kernel_ms_no_dropout": statistics.median(fwd_times0),
        "kernel_ms_no_dropout_min": min(fwd_times0),
        "kernel_ms_no_dropout_max": max(fwd_times0),
        "plain_ms": device_ms(lambda: flash_attention_reference(
            q, k, v, None, True, *plain_keep(q, k, DROPOUT, seed)),
            calls=1, repeats=3, warmup=1),
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "library_ms_dropout": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, dropout_p=DROPOUT)),
        "bound_ms": fwd_bound, "bound_by": fwd_by, "clocks": fwd_clocks}

    def chain(rate):
        return lambda: kernel_chain(q, k, v, dout, None, True, rate, seed,
                                    False)

    with_dropout = device_ms(chain(DROPOUT), calls=5, repeats=10)
    without = device_ms(chain(0.0), calls=5, repeats=10)
    draws = h * visible_pairs(q, k, None, True) / 4
    # per draw: 10 Philox rounds of 2 mul-hi, 2 mul-lo, 4 xor, 2 adds,
    # then 4 compares, on the CUDA cores
    b4_bound = draws * 104 / PEAK_FLOPS[torch.float32] * 1e3
    timings["dropout"] = {
        "kernel_ms": with_dropout - without, "chain_ms": with_dropout,
        "chain_no_dropout_ms": without,
        "plain_ms": device_ms(lambda: philox_keep_mask(
            seed, b * h, s, s, DROPOUT), calls=1, repeats=3, warmup=1),
        "bound_ms": b4_bound, "bound_by": "operations", "library_ms": None}
    clocks["after"] = clocks_line()
    timings["clocks"] = clocks
    for name, row in timings.items():
        print(f"backward timing {name} (b=8 h=16 s=1024 d=64 causal bf16, "
              f"dropout 0.1): " + " ".join(
                  f"{key}={val:.5f}" if isinstance(val, float) else
                  f"{key}={val}" for key, val in row.items()) + f" [{card}]")
    dq_row, dkv_row = timings["dq"], timings["dkv"]
    no_drop_ms = (dq_row["kernel_ms_no_dropout"]
                  + dkv_row["kernel_ms_no_dropout"])
    print(f"backward timing B2a+B2b (b=8 h=16 s=1024 d=64 causal bf16, fused "
          f"QKV views): dropout 0.1 "
          f"{dq_row['kernel_ms'] + dkv_row['kernel_ms']:.5f} ms, no dropout "
          f"{no_drop_ms:.5f} ms; SDPA backward {sdpa[0.0]:.5f} ms, with dropout_p=0.1 "
          f"{sdpa[DROPOUT]:.5f} ms; plain {plain_ms:.5f} ms; bound "
          f"{dq_row['bound_ms'] + dkv_row['bound_ms']:.5f} ms; 20 repeats "
          f"B2a {dq_row['kernel_ms_min']:.5f}-{dq_row['kernel_ms_max']:.5f}, "
          f"B2b {dkv_row['kernel_ms_min']:.5f}-{dkv_row['kernel_ms_max']:.5f};"
          f" clocks.sm, clocks.max.sm, power.draw after: {clocks['after']} "
          f"[{card}]")
    # B3 at the train-parity phase's shape, the one main path (fp32) that
    # takes it; B3 against B2a+B2b in bf16: check_b3_bert_scale
    b3, h3, s3, d3 = 2, 16, 128, 64
    q3, k3, v3, do3 = (torch.randn(b3, s3, h3, d3, generator=g)
                       .to(DEVICE, torch.float32) for _ in range(4))
    o3, l3 = flash_attention_fwd(q3, k3, v3, None, True)
    a3 = (q3, k3, v3, o3, l3, do3, None, True)
    bound, by = backward_bound("fused", q3, k3, None, True)
    row = {"fused_ms": device_ms(lambda: flash_attention_bwd_fused(*a3)),
           "b2_ms": device_ms(lambda: b2_pair(*a3, 0.0, None)),
           "plain_ms": device_ms(lambda: flash_attention_bwd_reference(*a3),
                                 calls=2, repeats=5),
           "bound_ms": bound, "bound_by": by}
    qt3, kt3, vt3 = (x.transpose(1, 2).detach().requires_grad_()
                     for x in (q3, k3, v3))
    os3 = F.scaled_dot_product_attention(qt3, kt3, vt3, is_causal=True)
    dot3 = do3.transpose(1, 2)
    row["library_ms"] = device_ms(lambda: torch.autograd.grad(
        os3, (qt3, kt3, vt3), dot3, retain_graph=True))
    timings["b3_parity_fp32"] = row
    print(f"backward timing B3 vs B2a+B2b parity_fp32 (b={b3} h={h3} s={s3} "
          f"d={d3} causal fp32): " + " ".join(
              f"{key}={val:.5f}" if isinstance(val, float) else
              f"{key}={val}" for key, val in row.items()) + f" [{card}]")
    results["backward_timing"] = timings
    return timings


def b2_pair(q, k, v, out, lse, dout, mask, causal, rate, seed, delta=None):
    """B2a then B2b on one Δ, as ``flash_attention_bwd`` runs them (Δ
    computed here when not given)."""
    delta = fa._delta(out, dout) if delta is None else delta
    return (flash_attention_bwd_dq(q, k, v, out, lse, dout, mask, causal,
                                   rate, seed, delta),
            flash_attention_bwd_dkv(q, k, v, out, lse, dout, mask, causal,
                                    rate, seed, delta))


def check_b3_bert_scale(card, results, max_err):
    """B1 and B3 at the BERT train phase's attention (b=64, h=16, s=128,
    d=64, bf16, not causal, a key mask of ones, dropout 0.1), at its last
    layer's gathered queries (21 rows against 128 keys) and at b=8,
    against their plain versions with the same Philox mask; at all three
    B3's and B2a+B2b's device times on one precomputed Δ (the kernels
    alone) and with Δ computed inside the call, beside SDPA's backward
    (no dropout) and B3's bound: the times behind
    ``use_fused_backward``'s bf16 rule, which must take B3 exactly where
    it measured faster than B2a+B2b on the same Δ."""
    g = torch.Generator().manual_seed(SEED + 7)
    h, d = 16, 64
    seed = seed_words(SEED + 8)
    errs, row, dispatch = {}, {}, {}
    for label, b, s in (("s128", BERT_BATCH, BERT_SEQ),
                        ("gathered_s21", BERT_BATCH, BERT_PRED + 1),
                        ("s128_b8", 8, BERT_SEQ)):
        mask = torch.ones(b, BERT_SEQ, device=DEVICE)
        q = torch.randn(b, s, h, d, generator=g).to(DEVICE, torch.bfloat16)
        k, v = (torch.randn(b, BERT_SEQ, h, d, generator=g)
                .to(DEVICE, torch.bfloat16) for _ in range(2))
        dout = torch.randn(b, s, h, d, generator=g).to(DEVICE,
                                                       torch.bfloat16)
        check(fa.fused_backward_fits(d, s, BERT_SEQ, torch.bfloat16),
              f"B3 does not fit s={s} kv_len={BERT_SEQ}")
        out, lse, *grads = kernel_chain(q, k, v, dout, mask, False, DROPOUT,
                                        seed, True)
        keep, inv_keep = plain_keep(q, k, DROPOUT, seed)
        ref_out, _ = flash_attention_reference(q, k, v, mask, False, keep,
                                               inv_keep)
        ref = flash_attention_bwd_reference(q, k, v, out, lse, dout, mask,
                                            False, keep, inv_keep)
        tol, gtol = TOLS[torch.bfloat16], GRAD_TOLS[torch.bfloat16]
        torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                                   rtol=tol)
        for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
            torch.testing.assert_close(got.float(), want.float(), atol=gtol,
                                       rtol=gtol, msg=lambda m: f"B3 bert "
                                       f"{label} {name}: {m}")
            errs[f"{label}_{name}"] = float((got.float() - want.float())
                                            .abs().max())
        args = (q, k, v, out, lse, dout, mask, False, DROPOUT, seed)
        delta = fa._delta(out, dout)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qt, kt, vt)
        dot = dout.transpose(1, 2)
        bound, by = backward_bound("fused", q, k, mask, False)
        dispatch[label] = {
            "b": b, "s": s, "kv_len": BERT_SEQ,
            "b3_ms": device_ms(lambda: flash_attention_bwd_fused(
                *args, delta=delta)),
            "b2_ms": device_ms(lambda: b2_pair(*args, delta=delta)),
            "b3_ms_with_delta": device_ms(lambda: flash_attention_bwd_fused(
                *args)),
            "b2_ms_with_delta": device_ms(lambda: b2_pair(*args)),
            "library_ms": device_ms(lambda: torch.autograd.grad(
                o_sdpa, (qt, kt, vt), dot, retain_graph=True)),
            "bound_ms": bound, "bound_by": by,
            "rule_takes_b3": fa.use_fused_backward(d, s, BERT_SEQ,
                                                   torch.bfloat16)}
        del o_sdpa
        if label == "s128":
            t = dispatch[label]
            row = {"kernel_ms": t["b3_ms"],
                   "kernel_ms_with_delta": t["b3_ms_with_delta"],
                   "plain_ms": device_ms(lambda: flash_attention_bwd_reference(
                       q, k, v, out, lse, dout, mask, False, keep, inv_keep),
                       calls=2, repeats=5),
                   "library_ms": t["library_ms"], "bound_ms": bound,
                   "bound_by": by}
            # B1 at the BERT train phase's attention, beside SDPA's forward
            # with the same dropout rate (a key mask of ones is no mask)
            fwd_bound, fwd_by = attention_bound(q, k, mask, False)
            b1_row = {
                "kernel_ms": device_ms(lambda: flash_attention_fwd(
                    q, k, v, mask, False, DROPOUT, seed)),
                "plain_ms": device_ms(lambda: flash_attention_reference(
                    q, k, v, mask, False, keep, inv_keep), calls=2,
                    repeats=5),
                "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, dropout_p=DROPOUT)),
                "bound_ms": fwd_bound, "bound_by": fwd_by}
            print(f"B1 timing BERT (b={b} h=16 s={s} d=64 bf16, key mask, "
                  f"dropout 0.1): kernel_ms={b1_row['kernel_ms']:.5f} "
                  f"plain_ms={b1_row['plain_ms']:.5f} SDPA forward with "
                  f"dropout_p=0.1 {b1_row['library_ms']:.5f} "
                  f"bound_ms={fwd_bound:.5f} ({fwd_by}) [{card}]")
            results["b1_bert"] = b1_row
    max_err["b3"] = max(max_err["b3"], *errs.values())
    max_err["dropout"] = max(max_err["dropout"], *errs.values())
    print(f"backward B3 at BERT scale (h=16 d=64 bf16, key mask, dropout "
          f"0.1; s=128 at b=64 and b=8, and the gathered 21 rows against 128 "
          f"keys at b=64; times at b=64 s=128, on one precomputed Δ): "
          f"max |grad-plain| {max(errs.values()):.3g}; " + " ".join(
              f"{key}={val:.5f}" if isinstance(val, float) else
              f"{key}={val}" for key, val in row.items()) + f" [{card}]")
    for label, t in dispatch.items():
        print(f"backward dispatch {label} (b={t['b']} h=16 s={t['s']} "
              f"kv_len={t['kv_len']} d=64 bf16, key mask, dropout 0.1): on "
              f"one precomputed Δ B3 {t['b3_ms']:.5f} ms, B2a+B2b "
              f"{t['b2_ms']:.5f} ms; with Δ B3 {t['b3_ms_with_delta']:.5f} "
              f"ms, B2a+B2b {t['b2_ms_with_delta']:.5f} ms; SDPA backward "
              f"{t['library_ms']:.5f} ms; bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}); use_fused_backward takes "
              f"{'B3' if t['rule_takes_b3'] else 'B2a+B2b'} [{card}]")
        check(t["rule_takes_b3"] == (t["b3_ms"] < t["b2_ms"]),
              f"the bf16 backward rule takes "
              f"{'B3' if t['rule_takes_b3'] else 'B2a+B2b'} at {label}, "
              f"where B3 measured {t['b3_ms']:.5f} ms and B2a+B2b "
              f"{t['b2_ms']:.5f} ms")
    results["b3_bert"] = dict(row, errors=errs)
    results["dispatch"] = dispatch


def phase_backward(card, results):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("backward: fp32 with TF32 off, grads to 5e-4 (the flash tests' "
          "grad tolerance); bf16 grads to 1e-2 (dS and P rounded to bf16 "
          "after fp32 sums taken in another order); out/lse as B1")
    max_err = {"b2": 0.0, "b3": 0.0, "dropout": 0.0}
    for i, (label, b, h, s, kv_len, d, causal, kind, fused_views, rate) in \
            enumerate(backward_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = make_case(b, h, s, kv_len, d, kind, fused_views,
                                      dtype, SEED + 100 + i)
            dout = torch.randn(b, s, h, d, generator=torch.Generator()
                               .manual_seed(SEED + 200 + i)).to(DEVICE, dtype)
            seed = seed_words(SEED + 300 + i) if rate else None
            row = {"case": label, "dtype": str(dtype).split(".")[-1],
                   "b": b, "h": h, "s": s, "kv_len": kv_len, "d": d,
                   "causal": causal, "dropout": rate}
            paths = ["b2"] + (["b3"] if fa.fused_backward_fits(d, s, kv_len,
                                                                dtype)
                              else [])
            for path in paths:
                err = check_backward_case(row, label, path, dtype, q, k, v,
                                          dout, mask, causal, rate, seed,
                                          kind)
                max_err[path] = max(max_err[path], err)
                if rate:
                    max_err["dropout"] = max(max_err["dropout"], err)
            results["backward"].append(row)
    check_keep_mask(card, results)
    timings = time_backward(card, results, max_err)
    check_b3_bert_scale(card, results, max_err)
    return max_err, timings


# ------------------------------------------------------------------- serve
def serve_config(weights_dtype, kv_blocks):
    return {"inference": {
        "kv_block_size": 16, "max_seq_len": 1024,
        "prefill_buckets": list(BUCKETS), "max_batch_slots": 8,
        "kv_blocks": kv_blocks, "token_budget": 8192, "max_new_tokens": 32,
        "weights_dtype": weights_dtype}}


def phase_serve(card, model, params, results):
    engine = InferenceEngine(model, params,
                             config=serve_config("bfloat16", 520))
    rng = np.random.default_rng(SEED + 1)
    lens = rng.integers(32, 961, size=16)
    prompts = [rng.integers(0, model.config.vocab_size, size=n).tolist()
               for n in lens]
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0   # count only the main path's launches
    for i, p in enumerate(prompts[:8]):
        engine.submit(p, request_id=f"r{i}")
    for _ in range(3):
        engine.step()
    for i, p in enumerate(prompts[8:], start=8):
        engine.submit(p, request_id=f"r{i}")
    out = engine.run()
    torch.cuda.synchronize()
    launches = flash_attention_fwd.launches
    receipt = engine.serving_receipt()
    prefills = len(prompts)   # one prefill per admitted request
    check(len(out) == 16 and all(
        len(r["tokens"]) == 32 and r["finish_reason"] == "max_new_tokens"
        and all(0 <= t < model.config.vocab_size for t in r["tokens"])
        for r in out.values()), "not every request finished with 32 tokens")
    check(launches == receipt["flash_fwd_launches"]
          == model.config.num_layers * prefills,
          f"flash_fwd_launches {launches} != "
          f"{model.config.num_layers} x {prefills} prefills")
    receipt.update(card=card, prompt_lens=[int(n) for n in lens],
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    print(f"serve receipt (GPT-2-medium bf16, {model.config.num_layers} "
          f"layers, hidden {model.config.hidden_size}):",
          json.dumps(receipt))
    results["serve"] = receipt
    engine.close()
    return launches


# ------------------------------------------------------------------ parity
def phase_parity(model, params, results):
    lens = (100, 500, 1000)
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, model.config.vocab_size, size=n).tolist()
               for n in lens]
    served = {}
    for where, device in (("card", DEVICE), ("cpu", torch.device("cpu"))):
        engine = InferenceEngine(model, params,
                                 config=serve_config("float32", 128),
                                 device=device)
        for i, p in enumerate(prompts):
            engine.submit(p, max_new_tokens=8, request_id=f"p{i}")
        served[where] = {rid: r["tokens"]
                          for rid, r in engine.run().items()}
        engine.close()
        del engine
    cpu_params = None
    report = []
    for i, p in enumerate(prompts):
        card_t, cpu_t = served["card"][f"p{i}"], served["cpu"][f"p{i}"]
        entry = {"prompt_len": len(p), "card": card_t, "cpu": cpu_t}
        diff = next((j for j, (a, b) in enumerate(zip(card_t, cpu_t))
                     if a != b), None)
        if diff is not None:
            # a flip is allowed only where the CPU's top two logits tie
            if cpu_params is None:
                cpu_params = params_from_numpy(params, "cpu")
            with torch.no_grad():
                logits = model.logits(cpu_params,
                                      torch.tensor([p + cpu_t[:diff]]))
            top2 = torch.topk(logits[0, -1], 2).values
            gap = float(top2[0] - top2[1])
            entry.update(first_diff=diff, cpu_top2_gap=gap)
            print(f"parity: prompt {len(p)} differs at token {diff}; "
                  f"CPU top-2 logit gap {gap:.3g}")
            check(gap < 1e-4, f"greedy tokens differ at token {diff} of "
                  f"prompt {len(p)} with a top-2 gap of {gap:.3g}")
        else:
            check(len(card_t) == 8, f"prompt {len(p)}: {len(card_t)} tokens")
            print(f"parity: prompt {len(p)}: 8 greedy tokens identical on "
                  "card and CPU")
        report.append(entry)
    results["parity"] = report


# ------------------------------------------------------------------- train
KERNEL_COUNTERS = {"B1": flash_attention_fwd, "B2a": flash_attention_bwd_dq,
                   "B2b": flash_attention_bwd_dkv,
                   "B3": flash_attention_bwd_fused,
                   "B4": fa.in_kernel_dropout,
                   "B5a": fbs.flash_block_sparse_fwd,
                   "B5b": fbs.flash_block_sparse_bwd,
                   "B6a": fbs.flash_block_sparse_agg_fwd,
                   "B6b": fbs.flash_block_sparse_agg_bwd_dq,
                   "B6c": fbs.flash_block_sparse_agg_bwd_dkv}


# the fp16 launches of B1-B4, counted again beside their all-dtype counts
FP16_COUNTERS = {f"{name} fp16": KERNEL_COUNTERS[name].fp16
                 for name in ("B1", "B2a", "B2b", "B3", "B4")}


def reset_launches():
    for counter in (*KERNEL_COUNTERS.values(), *FP16_COUNTERS.values()):
        counter.launches = 0


def read_launches():
    counters = dict(KERNEL_COUNTERS, **FP16_COUNTERS)
    return {name: counter.launches for name, counter in counters.items()}


def gpt2_model_flops_per_sample(cfg, seq):
    """GPT-2 fwd+bwd model flops per sample, as ``bench.py:70-82`` counts
    them: causal attention at half the dense score and context work."""
    h, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    per_layer = (2 * seq * h * 3 * h            # QKV
                 + 2 * seq * seq * h * 2 // 2   # scores + context
                 + 2 * seq * h * h              # attn out
                 + 2 * seq * h * 4 * h * 2)     # FC1 + FC2
    head = 2 * seq * h * v  # tied LM head over every position
    return 3 * (L * per_layer + head)


TRAIN_CONFIG = {"train_batch_size": 8, "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Lamb", "params": {"lr": 1e-4}},
                "zero_optimization": {"stage": 2},
                "bf16": {"enabled": True}}


# the train set-ups' random weights, drawn once a set-up: their phases
# build an engine each from the same weights (the engine copies them
# into its flat master), and drawing GPT-2-medium's or BERT-large's
# takes seconds of host time
_SETUP_WEIGHTS = {}


def setup_weights(name, make, cfg):
    """``make(cfg, SEED)`` for the set-up ``name``, drawn on its first
    call; every config the set-up makes has the same weight shapes."""
    if name not in _SETUP_WEIGHTS:
        _SETUP_WEIGHTS[name] = make(cfg, SEED)
    return _SETUP_WEIGHTS[name]


def train_setup(config=TRAIN_CONFIG, micro_batch=None, mesh=None,
                **model_kw):
    """The train phase's engine, model config and fixed batch on the
    card: GPT-2-medium at full width and depth, bench.py's GPT-2 leg
    (``bench.py:806-816``): seq 1024, micro-batch 8, dropout 0.1 at all
    three sites, Lamb lr 1e-4, ZeRO-2, bf16 (``config``: phase 17 swaps
    in fp16, phase 21 adds ``activation_checkpointing``), random weights
    from ``SEED`` and token ids from ``SEED + 1``.  ``micro_batch`` and
    ``model_kw`` (``loss_chunk``) are phase 21's changes; ``mesh`` is
    phase 30's data-parallel mesh.
    ``examples/profile_torch_train.py`` profiles this same set-up."""
    b = micro_batch or TRAIN_ATTN[0]
    s = TRAIN_ATTN[2]
    cfg = GPT2Config.gpt2_medium(embd_dropout=DROPOUT, attn_dropout=DROPOUT,
                                 resid_dropout=DROPOUT, **model_kw)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(cfg),
        model_parameters=setup_weights("train", random_params, cfg),
        config=dict(config, train_batch_size=b), mesh=mesh)
    ids = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size,
                                                   size=(b, s))
    return engine, cfg, {"input_ids": ids}


def run_steps(label, engine, batch, warmup, timed):
    """``warmup`` then ``timed`` ``train_batch`` steps on one fixed batch,
    with the launch counts set to 0 just before and read just after;
    checks finite, falling losses.  Returns ``(losses, seconds per timed
    step, launches)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = [engine.train_batch(iter([batch])) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [engine.train_batch(iter([batch])) for _ in range(timed)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
    check(losses[-1] < losses[0], f"{label}: the last loss {losses[-1]} is "
          f"not below the first {losses[0]}")
    return losses, seconds / timed, launches


def phase_train(card, results):
    """Trains :func:`train_setup`'s GPT-2-medium: 2 warm-up steps and 5
    timed steps on one fixed batch."""
    b, _, s, _ = TRAIN_ATTN
    engine, cfg, batch = train_setup()
    losses, step_s, launches = run_steps("train", engine, batch, 2, 5)
    steps, layers = 7, cfg.num_layers
    check(launches["B1"] == launches["B2a"] == launches["B2b"]
          == layers * steps and launches["B4"] == 3 * layers * steps
          and only_launched(launches, ("B1", "B2a", "B2b", "B4")),
          f"train: launches {launches}, expected {layers * steps} of "
          f"B1/B2a/B2b (s={s} takes B2, not B3) and 3x that of B4")
    samples_s = b / step_s
    flops = gpt2_model_flops_per_sample(cfg, s)
    receipt = {
        "card": card, "layers": layers, "hidden": cfg.hidden_size,
        "heads": cfg.num_heads, "vocab": cfg.vocab_size, "seq": s,
        "micro_batch": b, "dropout": DROPOUT, "losses": losses,
        "step_ms": 1e3 * step_s, "samples_per_s": samples_s,
        "tokens_per_s": samples_s * s,
        "mfu": samples_s * flops / PEAK_FLOPS[torch.bfloat16],
        "model_flops_per_sample": flops,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches_per_step": {k: v / steps for k, v in launches.items()}}
    print("train receipt (GPT-2-medium, 24 layers, seq 1024, batch 8, bf16, "
          "Lamb, ZeRO-2, dropout 0.1):", json.dumps(receipt))
    results["train"] = receipt
    del engine
    torch.cuda.empty_cache()
    return launches


PARITY_CONFIG = {
    "train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
    "steps_per_print": 10 ** 9,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
    "scheduler": {"type": "WarmupLR",
                  "params": {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-4,
                             "warmup_num_steps": 3}}}


def card_vs_cpu(label, make_model, params, batches):
    """3 steps of ``PARITY_CONFIG`` (micro-batch 2, accumulation 2,
    clipping 1.0, Adam under WarmupLR) of ``make_model()`` in fp32 with
    TF32 off, on the card and on the CPU from the same weights and the
    same 6 batches: the loss trajectories must agree to rtol 1e-3.
    Returns ``(card losses, cpu losses, the card run's launches)``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trajectories, launches = {}, None
    for where, device in (("card", DEVICE), ("cpu", torch.device("cpu"))):
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=make_model(), model_parameters=params,
            config=dict(PARITY_CONFIG), device=device)
        if where == "card":
            torch.cuda.synchronize()
            reset_launches()
        it = iter(batches)
        trajectories[where] = [float(engine.train_batch(it))
                               for _ in range(3)]
        if where == "card":
            torch.cuda.synchronize()
            launches = read_launches()
        del engine
    card, cpu = trajectories["card"], trajectories["cpu"]
    check(np.allclose(card, cpu, rtol=1e-3, atol=0.0),
          f"{label}: card {card} vs cpu {cpu}")
    return card, cpu, launches


def gpt2_parity_run(label, cfg, seq, seed):
    """:func:`card_vs_cpu` of GPT-2 ``cfg`` on random token ids."""
    rng = np.random.default_rng(seed)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(2, seq))}
               for _ in range(6)]
    return card_vs_cpu(label, lambda: GPT2LMHead(cfg),
                       random_params(cfg, SEED), batches)


def only_launched(launches, names, expected=None):
    """Whether no kernel outside ``names`` launched and, unless
    ``expected`` is None, each of ``names`` launched ``expected`` times.
    A kernel's fp16 count is one of its launches: it must be 0 unless
    ``names`` holds it."""
    return all(n == 0 if name not in names else expected in (None, n)
               for name, n in launches.items())


def phase_train_parity(results):
    """Card against CPU (:func:`card_vs_cpu`): 2 layers at GPT-2-medium
    width, dropout 0, seq 128.  At seq 128 the backward takes B3."""
    cfg = GPT2Config(hidden_size=1024, num_heads=16, num_layers=2,
                     embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)
    card, cpu, launches = gpt2_parity_run("train parity", cfg, 128, SEED + 2)
    expected = cfg.num_layers * 2 * 3
    check(only_launched(launches, ("B1", "B3"), expected),
          f"train parity: launches {launches}, expected {expected} of B1 "
          f"and B3 only")
    print(f"train parity (2 layers, hidden 1024, seq 128, fp32, Adam + "
          f"WarmupLR, accumulation 2, clip 1.0): card {card}, cpu {cpu}, "
          f"max rel diff "
          f"{max(abs(a - b) / abs(b) for a, b in zip(card, cpu)):.3g}")
    results["train_parity"] = {"card": card, "cpu": cpu,
                               "launches": launches}
    return launches


# ------------------------------------------------------------------ sparse
def sparse_pairs(layout, s, heads, causal):
    """(query, key) pairs inside the active tiles of ``layout`` that the
    causal mask leaves visible, over ``heads`` heads of one batch row:
    the work this layout needs."""
    active = np.asarray(layout) != 0
    nb = active.shape[1]
    blk = s // nb
    if causal:
        below = np.tril(np.ones((nb, nb), bool), -1)
        pairs = (active & below).sum() * blk * blk \
            + (active & np.eye(nb, dtype=bool)).sum() * (blk * (blk + 1) // 2)
    else:
        pairs = active.sum() * blk * blk
    return float(pairs) * heads / active.shape[0]


def sparse_bound(kind, q, layout, causal):
    """The bound of one block-sparse call over ``layout``'s visible
    pairs: "fwd" (B5a, B6a) reads q, k, v and writes out and lse, 4·d
    flops a pair; "bwd" (B5b) reads q, k, v, dO, lse, Δ and writes dq,
    dk, dv, 10·d; "dq" (B6b) writes dq, 6·d; "dkv" (B6c) writes dk and
    dv, 8·d."""
    b, s, h, d = q.shape
    tensor = b * s * h * d * q.element_size()
    rows = b * h * s * 4
    n_tensors, n_rows, per_pair = {"fwd": (4, 1, 4), "bwd": (7, 2, 10),
                                   "dq": (5, 2, 6), "dkv": (6, 2, 8)}[kind]
    return bound_ms(n_tensors * tensor + n_rows * rows,
                    per_pair * d * b * sparse_pairs(layout, s, h, causal),
                    q.dtype)


def sparse_cases():
    """(label, layout, b, h, s, d, causal); q, k, v are fused-QKV views."""
    random.seed(SEED)
    rs = np.random.RandomState(SEED)
    per_head = (rs.rand(8, 16, 16) < 0.3).astype(np.int64)
    per_head[1, 3] = 0          # head 1, q block 3 attends nothing
    per_head[:, 5] = 0          # q block 5 attends nothing in any head
    b, h, s, d = SPARSE_ATTN
    return [
        ("train_layout", FixedSparsityConfig(**SPARSE_LAYOUT).make_layout(s),
         b, h, s, d, True),
        # the sparse train-parity phase's attention
        ("parity_layout", FixedSparsityConfig(**PARITY_LAYOUT)
         .make_layout(PARITY_SEQ), 2, h, PARITY_SEQ, d, True),
        ("fixed_blk128", FixedSparsityConfig(
            **dict(SPARSE_LAYOUT, block=128)).make_layout(2048),
         1, h, 2048, d, True),
        ("bigbird_blk64", BigBirdSparsityConfig(
            num_heads=8, block=64, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1)
            .make_layout(2048)[:1], 1, 8, 2048, 64, False),
        ("bigbird_blk512_s16384", BigBirdSparsityConfig(
            num_heads=2, block=512, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1,
            different_layout_per_head=True).make_layout(16384),
         1, 2, 16384, 64, False),
        ("per_head_empty_rows_causal", per_head, 2, 8, 1024, 64, True),
        ("per_head_empty_rows", per_head, 2, 8, 1024, 64, False),
        ("blk16", FixedSparsityConfig(
            num_heads=8, block=16, num_local_blocks=4,
            attention="unidirectional").make_layout(1024)[:1],
         2, 8, 1024, 64, True),
        ("blk24_upper_triangle", np.triu(np.ones((1, 8, 8), np.int64)),
         1, 4, 192, 64, True),
        ("d128", per_head, 1, 8, 512, 128, True),
    ]


def sparse_chain(q, k, v, dout, layout, causal):
    out, lse = fbs.flash_block_sparse_fwd(q, k, v, layout, causal)
    return (out, lse) + tuple(fbs.flash_block_sparse_bwd(
        q, k, v, out, lse, dout, layout, causal))


def phase_sparse_kernel(card, results):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("sparse kernel: B5a out/lse to fp32 2e-5, bf16 2e-2; B5b grads "
          "to 5e-4 / 1e-2 from the kernel's own out and lse (the bounds of "
          "B1-B3)")
    max_err = {"fwd": 0.0, "bwd": 0.0}
    rows = []
    for i, (label, layout, b, h, s, d, causal) in enumerate(sparse_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, _ = make_case(b, h, s, s, d, "none", True, dtype,
                                   SEED + 400 + i)
            dout = torch.randn(b, s, h, d, generator=torch.Generator()
                               .manual_seed(SEED + 500 + i)).to(DEVICE, dtype)
            got = sparse_chain(q, k, v, dout, layout, causal)
            torch.cuda.synchronize()
            again = sparse_chain(q, k, v, dout, layout, causal)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                  f"sparse {label}: two runs are not bitwise equal")
            out, lse, dq, dk, dv = got
            ref_out, ref_lse = fbs.flash_block_sparse_reference(
                q, k, v, layout, causal)
            tol, gtol = TOLS[dtype], GRAD_TOLS[dtype]
            torch.testing.assert_close(out.float(), ref_out.float(),
                                       atol=tol, rtol=tol)
            torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
            errs = {"out": float((out.float() - ref_out.float()).abs().max())}
            del ref_out, ref_lse
            ref = fbs.flash_block_sparse_bwd_reference(
                q, k, v, out, lse, dout, layout, causal)
            for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                check(bool(torch.isfinite(g.float()).all()),
                      f"sparse {label}: non-finite {name}")
                torch.testing.assert_close(
                    g.float(), r.float(), atol=gtol, rtol=gtol,
                    msg=lambda m: f"sparse {label} {name}: {m}")
                errs[name] = float((g.float() - r.float()).abs().max())
            del ref
            if label.startswith("per_head"):
                blk = s // layout.shape[1]
                check(not bool(out[:, 3 * blk:4 * blk, 1].any())
                      and not bool(dq[:, 3 * blk:4 * blk, 1].any())
                      and not bool(out[:, 5 * blk:6 * blk].any())
                      and not bool(dq[:, 5 * blk:6 * blk].any()),
                      f"sparse {label}: a row with no active block has "
                      f"non-zero out or dq")
            max_err["fwd"] = max(max_err["fwd"], errs["out"])
            max_err["bwd"] = max(max_err["bwd"], errs["dq"], errs["dk"],
                                 errs["dv"])
            rows.append(dict(errs, case=label,
                             dtype=str(dtype).split(".")[-1], b=b, h=h, s=s,
                             d=d, causal=causal,
                             block=s // layout.shape[1],
                             layout_heads=int(layout.shape[0])))
            print(f"sparse kernel {label} {rows[-1]['dtype']} (blk "
                  f"{rows[-1]['block']}, H={layout.shape[0]}): max "
                  f"|out-plain| {errs['out']:.3g}, |grad-plain| dq "
                  f"{errs['dq']:.3g} dk {errs['dk']:.3g} dv {errs['dv']:.3g}"
                  f", bitwise-repeatable ok")
    results["sparse_kernel"] = rows
    check_aggregation_launches_b6()
    return max_err, time_sparse(card, results)


def check_aggregation_launches_b6():
    """Where the JAX package runs its G×G super-tile kernels ("auto" at
    layout blocks of up to 128 rows, or an explicit factor), a forward
    and backward through the entry point launches B6a, B6b and B6c once
    each and no other kernel: B5 never stands in for them."""
    g = torch.Generator().manual_seed(SEED + 700)
    for blk, q_agg in ((128, "auto"), (16, "auto"), (256, 2)):
        layout = np.tril(np.ones((1, 1024 // blk, 1024 // blk), np.int64))
        q = torch.randn(1, 1024, 2, 64, generator=g).to(DEVICE) \
            .requires_grad_()
        torch.cuda.synchronize()
        before = read_launches()
        out = fbs.flash_block_sparse_attention(q, q, q, layout, causal=True,
                                               q_agg=q_agg)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        delta = {k: n - before[k] for k, n in read_launches().items()}
        check(only_launched(delta, ("B6a", "B6b", "B6c"), 1),
              f"blk {blk} q_agg={q_agg!r}: launches {delta}, expected one "
              f"each of B6a, B6b, B6c and nothing else")
        check(bool(torch.isfinite(q.grad).all()), f"blk {blk}: grads")
    print("sparse kernel: q_agg='auto' at blk 128 and 16 and q_agg=2 at blk "
          "256 launch B6a, B6b and B6c once each and no B5")


def time_sparse(card, results):
    """Device times at the sparse training attention (b=2, h=16, s=4096,
    d=64, bf16, fused-QKV views, the train layout): B5a and B5b beside
    their plain versions, SDPA with the layout expanded to a boolean mask
    (forward, and its whole backward; a yardstick the port never calls)
    and the bound; then dense B1 and B2a+B2b at the same shape."""
    b, h, s, d = SPARSE_ATTN
    layout = FixedSparsityConfig(**SPARSE_LAYOUT).make_layout(s)
    q, k, v, _ = make_case(b, h, s, s, d, "none", True, torch.bfloat16,
                           SEED + 600)
    dout = torch.randn(b, s, h, d, generator=torch.Generator()
                       .manual_seed(SEED + 601)).to(DEVICE, torch.bfloat16)
    out, lse = fbs.flash_block_sparse_fwd(q, k, v, layout, True)
    timings = {}
    visible, _ = fbs.expand_layout(layout, s, True, DEVICE)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=visible)
    dot = dout.transpose(1, 2)
    for kind, kernel, plain, library in (
            ("fwd",
             lambda: fbs.flash_block_sparse_fwd(q, k, v, layout, True),
             lambda: fbs.flash_block_sparse_reference(q, k, v, layout, True),
             lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=visible)),
            ("bwd",
             lambda: fbs.flash_block_sparse_bwd(q, k, v, out, lse, dout,
                                                layout, True),
             lambda: fbs.flash_block_sparse_bwd_reference(
                 q, k, v, out, lse, dout, layout, True),
             lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), dot,
                                         retain_graph=True))):
        bound, by = sparse_bound(kind, q, layout, True)
        timings[kind] = {
            "kernel_ms": device_ms(kernel),
            "plain_ms": device_ms(plain, calls=1, repeats=3, warmup=1),
            "library_ms": device_ms(library, calls=2, repeats=5, warmup=1),
            "bound_ms": bound, "bound_by": by}
        print(f"sparse timing {kind} (b={b} h={h} s={s} d={d} causal bf16, "
              f"fused QKV views, Fixed unidirectional blk "
              f"{SPARSE_LAYOUT['block']}): " + " ".join(
                  f"{key}={val:.5f}" if isinstance(val, float) else
                  f"{key}={val}" for key, val in timings[kind].items())
              + f" [{card}]")
    del o_sdpa, visible
    timings.update(time_agg_orders(q, k, v, out, lse, dout, fbs._delta(
        out, dout), layout, 1, True))
    print("sparse timing launch_order (B5a's forward and B5b's dq and "
          "dk/dv kernels at G = 1): " + " ".join(
              f"{key}={val:.5f}" if isinstance(val, float) else
              f"{key}={val}" for key, val in
              timings["launch_order"].items()) + f" [{card}]")
    # the dense kernels at the same shape
    d_out, d_lse = flash_attention_fwd(q, k, v, None, True)
    args = (q, k, v, d_out, d_lse, dout, None, True)
    pairs = sparse_pairs(layout, s, h, True)
    dense = {
        "b1_ms": device_ms(lambda: flash_attention_fwd(q, k, v, None, True)),
        "b2_ms": device_ms(lambda: (flash_attention_bwd_dq(*args),
                                    flash_attention_bwd_dkv(*args))),
        "layout_density": float(np.mean(layout != 0)),
        "causal_density": pairs / (h * s * (s + 1) / 2)}
    print(f"sparse vs dense (same shape, causal): B5a "
          f"{timings['fwd']['kernel_ms']:.4f} ms vs B1 {dense['b1_ms']:.4f}; "
          f"B5b {timings['bwd']['kernel_ms']:.4f} ms vs B2a+B2b "
          f"{dense['b2_ms']:.4f}; active blocks {dense['layout_density']:.4f}"
          f" of the layout, visible pairs {dense['causal_density']:.4f} of "
          f"the causal triangle [{card}]")
    timings["dense"] = dense
    results["sparse_timing"] = timings
    return timings


def sparse_train_setup():
    """The sparse train phase's engine, model config and fixed batch on
    the card: GPT-2-medium at full width and depth with 4096 positions
    and ``attn_impl="sparse"`` under the Fixed unidirectional layout of
    "Generative Modeling with Sparse Transformers" (256-row blocks, 4
    local blocks, 1 global block: a block size at which the JAX layer
    runs the work-list kernels), seq 4096, micro-batch 2, dropout 0.1,
    Lamb lr 1e-4, ZeRO-2, bf16.  ``examples/profile_torch_train.py
    --sparse`` profiles this same set-up."""
    b, _, s, _ = SPARSE_ATTN
    cfg = GPT2Config.gpt2_medium(
        max_position_embeddings=s, embd_dropout=DROPOUT, attn_dropout=DROPOUT,
        resid_dropout=DROPOUT, attn_impl="sparse",
        sparsity_config=FixedSparsityConfig(**SPARSE_LAYOUT))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(cfg), model_parameters=random_params(cfg, SEED),
        config=dict(TRAIN_CONFIG, train_batch_size=b))
    ids = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size,
                                                   size=(b, s))
    return engine, cfg, {"input_ids": ids}


def phase_sparse_train(card, results):
    """Trains :func:`sparse_train_setup`'s model: 2 warm-up steps and 3
    timed steps on one fixed batch."""
    b, _, s, _ = SPARSE_ATTN
    engine, cfg, batch = sparse_train_setup()
    losses, step_s, launches = run_steps("sparse train", engine, batch, 2, 3)
    steps, layers = 5, cfg.num_layers
    check(only_launched(launches, ("B5a", "B5b"), layers * steps),
          f"sparse train: launches {launches}, expected {layers * steps} of "
          f"B5a and B5b and no dense flash launch")
    layout = engine.module.layer._sparse_layout(s)
    receipt = {
        "card": card, "layers": layers, "hidden": cfg.hidden_size,
        "heads": cfg.num_heads, "vocab": cfg.vocab_size, "seq": s,
        "micro_batch": b, "dropout": DROPOUT, "layout": SPARSE_LAYOUT,
        "layout_density": float(np.mean(layout != 0)),
        "causal_density": sparse_pairs(layout, s, 1, True)
        / (s * (s + 1) / 2),
        "losses": losses, "step_ms": 1e3 * step_s,
        "samples_per_s": b / step_s, "tokens_per_s": b * s / step_s,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches_per_step": {k: v / steps for k, v in launches.items()}}
    print("sparse train receipt (GPT-2-medium, 24 layers, seq 4096, batch "
          "2, bf16, Lamb, ZeRO-2, dropout 0.1, Fixed unidirectional sparse "
          "attention):", json.dumps(receipt))
    results["sparse_train"] = receipt
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_sparse_parity(results):
    """Card against CPU (:func:`card_vs_cpu`) with the sparse core: 2
    layers at GPT-2-medium width, dropout 0, seq 1024 in 256-row blocks
    (Fixed unidirectional).  The card runs B5a and B5b, the CPU the
    gather path."""
    cfg = GPT2Config(
        hidden_size=1024, num_heads=16, num_layers=2, embd_dropout=0.0,
        attn_dropout=0.0, resid_dropout=0.0, attn_impl="sparse",
        sparsity_config=FixedSparsityConfig(**PARITY_LAYOUT))
    card, cpu, launches = gpt2_parity_run("sparse train parity", cfg,
                                          PARITY_SEQ, SEED + 3)
    expected = cfg.num_layers * 2 * 3
    check(only_launched(launches, ("B5a", "B5b"), expected),
          f"sparse train parity: launches {launches}, expected {expected} "
          f"of B5a and B5b only")
    print(f"sparse train parity (2 layers, hidden 1024, seq {PARITY_SEQ}, "
          f"blk {PARITY_LAYOUT['block']}, "
          f"fp32, Adam + WarmupLR, accumulation 2, clip 1.0): card {card}, "
          f"cpu {cpu}, max rel diff "
          f"{max(abs(a - b) / abs(b) for a, b in zip(card, cpu)):.3g}")
    results["sparse_train_parity"] = {"card": card, "cpu": cpu,
                                      "launches": launches}
    return launches


# -------------------------------------------------------------- super-tile
def agg_cases():
    """(label, layout, b, h, s, d, G, causal); q, k, v are fused-QKV views.
    ``per_head``: head 1's super-row 1 (layout rows 4-7 at G = 4) has no
    active tile, so its rows get out 0, dq 0 and lse NEG_INF; head 2's
    layout row 9 has none inside an active super-row, so its lse is
    MAX_FLOOR."""
    random.seed(SEED)
    rs = np.random.RandomState(SEED + 1)
    per_head = (rs.rand(8, 16, 16) < 0.3).astype(np.int64)
    per_head[:, :, 0] = 1
    per_head[1, 4:8] = 0
    per_head[2, 9] = 0
    b, h, s, d = SPARSE_ATTN
    return [
        ("bert_train_layout", FixedSparsityConfig(**BERT_SPARSE_LAYOUT)
         .make_layout(s), b, h, s, d, 4, False),
        ("bert_parity_layout", FixedSparsityConfig(**BERT_SPARSE_LAYOUT)
         .make_layout(BERT_PARITY_SEQ), 2, h, BERT_PARITY_SEQ, d, 4, False),
        ("bigbird_blk64", BigBirdSparsityConfig(
            num_heads=8, block=64, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1)
            .make_layout(2048)[:1], 1, 8, 2048, 64, 4, False),
        ("fixed_blk16", FixedSparsityConfig(
            num_heads=8, block=16, num_local_blocks=4,
            attention="bidirectional").make_layout(1024)[:1],
         2, 8, 1024, 64, 4, False),
        ("blk24_q_agg3_causal", np.tril(np.ones((1, 6, 6), np.int64)),
         1, 4, 144, 64, 3, True),
        ("blk256_q_agg2_causal", np.tril(np.ones((1, 4, 4), np.int64)),
         1, 4, 1024, 64, 2, True),
        ("per_head_empty_causal", per_head, 2, 8, 256, 64, 4, True),
        ("per_head_empty", per_head, 2, 8, 256, 64, 4, False),
        ("d128_causal", per_head, 1, 8, 512, 128, 4, True),
        ("blk16_q_agg5", (rs.rand(2, 10, 10) < 0.35).astype(np.int64), 1,
         2, 160, 64, 5, False),
    ]


def agg_chain(q, k, v, dout, layout, G, causal):
    out, lse = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G, causal)
    return (out, lse) + tuple(fbs.flash_block_sparse_agg_bwd(
        q, k, v, out, lse, dout, layout, G, causal))


def check_agg_case(label, layout, G, causal, q, k, v, dout, dtype):
    """B6a, B6b, B6c on one case: two runs bitwise equal, against the
    plain versions (and the MAX_FLOOR and NEG_INF rows equal), and
    against B5 on the same inputs; returns the max errors."""
    got = agg_chain(q, k, v, dout, layout, G, causal)
    torch.cuda.synchronize()
    again = agg_chain(q, k, v, dout, layout, G, causal)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
          f"agg {label}: two runs are not bitwise equal")
    out, lse, dq, dk, dv = got
    tol, gtol = TOLS[dtype], GRAD_TOLS[dtype]
    ref_out, ref_lse = fbs.flash_block_sparse_agg_reference(q, k, v, layout,
                                                            G, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
    for special in (fbs.MAX_FLOOR, fbs.NEG_INF):
        check(torch.equal(lse == special, ref_lse == special),
              f"agg {label}: the rows with lse {special} differ")
    errs = {"out": float((out.float() - ref_out.float()).abs().max())}
    del ref_out, ref_lse
    ref = fbs.flash_block_sparse_agg_bwd_reference(q, k, v, out, lse, dout,
                                                   layout, G, causal)
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        check(bool(torch.isfinite(g.float()).all()),
              f"agg {label}: non-finite {name}")
        torch.testing.assert_close(g.float(), r.float(), atol=gtol,
                                   rtol=gtol, msg=lambda m: f"agg {label} "
                                   f"{name}: {m}")
        errs[name] = float((g.float() - r.float()).abs().max())
    del ref
    # B5 computes the same function on the same inputs
    b5 = sparse_chain(q, k, v, dout, layout, causal)
    torch.testing.assert_close(out.float(), b5[0].float(), atol=tol,
                               rtol=tol)
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), b5[2:]):
        torch.testing.assert_close(g.float(), r.float(), atol=gtol,
                                   rtol=gtol, msg=lambda m: f"agg {label} "
                                   f"{name} vs B5: {m}")
    errs["vs_b5"] = max(float((a.float() - r.float()).abs().max())
                        for a, r in zip((out, dq, dk, dv),
                                        (b5[0],) + tuple(b5[2:])))
    del b5
    # exactly 0 where no pair is seen: dq of a row that sees no key, dk
    # and dv of a key that no row sees
    s, h = q.shape[1], q.shape[2]
    visible, _ = fbs.expand_layout(layout, s, causal, q.device)
    visible = visible.expand(h, s, s)
    no_key, no_row = ~visible.any(-1).T, ~visible.any(-2).T
    del visible
    check(not bool(dq[:, no_key].any()) and not bool(dk[:, no_row].any())
          and not bool(dv[:, no_row].any()),
          f"agg {label}: a gradient where no pair is seen is not 0")
    if label.startswith("per_head"):
        blk = s // layout.shape[1]
        lse_h = lse.view(-1, h, s)
        rows = slice(4 * blk, 8 * blk)
        check(not bool(out[:, rows, 1].any()) and not bool(dq[:, rows, 1]
                                                            .any())
              and bool((lse_h[:, 1, rows] == fbs.NEG_INF).all()),
              f"agg {label}: the empty super-row is not out 0, dq 0, lse "
              f"NEG_INF")
        check(bool((lse_h[:, 2, 9 * blk:10 * blk] == fbs.MAX_FLOOR).all()),
              f"agg {label}: the empty row of an active super-row has not "
              f"lse MAX_FLOOR")
    return errs


def phase_agg_kernel(card, results):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("agg kernel: B6a out/lse to fp32 2e-5, bf16 2e-2 (MAX_FLOOR and "
          "NEG_INF rows equal); B6b, B6c grads to 5e-4 / 1e-2 from the "
          "kernel's own out and lse; and against B5 at the same bounds")
    max_err = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    rows = []
    for i, (label, layout, b, h, s, d, G, causal) in enumerate(agg_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, _ = make_case(b, h, s, s, d, "none", True, dtype,
                                   SEED + 800 + i)
            dout = torch.randn(b, s, h, d, generator=torch.Generator()
                               .manual_seed(SEED + 900 + i)).to(DEVICE, dtype)
            errs = check_agg_case(label, layout, G, causal, q, k, v, dout,
                                  dtype)
            max_err["fwd"] = max(max_err["fwd"], errs["out"])
            max_err["dq"] = max(max_err["dq"], errs["dq"])
            max_err["dkv"] = max(max_err["dkv"], errs["dk"], errs["dv"])
            rows.append(dict(errs, case=label, dtype=str(dtype).split(".")[-1],
                             b=b, h=h, s=s, d=d, G=G, causal=causal,
                             block=s // layout.shape[1],
                             layout_heads=int(layout.shape[0])))
            print(f"agg kernel {label} {rows[-1]['dtype']} (blk "
                  f"{rows[-1]['block']}, G={G}, H={layout.shape[0]}): max "
                  f"|out-plain| {errs['out']:.3g}, |grad-plain| dq "
                  f"{errs['dq']:.3g} dk {errs['dk']:.3g} dv {errs['dv']:.3g}"
                  f", vs B5 {errs['vs_b5']:.3g}, bitwise-repeatable ok")
    results["agg_kernel"] = rows
    return max_err, time_agg(card, results)


def time_agg(card, results):
    """Device times at the BERT sparse attention (b=2, h=16, s=4096,
    d=64, bf16, fused-QKV views, the train layout, not causal): B6a, B6b
    and B6c beside their plain versions, SDPA with the layout expanded to
    a boolean mask (forward, and its whole backward; a yardstick the port
    never calls), the bound, and B5a/B5b on the same layout; then B6
    against B5 on the same layout in 16- and 64-row blocks."""
    b, h, s, d = SPARSE_ATTN
    layout = FixedSparsityConfig(**BERT_SPARSE_LAYOUT).make_layout(s)
    G = 4
    q, k, v, _ = make_case(b, h, s, s, d, "none", True, torch.bfloat16,
                           SEED + 1000)
    dout = torch.randn(b, s, h, d, generator=torch.Generator()
                       .manual_seed(SEED + 1001)).to(DEVICE, torch.bfloat16)
    out, lse = fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G)
    delta = fbs._delta(out, dout)
    visible, _ = fbs.expand_layout(layout, s, False, DEVICE)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=visible)
    dot = dout.transpose(1, 2)
    sdpa_fwd = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=visible), calls=2, repeats=5, warmup=1)
    sdpa_bwd = device_ms(lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dot, retain_graph=True), calls=2, repeats=5,
        warmup=1)
    del o_sdpa
    plain_bwd = device_ms(lambda: fbs.flash_block_sparse_agg_bwd_reference(
        q, k, v, out, lse, dout, layout, G), calls=1, repeats=3, warmup=1)
    clocks = {"before": clocks_line()}
    timings = {}
    for kind, kernel, plain, library in (
            ("fwd", lambda: fbs.flash_block_sparse_agg_fwd(q, k, v, layout,
                                                           G),
             device_ms(lambda: fbs.flash_block_sparse_agg_reference(
                 q, k, v, layout, G), calls=1, repeats=3, warmup=1),
             sdpa_fwd),
            ("dq", lambda: fbs.flash_block_sparse_agg_bwd_dq(
                q, k, v, out, lse, dout, layout, G, False, delta),
             plain_bwd, sdpa_bwd),
            ("dkv", lambda: fbs.flash_block_sparse_agg_bwd_dkv(
                q, k, v, out, lse, dout, layout, G, False, delta),
             plain_bwd, sdpa_bwd)):
        bound, by = sparse_bound(kind, q, layout, False)
        times = device_times(kernel)
        timings[kind] = {"kernel_ms": statistics.median(times),
                         "kernel_ms_min": min(times),
                         "kernel_ms_max": max(times), "plain_ms": plain,
                         "library_ms": library, "bound_ms": bound,
                         "bound_by": by}
    timings.update(time_agg_orders(q, k, v, out, lse, dout, delta, layout, G))
    clocks["after"] = clocks_line()
    timings["clocks"] = clocks
    for kind in ("fwd", "dq", "dkv", "launch_order"):
        print(f"agg timing {kind} (b={b} h={h} s={s} d={d} bf16, fused QKV "
              f"views, Fixed bidirectional blk 128, G=4): " + " ".join(
                  f"{key}={val:.5f}" if isinstance(val, float) else
                  f"{key}={val}" for key, val in timings[kind].items())
              + f" [{card}]")
    dq_row, dkv_row = timings["dq"], timings["dkv"]
    print(f"agg timing B6b+B6c {dq_row['kernel_ms'] + dkv_row['kernel_ms']:.5f}"
          f" ms (20 repeats B6b {dq_row['kernel_ms_min']:.5f}-"
          f"{dq_row['kernel_ms_max']:.5f}, B6c {dkv_row['kernel_ms_min']:.5f}-"
          f"{dkv_row['kernel_ms_max']:.5f}; B6c/B6b "
          f"{dkv_row['kernel_ms'] / dq_row['kernel_ms']:.3f}) against SDPA's "
          f"masked backward {sdpa_bwd:.5f} ms; clocks.sm, clocks.max.sm, "
          f"power.draw before {clocks['before']}, after {clocks['after']} "
          f"[{card}]")
    del visible
    versus = {}
    for blk in (128, 64, 16):
        lay = (layout if blk == 128 else FixedSparsityConfig(
            **dict(BERT_SPARSE_LAYOUT, block=blk)).make_layout(s))
        g_blk = fbs._pick_q_agg(blk, s // blk, "auto")
        o5, l5 = fbs.flash_block_sparse_fwd(q, k, v, lay)
        o6, l6 = fbs.flash_block_sparse_agg_fwd(q, k, v, lay, g_blk)
        row = {"G": g_blk, "layout_density": float(np.mean(lay != 0)),
               "b5_fwd_ms": device_ms(lambda: fbs.flash_block_sparse_fwd(
                   q, k, v, lay)),
               "b6_fwd_ms": device_ms(lambda: fbs.flash_block_sparse_agg_fwd(
                   q, k, v, lay, g_blk)),
               "b5_bwd_ms": device_ms(lambda: fbs.flash_block_sparse_bwd(
                   q, k, v, o5, l5, dout, lay), calls=5, repeats=10),
               "b6_bwd_ms": device_ms(lambda: fbs.flash_block_sparse_agg_bwd(
                   q, k, v, o6, l6, dout, lay, g_blk), calls=5, repeats=10),
               "fwd_bound_ms": sparse_bound("fwd", q, lay, False)[0],
               "bwd_bound_ms": sparse_bound("bwd", q, lay, False)[0]}
        versus[blk] = row
        print(f"B6 vs B5 at blk {blk} (G={g_blk}, layout density "
              f"{row['layout_density']:.4f}, b={b} h={h} s={s} bf16): fwd "
              f"B6a {row['b6_fwd_ms']:.4f} ms vs B5a {row['b5_fwd_ms']:.4f};"
              f" bwd B6b+B6c {row['b6_bwd_ms']:.4f} vs B5b "
              f"{row['b5_bwd_ms']:.4f} [{card}]")
    timings["versus_b5"] = versus
    results["agg_timing"] = timings
    return timings


def time_agg_orders(q, k, v, out, lse, dout, delta, layout, G,
                    causal=False):
    """The bf16 B6a, B6b and B6c kernels (at G = 1 the bf16 B5a's and
    B5b's) in the launch order they use (their blocks by visited tiles,
    the most first; the forward takes the dq order) against grid order
    (the units in index order), timed in turns, with the outputs of both
    orders bitwise equal; and the order itself: the tiles of the first
    and last blocks launched and the mean, and the dk/dv kernel's time
    over the dq kernel's in launch order beside their work ratio, 8·d
    against 6·d a pair."""
    s = q.shape[1]
    blk = s // layout.shape[1]
    luts = fbs.device_luts(layout, q.device)
    key = (G, blk, bool(causal))
    orders = luts.launch_order(*key)
    grid = tuple(torch.arange(o.numel(), dtype=torch.int32, device=q.device)
                 for o in orders)
    visits = fbs.super_tile_visits(layout, G, blk, causal)
    tiles = (visits.sum(axis=(2, 4)).ravel(), visits.sum(axis=(1, 3)).ravel())

    def run(kind):
        if kind == "fwd":
            return (fbs.flash_block_sparse_fwd(q, k, v, layout, causal)
                    if G == 1 else
                    fbs.flash_block_sparse_agg_fwd(q, k, v, layout, G, causal))
        if kind == "dq":
            return (fbs.flash_block_sparse_agg_bwd_dq(
                q, k, v, out, lse, dout, layout, G, causal, delta),)
        return fbs.flash_block_sparse_agg_bwd_dkv(q, k, v, out, lse, dout,
                                                  layout, G, causal, delta)

    row = {}
    try:
        for kind, i in (("fwd", 0), ("dq", 0), ("dkv", 1)):
            got = {}
            for turn, use in (("sorted", orders), ("grid", grid),
                              ("grid", grid), ("sorted", orders)):
                luts._orders[key] = use
                row.setdefault(f"{kind}_{turn}_ms", []).append(
                    device_ms(lambda: run(kind)))
                got[turn] = run(kind)
            check(all(torch.equal(a, b_) for a, b_ in zip(got["sorted"],
                                                          got["grid"])),
                  f"agg launch order at G={G}: the {kind} kernel's output "
                  f"differs between orders")
            order = orders[i].cpu().numpy()
            row[f"{kind}_tiles_first"] = int(tiles[i][order[0]])
            row[f"{kind}_tiles_last"] = int(tiles[i][order[-1]])
            row[f"{kind}_tiles_mean"] = float(tiles[i].mean())
    finally:
        luts._orders[key] = orders
    for name in [n for n in row if n.endswith("_ms")]:
        row[name] = statistics.mean(row[name])
    row["dkv_over_dq_sorted"] = row["dkv_sorted_ms"] / row["dq_sorted_ms"]
    row["work_ratio"] = 8 / 6
    return {"launch_order": row}


def bert_layer_flops(cfg, seq, q_len):
    """One BERT layer's forward flops with ``q_len`` query rows against
    ``seq`` keys (``bench.py:42-67``)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    return (2 * q_len * h * h + 2 * seq * h * 2 * h  # Q; K and V
            + 2 * q_len * seq * h * 2                # scores, context
            + 2 * q_len * h * h                      # attention out
            + 2 * q_len * h * i * 2)                 # FC1, FC2


def bert_flops_per_sample(cfg, seq, full_last_layer=False):
    """BERT fwd+bwd model flops per sample, as ``bench.py:42-67`` counts
    them: with the MLM gather the last layer runs its queries at the
    n_pred label positions and CLS only (unless ``full_last_layer``:
    Progressive Layer Drop turns that gather off), and the head projects
    those.  A recompute is not counted."""
    h, L, v = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    n_pred = min(cfg.max_predictions_per_seq or seq, seq)
    n_last = seq if n_pred == seq or full_last_layer else n_pred + 1
    head = 2 * n_pred * h * h + 2 * n_pred * h * v
    return 3 * ((L - 1) * bert_layer_flops(cfg, seq, seq)
                + bert_layer_flops(cfg, seq, n_last) + head)


def exact_count_mlm_labels(rng, ids, n_pred):
    """Labels with exactly ``n_pred`` masked positions a row, -100
    elsewhere: the bing_bert data contract (``bench.py:85``)."""
    b, s = ids.shape
    labels = np.full((b, s), -100, np.int32)
    for r in range(b):
        pos = rng.permutation(s)[:n_pred]
        labels[r, pos] = ids[r, pos]
    return labels


def bert_batch(rng, vocab, b, s, n_pred, attention_mask):
    """A bing_bert batch: token ids, token types 0 then 1 by halves,
    ``n_pred`` MLM labels a row, NSP labels, and ``attention_mask`` (an
    array, or None for packed sequences without padding)."""
    ids = rng.integers(0, vocab, size=(b, s))
    batch = {"input_ids": ids,
             "token_type_ids": np.repeat((np.arange(s) >= s // 2)[None],
                                         b, 0).astype(np.int64),
             "masked_lm_labels": exact_count_mlm_labels(rng, ids, n_pred),
             "next_sentence_labels": rng.integers(0, 2, size=(b,))}
    if attention_mask is not None:
        batch["attention_mask"] = attention_mask
    return batch


def bert_train_setup(config=TRAIN_CONFIG, mesh=None, **model_kw):
    """The BERT train phase's engine, model config and fixed batch on the
    card: BERT-large at full width and depth (24 layers, hidden 1024, 16
    heads, vocab 30528), bench.py's headline leg: seq 128, micro-batch
    64, an attention mask of ones, ``max_predictions_per_seq`` 20 with
    exactly 20 labels a row, NSP labels, dropout 0.1 at every site, Lamb
    lr 1e-4, ZeRO-2, bf16 (``config``: phase 18 swaps in fp16), random
    weights from ``SEED``; ``model_kw`` changes the model config (phase
    22); ``mesh`` is phase 30's.  ``examples/profile_torch_train.py
    --bert`` profiles this set-up."""
    cfg = BertConfig.bert_large(**dict(
        dict(vocab_size=BERT_VOCAB, hidden_dropout_prob=DROPOUT,
             attention_probs_dropout_prob=DROPOUT,
             max_predictions_per_seq=BERT_PRED), **model_kw))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=BertForPreTraining(cfg),
        model_parameters=setup_weights("bert train", bert_params, cfg),
        config=dict(config, train_batch_size=BERT_BATCH), mesh=mesh)
    batch = bert_batch(np.random.default_rng(SEED + 1), cfg.vocab_size,
                       BERT_BATCH, BERT_SEQ, BERT_PRED,
                       np.ones((BERT_BATCH, BERT_SEQ), np.int64))
    return engine, cfg, batch


def phase_bert_train(card, results):
    """Trains :func:`bert_train_setup`'s BERT-large: 2 warm-up and 5
    timed steps.  Each step launches B1 in every layer (the last at the
    21 gathered rows against 128 keys) and one backward a layer, B3
    where ``use_fused_backward`` takes it, else B2a+B2b; B4 inside every
    one of those launches."""
    engine, cfg, batch = bert_train_setup()
    losses, step_s, launches = run_steps("bert train", engine, batch, 2, 5)
    steps, layers = 7, cfg.num_hidden_layers
    fused = ((layers - 1) * fa.use_fused_backward(64, BERT_SEQ, BERT_SEQ,
                                                  torch.bfloat16)
             + fa.use_fused_backward(64, BERT_PRED + 1, BERT_SEQ,
                                     torch.bfloat16))
    want = {"B1": layers, "B3": fused, "B2a": layers - fused,
            "B2b": layers - fused, "B4": 2 * layers + (layers - fused)}
    check(all(launches[name] == n * steps for name, n in want.items())
          and only_launched(launches, tuple(want)),
          f"bert train: launches {launches}, expected {want} a step")
    samples_s = BERT_BATCH / step_s
    flops = bert_flops_per_sample(cfg, BERT_SEQ)
    receipt = {
        "card": card, "layers": layers, "hidden": cfg.hidden_size,
        "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size,
        "seq": BERT_SEQ, "micro_batch": BERT_BATCH,
        "max_predictions_per_seq": BERT_PRED, "dropout": DROPOUT,
        "losses": losses, "step_ms": 1e3 * step_s,
        "samples_per_s": samples_s, "tokens_per_s": samples_s * BERT_SEQ,
        "mfu": samples_s * flops / PEAK_FLOPS[torch.bfloat16],
        "model_flops_per_sample": flops,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches_per_step": {k: v / steps for k, v in launches.items()}}
    print("bert train receipt (BERT-large, 24 layers, seq 128, batch 64, "
          "MLM gather 20 + NSP, bf16, Lamb, ZeRO-2, dropout 0.1):",
          json.dumps(receipt))
    results["bert_train"] = receipt
    del engine
    torch.cuda.empty_cache()
    return launches


def bert_sparse_train_setup():
    """The sparse BERT train phase's engine, config and fixed batch:
    BERT-large with 4096 positions and ``attn_impl="sparse"`` under
    ``BERT_SPARSE_LAYOUT`` (128-row blocks: the JAX layer runs B6 with
    G = 4), seq 4096, micro-batch 2, no attention mask (packed documents,
    no padding, so every layer takes the kernels), token types 0 then 1
    by halves, ``max_predictions_per_seq`` 640, NSP, dropout 0.1, Lamb,
    ZeRO-2, bf16.  ``examples/profile_torch_train.py --bert-sparse``
    profiles this set-up."""
    b, _, s, _ = SPARSE_ATTN
    cfg = BertConfig.bert_large(
        vocab_size=BERT_VOCAB, max_position_embeddings=s,
        hidden_dropout_prob=DROPOUT, attention_probs_dropout_prob=DROPOUT,
        max_predictions_per_seq=BERT_SPARSE_PRED, attn_impl="sparse",
        sparsity_config=FixedSparsityConfig(**BERT_SPARSE_LAYOUT))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=BertForPreTraining(cfg), model_parameters=bert_params(cfg, SEED),
        config=dict(TRAIN_CONFIG, train_batch_size=b))
    batch = bert_batch(np.random.default_rng(SEED + 1), cfg.vocab_size, b, s,
                       BERT_SPARSE_PRED, None)
    return engine, cfg, batch


def phase_bert_sparse_train(card, results):
    """Trains :func:`bert_sparse_train_setup`'s model: 2 warm-up and 3
    timed steps, exactly one B6a, B6b and B6c launch per layer and step
    and no other kernel."""
    b, _, s, _ = SPARSE_ATTN
    engine, cfg, batch = bert_sparse_train_setup()
    losses, step_s, launches = run_steps("bert sparse train", engine, batch,
                                         2, 3)
    steps, layers = 5, cfg.num_hidden_layers
    check(only_launched(launches, ("B6a", "B6b", "B6c"), layers * steps),
          f"bert sparse train: launches {launches}, expected {layers * steps}"
          f" of B6a, B6b and B6c and nothing else")
    layout = engine.module.bert.layer._sparse_layout(s)
    super_counts = fbs.build_super_luts(layout, 4)[1]
    receipt = {
        "card": card, "layers": layers, "hidden": cfg.hidden_size,
        "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size, "seq": s,
        "micro_batch": b, "max_predictions_per_seq": BERT_SPARSE_PRED,
        "dropout": DROPOUT, "layout": BERT_SPARSE_LAYOUT,
        "layout_density": float(np.mean(layout != 0)),
        "super_tile_density": float(super_counts.mean())
        / super_counts.shape[1],
        "losses": losses, "step_ms": 1e3 * step_s,
        "samples_per_s": b / step_s, "tokens_per_s": b * s / step_s,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches_per_step": {k: v / steps for k, v in launches.items()}}
    print("bert sparse train receipt (BERT-large, 24 layers, seq 4096, batch "
          "2, MLM 640 + NSP, bf16, Lamb, ZeRO-2, dropout 0.1, Fixed "
          "bidirectional blk 128 sparse attention):", json.dumps(receipt))
    results["bert_sparse_train"] = receipt
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_bert_parity(results):
    """Card against CPU (:func:`card_vs_cpu`): 2 layers at BERT-large
    width, fp32, dropout 0.  Dense at seq 128 with padding in the mask
    and ``max_predictions_per_seq`` 20 (the last layer's query gather:
    B1 and B3 on the card); and sparse at seq 1024 under the train
    layout's config (128-row blocks, G = 4, two super-rows: B6a, B6b,
    B6c on the card, the gather path on the CPU)."""
    width = dict(vocab_size=BERT_VOCAB, hidden_size=1024,
                 num_hidden_layers=2, num_attention_heads=16,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    runs = {}
    rng = np.random.default_rng(SEED + 4)
    mask = np.ones((2, BERT_SEQ), np.int64)
    mask[1, BERT_SEQ - 40:] = 0
    dense = BertConfig(max_predictions_per_seq=BERT_PRED, **width)
    runs["dense"] = (dense, ("B1", "B3"), [
        bert_batch(rng, BERT_VOCAB, 2, BERT_SEQ, BERT_PRED, mask)
        for _ in range(6)])
    sparse = BertConfig(
        max_position_embeddings=BERT_PARITY_SEQ, attn_impl="sparse",
        sparsity_config=FixedSparsityConfig(**BERT_SPARSE_LAYOUT),
        max_predictions_per_seq=BERT_PARITY_SEQ * BERT_PRED // BERT_SEQ,
        **width)
    runs["sparse"] = (sparse, ("B6a", "B6b", "B6c"), [
        bert_batch(rng, BERT_VOCAB, 2, BERT_PARITY_SEQ,
                   sparse.max_predictions_per_seq, None) for _ in range(6)])
    total = {}
    for name, (cfg, kernels, batches) in runs.items():
        card, cpu, launches = card_vs_cpu(
            f"bert parity {name}", lambda: BertForPreTraining(cfg),
            bert_params(cfg, SEED), batches)
        expected = cfg.num_hidden_layers * 2 * 3
        check(only_launched(launches, kernels, expected),
              f"bert parity {name}: launches {launches}, expected {expected} "
              f"of {kernels} only")
        print(f"bert parity {name} (2 layers, hidden 1024, fp32, Adam + "
              f"WarmupLR, accumulation 2, clip 1.0): card {card}, cpu {cpu}, "
              f"max rel diff "
              f"{max(abs(a - b) / abs(b) for a, b in zip(card, cpu)):.3g}")
        results[f"bert_parity_{name}"] = {"card": card, "cpu": cpu,
                                          "launches": launches}
        total = {k: total.get(k, 0) + n for k, n in launches.items()}
    return total


# -------------------------------------------------------------- checkpoint
# phase 15: GPT-2-medium (4.97 GB of checkpoint) saved between steps and
# resumed; the files go under build/ in the checkout, which must have
# this much free space
CKPT_MIN_FREE_BYTES = 12 * 10 ** 9
CKPT_MICRO_BATCHES = 6
CKPT_CONFIG = dict(TRAIN_CONFIG, scheduler={
    "type": "WarmupLR", "params": {"warmup_min_lr": 0.0,
                                   "warmup_max_lr": 1e-4,
                                   "warmup_num_steps": 10}})


def checkpoint_setup(seed, config=CKPT_CONFIG):
    """Phase 15's engine: :func:`train_setup`'s GPT-2-medium and config
    (bf16, Lamb lr 1e-4, ZeRO-2, seq 1024, micro-batch 8, dropout 0.1)
    with a WarmupLR schedule and a dataloader over
    ``CKPT_MICRO_BATCHES`` distinct micro-batches of random tokens from
    numpy seed 0; the weights from ``seed``.  Phase 20 adds a
    ``resilience`` block to ``config``."""
    b, _, s, _ = TRAIN_ATTN
    cfg = GPT2Config.gpt2_medium(embd_dropout=DROPOUT, attn_dropout=DROPOUT,
                                 resid_dropout=DROPOUT)
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(CKPT_MICRO_BATCHES * b, s))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(cfg), model_parameters=random_params(cfg, seed),
        config=dict(config),
        training_data=[{"input_ids": row} for row in ids])
    return engine, cfg


def timed_steps(engine, n):
    """``n`` ``train_batch`` steps from the engine's dataloader, each
    between two synchronizations; the launch counts set to 0 just before
    and read just after.  Returns ``(losses, step seconds, step end
    times on the wall clock, launches)``."""
    torch.cuda.synchronize()
    reset_launches()
    losses, seconds, ends = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(engine.train_batch())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        ends.append(time.time())
    return [float(x) for x in losses], seconds, ends, read_launches()


def check_step_launches(label, launches, steps, layers):
    n = layers * steps
    check(launches["B1"] == launches["B2a"] == launches["B2b"] == n
          and launches["B4"] == 3 * n
          and only_launched(launches, ("B1", "B2a", "B2b", "B4")),
          f"{label}: launches {launches}, expected {n} of B1/B2a/B2b and "
          f"{3 * n} of B4")


def check_checkpoint_files(tag_dir, engine, params_at_save):
    """The committed files: manifest-verified, the JAX package's keys,
    byte sizes of the payloads, and the model states decoding to the
    step's bf16 params bitwise.  Returns ``{file: bytes}``."""
    status, problems = ckpt.verify_checkpoint(tag_dir)
    check(status == "ok", f"checkpoint: verify_checkpoint {status} "
          f"{problems}")
    n = int(sum(engine.segments.sizes))
    paths, leaves = tree_leaves(engine.flat.unflatten_params(params_at_save))
    keys = ["/".join(path) for path in paths]
    with np.load(os.path.join(tag_dir, ckpt.OPTIM_STATES_NPZ)) as npz:
        check(sorted(npz.files) == ["master", "opt/.exp_avg",
                                    "opt/.exp_avg_sq", "opt/.step"],
              f"checkpoint: optimizer keys {npz.files}")
        check(npz["opt/.step"].dtype == np.int32
              and int(npz["opt/.step"]) == 3, "checkpoint: opt/.step")
    sizes = {name: os.path.getsize(os.path.join(tag_dir, name))
             for name in sorted(os.listdir(tag_dir))}
    # payload bytes, plus at most 1 MB of npz headers and the zip index
    for name, payload in ((ckpt.MODEL_STATES_NPZ, 2 * n),
                          (ckpt.OPTIM_STATES_NPZ, 12 * n + 4)):
        check(payload <= sizes[name] <= payload + 2 ** 20,
              f"checkpoint: {name} holds {sizes[name]} bytes for "
              f"{payload} of payload")
    states = ckpt.load_model_states(tag_dir)
    check(sorted(states) == sorted(keys), "checkpoint: model-state keys")
    for key, leaf in zip(keys, leaves):
        check(states[key].dtype == torch.bfloat16
              and torch.equal(states[key].view(torch.int16),
                              leaf.view(torch.int16)),
              f"checkpoint: model state {key} is not the saved bf16 param")
    return sizes


def checkpoint_dir():
    """A fresh directory for phase 15's checkpoint under ``build/`` in
    the checkout, which must have ``CKPT_MIN_FREE_BYTES`` free; ``main``
    deletes it after phase 20 has rolled back to it."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    check(free >= CKPT_MIN_FREE_BYTES,
          f"checkpoint: {free} bytes free under {root}, the phase needs "
          f"{CKPT_MIN_FREE_BYTES}")
    return tempfile.mkdtemp(prefix="chip_smoke_checkpoint_", dir=root)


def phase_checkpoint(card, results, train_step_ms, save_dir):
    """Run A trains :func:`checkpoint_setup`'s GPT-2-medium 3 steps,
    saves asynchronously (the config default) into ``save_dir`` and takes
    3 more steps while the commit runs.  Run B, a fresh engine from other
    weights, loads the checkpoint strictly and takes 3 steps: its losses
    and final master must equal run A's last three and final master
    BITWISE (dropout 0.1: its streams follow the restored micro-step
    count; the dataloader resumes at its 4th micro-batch, the LR schedule
    at its 4th step).  Returns the launches and run A's last three losses
    and final master, which phase 20 holds its rollback to."""
    engine, cfg = checkpoint_setup(SEED)
    layers = cfg.num_layers
    first, _, _, launches_a = timed_steps(engine, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.save_checkpoint(save_dir)
    snapshot_s = time.perf_counter() - t0
    saved_wall = time.time()
    params_at_save = engine._compute.detach().to("cpu", copy=True)
    losses_a, inflight_s, ends, more = timed_steps(engine, 3)
    launches_a = {k: v + more[k] for k, v in launches_a.items()}
    check_step_launches("checkpoint run A", launches_a, 6, layers)
    engine.wait_checkpoint(save_dir)
    committed_wall = os.path.getmtime(
        os.path.join(save_dir, ckpt.LATEST_FILE))
    commit_s = committed_wall - saved_wall
    overlapped = sum(end < committed_wall for end in ends)
    tag_dir = os.path.join(save_dir, "global_step3")
    algorithm = ckpt.read_manifest(tag_dir)["checksum_algorithm"]
    sizes = check_checkpoint_files(tag_dir, engine, params_at_save)
    del params_at_save
    master_a = engine.master.to("cpu", copy=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    engine, _ = checkpoint_setup(SEED + 7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path, _ = engine.load_checkpoint(save_dir, strict=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(path == tag_dir and engine.global_steps == 3
          and engine.micro_steps == 3, f"checkpoint: loaded {path} at "
          f"step {engine.global_steps}")
    losses_b, resumed_s, _, launches_b = timed_steps(engine, 3)
    check_step_launches("checkpoint run B", launches_b, 3, layers)
    check(all(math.isfinite(x) for x in first + losses_a),
          f"checkpoint: losses {first + losses_a}")
    check(losses_b == losses_a, f"checkpoint: run B's losses "
          f"{losses_b} differ from run A's {losses_a}")
    check(torch.equal(engine.master.cpu(), master_a),
          "checkpoint: run B's final master differs from run A's")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    receipt = {
        "card": card, "file_bytes": sizes,
        "checkpoint_bytes": sum(sizes.values()),
        "snapshot_ms": 1e3 * snapshot_s, "commit_s": commit_s,
        "checksum_algorithm": algorithm, "load_s": load_s,
        "losses_a": first + losses_a, "losses_b": losses_b,
        "steps_overlapping_commit": overlapped,
        "inflight_step_ms": [1e3 * x for x in inflight_s],
        "inflight_step_ms_median": 1e3 * statistics.median(inflight_s),
        "resumed_step_ms": [1e3 * x for x in resumed_s],
        "resumed_step_ms_median": 1e3 * statistics.median(resumed_s),
        "train_phase_step_ms": train_step_ms}
    print(f"checkpoint (GPT-2-medium, bf16, Lamb, ZeRO-2, dropout 0.1; "
          f"{card}): files {sizes}; snapshot {receipt['snapshot_ms']:.1f} "
          f"ms (device to host), commit {commit_s:.2f} s ({algorithm}), "
          f"load {load_s:.2f} s; step ms with the commit in flight "
          f"{receipt['inflight_step_ms_median']:.2f} (median of 3, "
          f"{overlapped} overlapping it), after the resume "
          f"{receipt['resumed_step_ms_median']:.2f}, phase 6 "
          f"{train_step_ms:.2f}; run B's losses and master equal run A's "
          f"bitwise")
    print("checkpoint receipt:", json.dumps(receipt))
    results["checkpoint"] = receipt
    run_a = {"losses": losses_a, "master": master_a, "load_s": load_s}
    return {k: v + launches_b[k] for k, v in launches_a.items()}, run_a


# -------------------------------------------------------------------- fp16
# DeepSpeed's fp16 defaults (deepspeed_tpu/runtime/constants.py:57-67),
# which a config that sets only "enabled": true gets in the reference
FP16_SCALER = {"enabled": True, "loss_scale": 0, "initial_scale_power": 32,
               "loss_scale_window": 1000, "hysteresis": 2,
               "min_loss_scale": 1}
FP16_TRAIN_CONFIG = dict({k: v for k, v in TRAIN_CONFIG.items()
                          if k != "bf16"}, fp16=FP16_SCALER)
# the scale has settled when this many steps in a row apply
SETTLE_GOOD_STEPS = 3
SETTLE_MAX_STEPS = 40


def nonfinite_by_head(t):
    """[b, h] bool: whether each (batch, head) slice of a ``[b, n, h, d]``
    tensor holds a non-finite value."""
    return ~torch.isfinite(t.float()).all(dim=3).all(dim=1)


def check_fp16_nonfinite(label, q, k, v, mask, causal, dout, seed, fused):
    """An inf in dO gives non-finite dq, dk and dv from the kernels in
    exactly the (batch, head) slices where the plain version's are, and
    a NaN in q a non-finite out and lse where the plain forward's are."""
    keep, inv_keep = plain_keep(q, k, DROPOUT, seed)
    out, lse = flash_attention_fwd(q, k, v, mask, causal, DROPOUT, seed)
    bad = dout.clone()
    bad[0, q.shape[1] // 3, 1, 5] = float("inf")
    grads = kernel_chain(q, k, v, bad, mask, causal, DROPOUT, seed,
                         fused)[2:]
    ref = flash_attention_bwd_reference(q, k, v, out, lse, bad, mask, causal,
                                        keep, inv_keep)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        check(bool(nonfinite_by_head(want)[0, 1]) and torch.equal(
            nonfinite_by_head(got), nonfinite_by_head(want)),
            f"fp16 {label}: inf in dO: the kernel's non-finite {name} "
            f"slices differ from the plain version's")
    qn = q.clone()
    qn[0, q.shape[1] // 2, 2, 7] = float("nan")
    out, lse = flash_attention_fwd(qn, k, v, mask, causal, DROPOUT, seed)
    ref_out, ref_lse = flash_attention_reference(qn, k, v, mask, causal,
                                                 keep, inv_keep)
    check(bool(nonfinite_by_head(ref_out)[0, 2]) and torch.equal(
        nonfinite_by_head(out), nonfinite_by_head(ref_out)) and torch.equal(
        torch.isfinite(lse), torch.isfinite(ref_lse)),
        f"fp16 {label}: NaN in q: the kernel's non-finite out or lse "
        f"differs from the plain version's")


def fp16_compare(label, got, want, tol, errs, key):
    """``got`` against ``want`` at ``tol``; the max error joins
    ``errs[key]``."""
    check(bool(torch.isfinite(got.float()).all()),
          f"fp16 {label}: non-finite output")
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=lambda m: f"fp16 {label}: {m}")
    err = float((got.float() - want.float()).abs().max())
    errs[key] = max(errs.get(key, 0.0), err)
    return err


def phase_fp16_kernel(card, results):
    """16. B1, B2a, B2b and B3 in fp16, with B4 through dropout 0.1,
    against their plain versions on the same inputs: B1+B2a+B2b at
    GPT-2-medium's training attention (b=8, h=16, s=1024, d=64, causal,
    fused-QKV views) and B1+B3 at BERT's (b=64, h=16, s=128, a key mask
    of ones).  Device times per launch beside the bf16 kernels' of
    phases 3 (same shapes, same call), the bound (989 TFLOP/s fp16),
    the plain versions' and SDPA's in fp16; B2a+B2b at BERT's shape
    beside B3, on one precomputed Δ: ``use_fused_backward`` must take B3
    for fp16 exactly where it measured faster.  Then an inf in dO and a
    NaN in q at both shapes (:func:`check_fp16_nonfinite`).  Returns
    the max errors per kernel and the timings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    f16 = torch.float16
    tol, gtol = TOLS[f16], GRAD_TOLS[f16]
    errs, timing = {}, {}
    bf16_times = results["backward_timing"]

    # GPT-2-medium's training attention: B1, B2a, B2b (B4 inside)
    b, h, s, d = TRAIN_ATTN
    g = torch.Generator().manual_seed(SEED + 30)
    qkv = torch.randn(b, s, 3, h, d, generator=g).to(DEVICE, f16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.randn(b, s, h, d, generator=g).to(DEVICE, f16)
    seed = seed_words(SEED + 31)
    out, lse = flash_attention_fwd(q, k, v, None, True, DROPOUT, seed)
    keep, inv_keep = plain_keep(q, k, DROPOUT, seed)
    ref_out, ref_lse = flash_attention_reference(q, k, v, None, True, keep,
                                                 inv_keep)
    fp16_compare("train B1 out", out, ref_out, tol, errs, "B1")
    torch.testing.assert_close(lse, ref_lse, atol=BF16_LSE_TOL,
                               rtol=BF16_LSE_TOL)
    del ref_out, ref_lse
    args = (q, k, v, out, lse, dout, None, True, DROPOUT, seed)
    delta = fa._delta(out, dout)
    grads = (flash_attention_bwd_dq(*args, delta=delta),) \
        + flash_attention_bwd_dkv(*args, delta=delta)
    ref = flash_attention_bwd_reference(q, k, v, out, lse, dout, None, True,
                                        keep, inv_keep)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        fp16_compare(f"train {name}", got, want, gtol, errs,
                     "B2a" if name == "dq" else "B2b")
    del ref, grads, keep
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = dout.transpose(1, 2)
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            dropout_p=DROPOUT)
    sdpa_bwd = device_ms(lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dot, retain_graph=True))
    del o_sdpa

    def plain_bwd():
        kp, ik = plain_keep(q, k, DROPOUT, seed)
        return flash_attention_bwd_reference(q, k, v, out, lse, dout, None,
                                             True, kp, ik)

    bwd_plain = device_ms(plain_bwd, calls=1, repeats=3, warmup=1)
    b1_bound, b1_by = attention_bound(q, k, None, True)
    timing["B1"] = {
        "shape": "b=8 h=16 s=1024 d=64 causal, dropout 0.1",
        "kernel_ms": device_ms(lambda: flash_attention_fwd(
            q, k, v, None, True, DROPOUT, seed)),
        "bf16_kernel_ms": bf16_times["fwd_train"]["kernel_ms"],
        "plain_ms": device_ms(lambda: flash_attention_reference(
            q, k, v, None, True, *plain_keep(q, k, DROPOUT, seed)),
            calls=1, repeats=3, warmup=1),
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, dropout_p=DROPOUT)),
        "bound_ms": b1_bound, "bound_by": b1_by}
    for name, kind, fn in (("B2a", "dq", flash_attention_bwd_dq),
                           ("B2b", "dkv", flash_attention_bwd_dkv)):
        bound, by = backward_bound(kind, q, k, None, True)
        timing[name] = {
            "shape": "b=8 h=16 s=1024 d=64 causal, dropout 0.1, one Δ",
            "kernel_ms": device_ms(lambda: fn(*args, delta=delta)),
            "bf16_kernel_ms": bf16_times[kind]["kernel_ms"],
            "plain_ms": bwd_plain, "library_ms": sdpa_bwd,
            "bound_ms": bound, "bound_by": by}

    def chain(rate):
        return lambda: kernel_chain(q, k, v, dout, None, True, rate, seed,
                                    False)

    with_dropout = device_ms(chain(DROPOUT), calls=5, repeats=10)
    without = device_ms(chain(0.0), calls=5, repeats=10)
    timing["B4"] = {
        "shape": "B1+B2a+B2b with dropout 0.1 less without",
        "kernel_ms": with_dropout - without,
        "bf16_kernel_ms": bf16_times["dropout"]["kernel_ms"],
        "plain_ms": bf16_times["dropout"]["plain_ms"],
        "library_ms": None, "bound_ms": bf16_times["dropout"]["bound_ms"],
        "bound_by": "operations"}
    check_fp16_nonfinite("train", q, k, v, None, True, dout, seed, False)
    del qkv, q, k, v, dout, out, lse, qt, kt, vt, dot, delta

    # BERT's attention: B1 and B3 (B4 inside); B2a+B2b beside B3
    bb, bs = BERT_BATCH, BERT_SEQ
    mask = torch.ones(bb, bs, device=DEVICE)
    q, k, v, dout = (torch.randn(bb, bs, h, d, generator=g).to(DEVICE, f16)
                     for _ in range(4))
    seed = seed_words(SEED + 32)
    check(fa.fused_backward_fits(d, bs, bs, f16),
          "the fp16 B3 does not fit BERT's s=128")
    out, lse, *grads = kernel_chain(q, k, v, dout, mask, False, DROPOUT,
                                    seed, True)
    keep, inv_keep = plain_keep(q, k, DROPOUT, seed)
    ref_out, _ = flash_attention_reference(q, k, v, mask, False, keep,
                                           inv_keep)
    fp16_compare("bert B1 out", out, ref_out, tol, errs, "B1")
    ref = flash_attention_bwd_reference(q, k, v, out, lse, dout, mask, False,
                                        keep, inv_keep)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        fp16_compare(f"bert B3 {name}", got, want, gtol, errs, "B3")
    del ref, ref_out
    args = (q, k, v, out, lse, dout, mask, False, DROPOUT, seed)
    delta = fa._delta(out, dout)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt)
    dot = dout.transpose(1, 2)
    b3_bound, b3_by = backward_bound("fused", q, k, mask, False)
    bert_b1_bound, bert_b1_by = attention_bound(q, k, mask, False)
    timing["B3"] = {
        "shape": "b=64 h=16 s=128 d=64, key mask, dropout 0.1, one Δ",
        "kernel_ms": device_ms(lambda: flash_attention_bwd_fused(
            *args, delta=delta)),
        "bf16_kernel_ms": results["b3_bert"]["kernel_ms"],
        "b2_ms": device_ms(lambda: b2_pair(*args, delta=delta)),
        "plain_ms": device_ms(lambda: flash_attention_bwd_reference(
            q, k, v, out, lse, dout, mask, False, keep, inv_keep),
            calls=2, repeats=5),
        "library_ms": device_ms(lambda: torch.autograd.grad(
            o_sdpa, (qt, kt, vt), dot, retain_graph=True)),
        "bound_ms": b3_bound, "bound_by": b3_by,
        "rule_takes_b3": fa.use_fused_backward(d, bs, bs, f16)}
    del o_sdpa
    timing["B1_bert"] = {
        "shape": "b=64 h=16 s=128 d=64, key mask, dropout 0.1",
        "kernel_ms": device_ms(lambda: flash_attention_fwd(
            q, k, v, mask, False, DROPOUT, seed)),
        "bf16_kernel_ms": results["b1_bert"]["kernel_ms"],
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, dropout_p=DROPOUT)),
        "bound_ms": bert_b1_bound, "bound_by": bert_b1_by}
    t = timing["B3"]
    check(t["rule_takes_b3"] == (t["kernel_ms"] < t["b2_ms"]),
          f"the fp16 backward rule takes "
          f"{'B3' if t['rule_takes_b3'] else 'B2a+B2b'} at BERT's s=128, "
          f"where B3 measured {t['kernel_ms']:.5f} ms and B2a+B2b "
          f"{t['b2_ms']:.5f} ms")
    check_fp16_nonfinite("bert", q, k, v, mask, False, dout, seed, True)
    errs["B4"] = max(errs.values())
    print(f"fp16 kernels: tolerances out {tol}, lse {BF16_LSE_TOL}, grads "
          f"{gtol}; max |kernel-plain| " + " ".join(
              f"{k_}={v_:.3g}" for k_, v_ in errs.items())
          + f"; an inf in dO and a NaN in q stay non-finite in exactly the "
          f"plain version's (batch, head) slices at both shapes [{card}]")
    for name, row in timing.items():
        print(f"fp16 timing {name} ({row['shape']}): " + " ".join(
            f"{key}={val:.5f}" if isinstance(val, float) else
            f"{key}={val}" for key, val in row.items() if key != "shape")
            + f" [{card}]")
    results["fp16_kernel"] = {"errors": errs, "timing": timing}
    return errs, timing


def settle_scale(label, engine, batch):
    """fp16 steps on ``batch`` until ``SETTLE_GOOD_STEPS`` in a row apply
    (the dynamic scale comes down from 2^32 by halving, after one step of
    hysteresis); returns the trace of (loss scale, skipped steps)."""
    trace, good = [], 0
    for _ in range(SETTLE_MAX_STEPS):
        skipped = engine.skipped_steps
        engine.train_batch(iter([batch]))
        trace.append((engine.loss_scale, engine.skipped_steps))
        good = good + 1 if engine.skipped_steps == skipped else 0
        if good >= SETTLE_GOOD_STEPS:
            return trace
    check(False, f"{label}: the loss scale did not settle in "
          f"{SETTLE_MAX_STEPS} steps: {trace}")


def fp16_receipt(card, label, engine, trace, losses, step_s, launches,
                 steps, samples, flops, bf16):
    samples_s = samples / step_s
    receipt = {
        "card": card, "scale_trace": trace, "settle_steps": len(trace),
        "skipped_steps": engine.skipped_steps,
        "loss_scale": engine.loss_scale, "losses": losses,
        "step_ms": 1e3 * step_s, "samples_per_s": samples_s,
        "mfu": samples_s * flops / PEAK_FLOPS[torch.float16],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "bf16_step_ms": bf16["step_ms"], "bf16_mfu": bf16["mfu"],
        "bf16_peak_memory_bytes": bf16["peak_memory_bytes"]}
    print(f"{label}: scale settled after {len(trace)} steps, "
          f"{engine.skipped_steps} skipped, trace {trace}; step "
          f"{receipt['step_ms']:.2f} ms (bf16 {bf16['step_ms']:.2f}), MFU "
          f"{receipt['mfu']:.4f} (bf16 {bf16['mfu']:.4f}), peak memory "
          f"{receipt['peak_memory_bytes'] / 1e9:.2f} GB (bf16 "
          f"{bf16['peak_memory_bytes'] / 1e9:.2f}) [{card}]")
    print(f"{label} receipt:", json.dumps(receipt))
    return receipt


def check_all_fp16(label, launches, want):
    """Every attention launch in ``want`` ({name: count}) came to that
    count, all of them fp16, and nothing else launched."""
    names = tuple(want) + tuple(f"{n} fp16" for n in want)
    check(all(launches[n] == c and launches[f"{n} fp16"] == c
              for n, c in want.items())
          and only_launched(launches, names),
          f"{label}: launches {launches}, expected {want}, all fp16")


def phase_fp16_train(card, results):
    """17. :func:`train_setup`'s GPT-2-medium (phase 6's configuration) in
    fp16 under ``FP16_SCALER``: steps until the scale settles, then 2
    warm-up and 5 timed steps; finite, falling losses, one fp16 B1, B2a
    and B2b (and three B4) a layer a step and no bf16 or fp32 attention
    launch; step ms, MFU and peak memory beside phase 6's."""
    b, _, s, _ = TRAIN_ATTN
    engine, cfg, batch = train_setup(FP16_TRAIN_CONFIG)
    check(engine.compute_dtype == torch.float16, "fp16 train: not fp16")
    trace = settle_scale("fp16 train", engine, batch)
    losses, step_s, launches = run_steps("fp16 train", engine, batch, 2, 5)
    steps, layers = 7, cfg.num_layers
    n = layers * steps
    check_all_fp16("fp16 train", launches,
                   {"B1": n, "B2a": n, "B2b": n, "B4": 3 * n})
    results["fp16_train"] = fp16_receipt(
        card, "fp16 train (GPT-2-medium, 24 layers, seq 1024, batch 8, "
        "fp16, Lamb, ZeRO-2, dropout 0.1)", engine, trace, losses, step_s,
        launches, steps, b, gpt2_model_flops_per_sample(cfg, s),
        results["train"])
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_fp16_bert_train(card, results):
    """18. :func:`bert_train_setup`'s BERT-large (phase 12's
    configuration) in fp16 under ``FP16_SCALER``: steps until the scale
    settles, then 2 warm-up and 5 timed steps; finite, falling losses,
    one fp16 B1 and one fp16 B3 (B4 in both) a layer a step and no other
    attention launch; step ms, MFU and peak memory beside phase 12's."""
    engine, cfg, batch = bert_train_setup(FP16_TRAIN_CONFIG)
    check(engine.compute_dtype == torch.float16, "fp16 bert: not fp16")
    trace = settle_scale("fp16 bert train", engine, batch)
    losses, step_s, launches = run_steps("fp16 bert train", engine, batch,
                                         2, 5)
    steps, layers = 7, cfg.num_hidden_layers
    check(fa.use_fused_backward(64, BERT_SEQ, BERT_SEQ, torch.float16)
          and fa.use_fused_backward(64, BERT_PRED + 1, BERT_SEQ,
                                    torch.float16),
          "fp16 bert train: the fp16 rule does not take B3 at BERT's shapes")
    n = layers * steps
    check_all_fp16("fp16 bert train", launches,
                   {"B1": n, "B3": n, "B4": 2 * n})
    results["fp16_bert_train"] = fp16_receipt(
        card, "fp16 bert train (BERT-large, 24 layers, seq 128, batch 64, "
        "MLM gather 20 + NSP, fp16, Lamb, ZeRO-2, dropout 0.1)", engine,
        trace, losses, step_s, launches, steps, BERT_BATCH,
        bert_flops_per_sample(cfg, BERT_SEQ), results["bert_train"])
    del engine
    torch.cuda.empty_cache()
    return launches


FP16_PARITY_CONFIG = {
    "train_batch_size": 1, "steps_per_print": 10 ** 9,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
    "fp16": {"enabled": True, "initial_scale_power": 16,
             "loss_scale_window": 1000, "hysteresis": 2,
             "min_loss_scale": 1}}
FP16_PARITY_RTOL = 1e-2
FP16_POISON_STEP = 2
# The CPU side runs torch's fp16 matmuls, which on the card machine's host
# are far slower than its fp32 ones, at a cost that follows the weights
# more than the rows: this phase took 120.7 s on an H100 host at vocab
# 50304 with 32 tokens a step (PERF.md).  So the vocab is cut to 4096 and
# the tokens to one sequence of 32; the layers keep GPT-2-medium's width.
FP16_PARITY_SEQ = 32
FP16_PARITY_VOCAB = 4096


def phase_fp16_parity(results):
    """19. 2 layers at GPT-2-medium width (hidden 1024, 16 heads), vocab
    ``FP16_PARITY_VOCAB``, one sequence of ``FP16_PARITY_SEQ`` tokens a
    step, dropout 0,
    fp16 with a dynamic scale from 2^16 (where 1/scale is exact in fp16):
    4 steps on the card and on the CPU from the same weights and batches,
    with an inf written into one compute parameter (layer 0's ``fc1``
    bias) before step 3.  The skip pattern and the scale trace are
    equal; the applied steps' losses agree to rtol 1e-2 (fp16 products
    round at other places on the card and the CPU).  On the card: fp16
    B1 and B3 only."""
    cfg = GPT2Config(hidden_size=1024, num_heads=16, num_layers=2,
                     vocab_size=FP16_PARITY_VOCAB, embd_dropout=0.0,
                     attn_dropout=0.0, resid_dropout=0.0)
    params = random_params(cfg, SEED)
    rng = np.random.default_rng(SEED + 33)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size,
                                          size=(1, FP16_PARITY_SEQ))}
               for _ in range(4)]
    runs, launches = {}, None
    for where, device in (("card", DEVICE), ("cpu", torch.device("cpu"))):
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=GPT2LMHead(cfg), model_parameters=params,
            config=dict(FP16_PARITY_CONFIG), device=device)
        if where == "card":
            torch.cuda.synchronize()
            reset_launches()
        it = iter(batches)
        trace = []
        for step in range(len(batches)):
            if step == FP16_POISON_STEP:
                with torch.no_grad():
                    engine.params["blocks"]["layer_0"]["fc1"]["bias"][0] = \
                        float("inf")
            loss = float(engine.train_batch(it))
            trace.append((loss, engine.loss_scale, engine.skipped_steps))
        if where == "card":
            torch.cuda.synchronize()
            launches = read_launches()
        runs[where] = trace
        del engine
    card, cpu = runs["card"], runs["cpu"]
    check([t[1:] for t in card] == [t[1:] for t in cpu]
          and card[-1][2] == 1,
          f"fp16 parity: skip pattern and scale trace differ: card "
          f"{card}, cpu {cpu}")
    applied = [i for i in range(len(batches)) if i != FP16_POISON_STEP]
    got = [card[i][0] for i in applied]
    want = [cpu[i][0] for i in applied]
    check(np.allclose(got, want, rtol=FP16_PARITY_RTOL, atol=0.0),
          f"fp16 parity: applied losses card {got} vs cpu {want}")
    n = cfg.num_layers * len(batches)
    check_all_fp16("fp16 parity", launches, {"B1": n, "B3": n})
    print(f"fp16 parity (2 layers, hidden 1024, vocab {FP16_PARITY_VOCAB}, "
          f"1 x {FP16_PARITY_SEQ} tokens, fp16 from scale "
          f"2^16, Adam, inf in a compute param before step "
          f"{FP16_POISON_STEP + 1}): card (loss, scale, skipped) {card}, "
          f"cpu {cpu}; applied losses within rtol {FP16_PARITY_RTOL} (max "
          f"rel diff {max(abs(a - b) / abs(b) for a, b in zip(got, want)):.3g})")
    results["fp16_parity"] = {"card": card, "cpu": cpu,
                              "launches": launches}
    return launches


ROLLBACK_RESILIENCE = {"enabled": True, "policy": "rollback",
                       "divergence_patience": 2}


def phase_rollback(card, results, save_dir, run_a):
    """20. A fresh :func:`checkpoint_setup` GPT-2-medium (bf16, other
    weights) with ``resilience`` ``ROLLBACK_RESILIENCE`` rolling back to
    ``save_dir`` (phase 15's committed step-3 checkpoint): one element of
    its fp32 master is set to inf and cast into the compute params, so
    its first two steps have non-finite gradients (a compute-parameter
    poison alone would heal at the step's cast from the master, as in
    the JAX engine), are skipped, and the second rolls back.  The next
    three steps equal phase 15's run A, steps 4-6, bitwise in losses and
    in the final master.  Prints the rollback's wall time (the load
    included) beside phase 15's load."""
    config = dict(CKPT_CONFIG, resilience=dict(ROLLBACK_RESILIENCE,
                                               checkpoint_dir=save_dir))
    engine, cfg = checkpoint_setup(SEED + 9, config)
    manager, rollback_s = engine._rollback_mgr, []
    restore = manager.rollback

    def timed_rollback(reason=""):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = restore(reason=reason)
        torch.cuda.synchronize()
        rollback_s.append(time.perf_counter() - t0)
        return path

    manager.rollback = timed_rollback
    with torch.no_grad():
        engine.master.view(-1)[0] = float("inf")
        engine._refresh_params()
    bad = [float(engine.train_batch()) for _ in range(2)]
    check(not any(math.isfinite(x) for x in bad)
          and manager.rollbacks_used == 1 and len(rollback_s) == 1
          and engine.global_steps == 3 and engine.micro_steps == 3,
          f"rollback: losses {bad}, {manager.rollbacks_used} rollbacks, at "
          f"step {engine.global_steps}")
    losses, step_s, _, launches = timed_steps(engine, 3)
    check_step_launches("rollback", launches, 3, cfg.num_layers)
    check(losses == run_a["losses"], f"rollback: losses {losses} after the "
          f"rollback differ from run A's {run_a['losses']}")
    check(torch.equal(engine.master.cpu(), run_a["master"]),
          "rollback: the final master differs from run A's")
    receipt = {"card": card, "poisoned_losses": bad,
               "rollback_s": rollback_s[0],
               "checkpoint_load_s": run_a["load_s"],
               "losses": losses, "step_ms": [1e3 * x for x in step_s],
               "skipped_steps": engine.skipped_steps}
    print(f"rollback (GPT-2-medium, bf16, resilience policy rollback, "
          f"patience 2; {card}): two poisoned steps skipped, the guard "
          f"rolled back to global_step3 in {rollback_s[0]:.2f} s (phase 15's "
          f"load {run_a['load_s']:.2f} s); the next 3 steps equal run A's "
          f"bitwise in losses and master")
    print("rollback receipt:", json.dumps(receipt))
    results["rollback"] = receipt
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------- remat
# phases 21-25: activation checkpointing (the config block), the chunked
# LM loss, Progressive Layer Drop and the BERT fine-tuning heads
ACT_CKPT_CONFIG = dict(TRAIN_CONFIG, activation_checkpointing={})
REMAT_STEPS = 5
REMAT_CHUNK = 128
REMAT_BIG_BATCH = 32
# the first step's loss, on the same weights, with and without loss_chunk
CHUNK_RTOL = 1e-5
# DeepSpeed's Progressive Layer Drop tutorial for bing_bert
PLD_CONFIG = {"enabled": True, "theta": 0.5, "gamma": 0.001}
# BingBertSquad: seq 384, batch 24, Adam lr 3e-5; prompts padded from
# random lengths in [128, 384]; 2 rows with answers past the window
SQUAD_SEQ, SQUAD_BATCH, SQUAD_MIN_LEN, SQUAD_TRUNCATED = 384, 24, 128, 2
# GLUE MNLI: 3 labels, seq 128, batch 32, Adam lr 3e-5
MNLI_SEQ, MNLI_BATCH, MNLI_LABELS, MNLI_MIN_LEN = 128, 32, 3, 32
FINETUNE_CONFIG = {"steps_per_print": 10 ** 9,
                   "optimizer": {"type": "Adam", "params": {"lr": 3e-5}},
                   "bf16": {"enabled": True}}


def stepped(label, engine, batch, steps, after=None, falling=True):
    """``steps`` ``train_batch`` steps on one batch, each between two
    synchronizations, with the peak memory and the launch counts set to
    0 just before; ``after(engine)`` runs after each step, outside its
    time.  Checks finite losses, and unless ``falling`` is false (the
    fine-tuning phases read their eval loss instead) the last below the
    first.  Returns ``(losses, step seconds, launches, peak
    bytes)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, seconds = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = engine.train_batch(iter([batch]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if after is not None:
            after(engine)
    launches, peak = read_launches(), torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")
    check(not falling or losses[-1] < losses[0], f"{label}: the last loss "
          f"{losses[-1]} is not below the first {losses[0]}")
    return losses, seconds, launches, peak


def fwd_bwd_peak(engine, batch):
    """One more step on ``batch``, outside any counted window: the peak
    memory of its forward and backward alone (the activations at their
    most), then its update."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.backward(engine.forward(batch))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    engine.step()
    return peak


def train_receipt(card, label, run, warmup, samples, seq, flops, **extra):
    """A phase's numbers: step ms over the steps after ``warmup``,
    samples/s, tokens/s, MFU by model flops (``flops`` a sample, a
    recompute not counted), peak memory, launches a step."""
    losses, seconds, launches, peak = run
    step_s = statistics.mean(seconds[warmup:])
    samples_s = samples / step_s
    receipt = dict({
        "card": card, "losses": losses, "step_ms": 1e3 * step_s,
        "samples_per_s": samples_s, "tokens_per_s": samples_s * seq,
        "mfu": samples_s * flops / PEAK_FLOPS[torch.bfloat16],
        "model_flops_per_sample": flops, "peak_memory_bytes": peak,
        "launches_per_step": {k: v / len(losses)
                              for k, v in launches.items()}}, **extra)
    print(f"{label}: step {receipt['step_ms']:.2f} ms, "
          f"{receipt['tokens_per_s']:.0f} tokens/s, MFU "
          f"{receipt['mfu']:.4f}, peak memory {peak / 1e9:.2f} GB [{card}]")
    print(f"{label} receipt:", json.dumps(receipt))
    return receipt


def expect_launches(label, launches, want):
    check(all(launches[name] == n for name, n in want.items())
          and only_launched(launches, tuple(want)),
          f"{label}: launches {launches}, expected {want}")


def release(engine):
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # the pinned host blocks of an offload engine's state go back too
    getattr(torch._C, "_host_emptyCache", lambda: None)()


def phase_remat(card, results):
    """21. :func:`train_setup`'s GPT-2-medium (phase 6's configuration)
    under the ``activation_checkpointing`` config block, ``REMAT_STEPS``
    steps each on one batch: first the run without it, keeping a host
    copy of the master after each step; then (a) remat alone: losses and
    the master after every step bitwise the run without it, B1 (B4
    inside) twice a layer a step, forward and recompute; (b) with
    ``loss_chunk`` 128: the first step's loss (the same weights) within
    rtol ``CHUNK_RTOL`` of the full-logits one; (c) with
    ``cpu_checkpointing`` too: losses bitwise (b)'s, the layer inputs in
    pinned host memory; (d) remat and ``loss_chunk`` at micro-batch 32,
    which the step without remat cannot hold in 80 GB: 2 warm-up and 3
    timed steps, finite and falling.  Step ms, tokens/s, MFU (recompute
    not counted) and peak memory for each, and the peak of one more
    step's forward and backward alone (:func:`fwd_bwd_peak`)."""
    s = TRAIN_ATTN[2]
    # what earlier phases left for the collector would count in this
    # phase's peaks (5.7 GB of an engine once, measured on one H100)
    gc.collect()
    torch.cuda.empty_cache()
    start_bytes = torch.cuda.memory_allocated()
    engine, cfg, batch = train_setup()
    layers = cfg.num_layers
    flops = gpt2_model_flops_per_sample(cfg, s)
    masters = []
    base = stepped("remat: the run without it", engine, batch, REMAT_STEPS,
                   lambda e: masters.append(e.master.to("cpu", copy=True)))
    base_peak = fwd_bwd_peak(engine, batch)
    release(engine)
    # seq 1024 takes B2a+B2b; B4 is inside B1, B2a and B2b
    remat_launches = {name: k * layers * REMAT_STEPS for name, k in
                      (("B1", 2), ("B2a", 1), ("B2b", 1), ("B4", 4))}
    receipts, total = {}, {}
    b = TRAIN_ATTN[0]
    receipts["none"] = train_receipt(card, "remat: none (batch 8)", base, 1,
                                     b, s, flops,
                                     fwd_bwd_peak_bytes=base_peak)
    runs = (("remat", {}, {}, "remat (batch 8)"),
            ("chunk", {}, {"loss_chunk": REMAT_CHUNK},
             f"remat + loss_chunk {REMAT_CHUNK} (batch 8)"),
            ("cpu", {"cpu_checkpointing": True},
             {"loss_chunk": REMAT_CHUNK},
             f"remat + loss_chunk {REMAT_CHUNK} + cpu_checkpointing "
             f"(batch 8)"))
    out = {}
    for name, block, model_kw, label in runs:
        engine, cfg, batch = train_setup(
            dict(TRAIN_CONFIG, activation_checkpointing=block), **model_kw)
        check(cfg.remat, f"{label}: the config block did not turn remat on")
        step = iter(range(REMAT_STEPS))

        def same_master(e, label=label):
            i = next(step)
            check(name != "remat" or torch.equal(e.master.to("cpu"),
                                                 masters[i]),
                  f"{label}: the master after step {i + 1} differs from the "
                  f"run without remat")

        out[name] = stepped(label, engine, batch, REMAT_STEPS, same_master)
        extra = {"fwd_bwd_peak_bytes": fwd_bwd_peak(engine, batch)}
        release(engine)
        expect_launches(label, out[name][2], remat_launches)
        total = {k: total.get(k, 0) + v for k, v in out[name][2].items()}
        if name == "chunk":
            rel = [abs(x - y) / abs(y) for x, y in zip(out[name][0],
                                                        base[0])]
            check(rel[0] <= CHUNK_RTOL, f"{label}: the first loss "
                  f"{out[name][0][0]} vs the full-logits {base[0][0]}")
            extra["rel_diff_to_full_logits"] = rel
        if name == "cpu":
            extra["host_bytes"] = layers * b * s * cfg.hidden_size * 2
        receipts[name] = train_receipt(card, label, out[name], 1, b, s,
                                       flops, **extra)
    check(out["remat"][0] == base[0], f"remat: losses {out['remat'][0]} "
          f"differ from the run without remat {base[0]}")
    check(out["cpu"][0] == out["chunk"][0], f"remat + cpu_checkpointing: "
          f"losses {out['cpu'][0]} differ from {out['chunk'][0]}")
    engine, cfg, batch = train_setup(ACT_CKPT_CONFIG,
                                     micro_batch=REMAT_BIG_BATCH,
                                     loss_chunk=REMAT_CHUNK)
    label = (f"remat + loss_chunk {REMAT_CHUNK} (batch {REMAT_BIG_BATCH})")
    big = stepped(label, engine, batch, REMAT_STEPS)
    big_peak = fwd_bwd_peak(engine, batch)
    release(engine)
    expect_launches(label, big[2], remat_launches)
    total = {k: total.get(k, 0) + v for k, v in big[2].items()}
    receipts["batch32"] = train_receipt(card, label, big, 2,
                                        REMAT_BIG_BATCH, s, flops,
                                        fwd_bwd_peak_bytes=big_peak)
    receipts["allocated_at_start_bytes"] = start_bytes
    results["remat"] = receipts
    return total


def bert_pld_setup(pld, **model_kw):
    config = dict(ACT_CKPT_CONFIG)
    if pld is not None:
        config["progressive_layer_drop"] = pld
    return bert_train_setup(config, **model_kw)


def phase_bert_pld(card, results):
    """22. :func:`bert_train_setup`'s BERT-large (phase 12's
    configuration) under remat and Progressive Layer Drop (``PLD_CONFIG``):
    2 warm-up and 5 timed steps; θ after each step on its schedule; PLD
    turns the MLM query gather of the last layer off, so B1 runs at 128
    rows in every layer, twice (forward and recompute), and the backward
    once.  Then without the MLM gather, 3 steps under PLD with θ̄ = 1
    (θ stays 1) are bitwise 3 steps without PLD, losses and master."""
    engine, cfg, batch = bert_pld_setup(PLD_CONFIG)
    thetas = []
    run = stepped("bert pld", engine, batch, 7, lambda e: thetas.append(
        e.progressive_layer_drop.get_theta()))
    pld_peak = fwd_bwd_peak(engine, batch)
    release(engine)
    want = [(1.0 - PLD_CONFIG["theta"]) * math.exp(-PLD_CONFIG["gamma"] * t)
            + PLD_CONFIG["theta"] for t in range(1, 8)]
    check(np.allclose(thetas, want, rtol=1e-12, atol=0.0),
          f"bert pld: theta {thetas}, the schedule gives {want}")
    layers = cfg.num_hidden_layers
    fused = fa.use_fused_backward(64, BERT_SEQ, BERT_SEQ, torch.bfloat16)
    n = layers * 7
    bwd = {"B3": n} if fused else {"B2a": n, "B2b": n}
    expect_launches("bert pld", run[2],
                    dict(bwd, B1=2 * n, B4=2 * n + n * (1 if fused else 2)))
    total = dict(run[2])
    receipt = train_receipt(
        card, "bert pld (BERT-large, remat, PLD theta 0.5 gamma 0.001)", run,
        2, BERT_BATCH, BERT_SEQ,
        bert_flops_per_sample(cfg, BERT_SEQ, full_last_layer=True),
        thetas=thetas, fwd_bwd_peak_bytes=pld_peak)
    same = []
    for pld in ({"enabled": True, "theta": 1.0, "gamma": 0.001}, None):
        engine, cfg, batch = bert_pld_setup(pld, max_predictions_per_seq=None)
        losses, _, launches, _ = stepped("bert pld theta 1", engine, batch, 3)
        same.append((losses, engine.master.to("cpu")))
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        release(engine)
    check(same[0][0] == same[1][0] and torch.equal(same[0][1], same[1][1]),
          f"bert pld: at theta 1 the losses {same[0][0]} or the master "
          f"differ from the run without PLD {same[1][0]}")
    receipt["theta_one_losses"] = same[0][0]
    results["bert_pld"] = receipt
    return total


def padded(rng, b, s, min_len):
    """Token ids padded (id 0, mask 0) from random lengths in
    ``[min_len, s]``, token types 1 from a random split on; returns
    ``(batch, lengths)``."""
    lengths = rng.integers(min_len, s + 1, size=b)
    visible = np.arange(s)[None] < lengths[:, None]
    ids = np.where(visible, rng.integers(1, BERT_VOCAB, size=(b, s)), 0)
    split = rng.integers(min_len // 4, min_len // 2 + 1, size=b)
    types = (visible & (np.arange(s)[None] >= split[:, None]))
    return {"input_ids": ids, "attention_mask": visible.astype(np.int64),
            "token_type_ids": types.astype(np.int64)}, lengths


def finetune_engine(model, batch_size):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=model.init(SEED),
        config=dict(FINETUNE_CONFIG, train_batch_size=batch_size))
    return engine


def phase_squad(card, results):
    """23. BERT-large SQuAD fine-tuning (``BertForQuestionAnsweringTPU``,
    the BingBertSquad flow): seq 384, batch 24, Adam lr 3e-5, bf16,
    dropout 0.1, prompts padded from random lengths in [128, 384] (the
    key mask: ragged key padding through B1, B2a and B2b), answers inside
    each prompt, and ``SQUAD_TRUNCATED`` rows whose answer lies past the
    window (position 384): the eval loss equals the one with those rows'
    positions at -100.  2 warm-up and 5 timed steps, finite, and the eval
    loss (no dropout) after them below the one before; one B1, B2a and
    B2b (B4 in each) a layer a step."""
    cfg = BertConfig.bert_large(vocab_size=BERT_VOCAB,
                                hidden_dropout_prob=DROPOUT,
                                attention_probs_dropout_prob=DROPOUT)
    model = BertForQuestionAnsweringTPU(cfg)
    engine = finetune_engine(model, SQUAD_BATCH)
    rng = np.random.default_rng(SEED + 5)
    batch, lengths = padded(rng, SQUAD_BATCH, SQUAD_SEQ, SQUAD_MIN_LEN)
    start = rng.integers(SQUAD_MIN_LEN // 2, lengths)
    end = np.minimum(start + rng.integers(0, 30, size=SQUAD_BATCH),
                     lengths - 1)
    start[:SQUAD_TRUNCATED] = end[:SQUAD_TRUNCATED] = SQUAD_SEQ
    batch.update(start_positions=start, end_positions=end)
    ignored = dict(batch, start_positions=np.where(start >= SQUAD_SEQ, -100,
                                                   start),
                   end_positions=np.where(end >= SQUAD_SEQ, -100, end))
    before = engine.eval_batch(batch)
    check(torch.equal(before, engine.eval_batch(ignored)),
          "squad: answers past the window are not ignored")
    run = stepped("squad", engine, batch, 7, falling=False)
    after = float(engine.eval_batch(batch))
    check(after < float(before), f"squad: the eval loss {after} after the "
          f"steps is not below {float(before)} before them")
    release(engine)
    layers, n = cfg.num_hidden_layers, cfg.num_hidden_layers * 7
    fused = fa.use_fused_backward(64, SQUAD_SEQ, SQUAD_SEQ, torch.bfloat16)
    bwd = {"B3": n} if fused else {"B2a": n, "B2b": n}
    expect_launches("squad", run[2],
                    dict(bwd, B1=n, B4=n * (2 if fused else 3)))
    flops = 3 * (layers * bert_layer_flops(cfg, SQUAD_SEQ, SQUAD_SEQ)
                 + 2 * SQUAD_SEQ * cfg.hidden_size * 2)
    results["squad"] = train_receipt(
        card, "squad (BERT-large, seq 384, batch 24, Adam, bf16)", run, 2,
        SQUAD_BATCH, SQUAD_SEQ, flops, eval_loss=[float(before), after],
        lengths=lengths.tolist(),
        visible_token_share=float(lengths.sum()) / (SQUAD_BATCH * SQUAD_SEQ))
    return run[2]


def phase_mnli(card, results):
    """24. BERT-large sequence classification
    (``BertForSequenceClassificationTPU``, 3 labels, MNLI-style): seq
    128, batch 32, Adam lr 3e-5, bf16, dropout 0.1, padded from random
    lengths in [32, 128], random labels; 2 warm-up and 3 timed steps,
    finite; one B1 and one backward (B3 where ``use_fused_backward``
    takes it) a layer a step.  The eval loss before and after the steps
    is reported, not held to fall: from random weights, five Adam steps
    at lr 3e-5 on random labels raised it (1.1263 to 1.1514, PERF.md);
    phase 25 holds this head's loss and gradients, card against CPU."""
    cfg = BertConfig.bert_large(vocab_size=BERT_VOCAB,
                                hidden_dropout_prob=DROPOUT,
                                attention_probs_dropout_prob=DROPOUT)
    model = BertForSequenceClassificationTPU(cfg, num_labels=MNLI_LABELS)
    engine = finetune_engine(model, MNLI_BATCH)
    rng = np.random.default_rng(SEED + 6)
    batch, lengths = padded(rng, MNLI_BATCH, MNLI_SEQ, MNLI_MIN_LEN)
    batch["labels"] = rng.integers(0, MNLI_LABELS, size=MNLI_BATCH)
    before = float(engine.eval_batch(batch))
    run = stepped("mnli", engine, batch, 5, falling=False)
    after = float(engine.eval_batch(batch))
    check(math.isfinite(after), f"mnli: the eval loss {after}")
    release(engine)
    layers, n = cfg.num_hidden_layers, cfg.num_hidden_layers * 5
    fused = fa.use_fused_backward(64, MNLI_SEQ, MNLI_SEQ, torch.bfloat16)
    bwd = {"B3": n} if fused else {"B2a": n, "B2b": n}
    expect_launches("mnli", run[2],
                    dict(bwd, B1=n, B4=n * (2 if fused else 3)))
    h = cfg.hidden_size
    flops = 3 * (layers * bert_layer_flops(cfg, MNLI_SEQ, MNLI_SEQ)
                 + 2 * h * h + 2 * h * MNLI_LABELS)
    results["mnli"] = train_receipt(
        card, "mnli (BERT-large, seq 128, batch 32, 3 labels, Adam, bf16)",
        run, 2, MNLI_BATCH, MNLI_SEQ, flops, eval_loss=[before, after],
        lengths=lengths.tolist())
    return run[2]


REMAT_PARITY_CASES = {
    # name: (head, config changes, pld_theta)
    "remat": ("pretrain", {"remat": True}, None),
    "gelu_checkpoint": ("pretrain", {"gelu_checkpoint": True}, None),
    "attn_dropout_checkpoint": ("pretrain",
                                {"attn_dropout_checkpoint": True}, None),
    "normalize_invertible": ("pretrain", {"normalize_invertible": True},
                             None),
    "pld_theta_0": ("pretrain", {"remat": True}, 0.0),
    "pld_theta_1": ("pretrain", {"remat": True}, 1.0),
    "qa_remat": ("qa", {"remat": True}, None),
    "mnli_remat": ("mnli", {"remat": True}, None),
}


def parity_head(head, cfg):
    if head == "qa":
        return BertForQuestionAnsweringTPU(cfg)
    if head == "mnli":
        return BertForSequenceClassificationTPU(cfg, num_labels=MNLI_LABELS)
    return BertForPreTraining(cfg)


def parity_batches(rng):
    """The parity phase's batch of each head: 2 rows at seq 128, the
    second padded (pretraining: its last 40 keys; the heads: random
    lengths), 20 MLM labels and NSP; span positions, one of them past
    the window; 3-way labels."""
    mask = np.ones((2, BERT_SEQ), np.int64)
    mask[1, BERT_SEQ - 40:] = 0
    batches = {"pretrain": bert_batch(rng, BERT_VOCAB, 2, BERT_SEQ,
                                      BERT_PRED, mask)}
    qa, lengths = padded(rng, 2, BERT_SEQ, MNLI_MIN_LEN)
    qa.update(start_positions=np.array([lengths[0] // 2, BERT_SEQ]),
              end_positions=np.array([lengths[0] - 1, lengths[1] - 1]))
    mnli, _ = padded(rng, 2, BERT_SEQ, MNLI_MIN_LEN)
    mnli["labels"] = rng.integers(0, MNLI_LABELS, size=2)
    batches.update(qa=qa, mnli=mnli)
    return batches


def loss_and_grads(model, params, batch, device, pld_theta, seed):
    """One training forward and backward of ``model`` on ``device``:
    ``(loss, [grads])`` on the host."""
    tp = params_from_numpy(params, device)
    _, leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_()
    kw = {} if pld_theta is None else {
        "pld_theta": torch.tensor(pld_theta, device=device)}
    loss = model.apply(tp, {k: torch.from_numpy(v).to(device)
                            for k, v in batch.items()}, rng=seed,
                       train=True, **kw)
    loss.backward()
    return loss.detach().cpu(), [torch.zeros(leaf.shape) if leaf.grad is None
                                 else leaf.grad.cpu() for leaf in leaves]


def phase_remat_parity(results):
    """25. 2 layers at BERT-large width, fp32 (TF32 off), seq 128 with
    padding: pretraining (the MLM gather of 20) under remat, each memory
    knob, and PLD at θ 0 and 1 under remat; the QA and MNLI heads under
    remat.  Dropout 0: one forward and backward on the card (B1, B3) and
    on the CPU agree, the loss to rtol 1e-3 and each gradient to 1e-3 of
    its largest element (of a thousandth of the model's largest, where
    the leaf's is smaller).  Dropout 0.1 on the card: each gives the
    loss and gradients of the same model without it, bit for bit (PLD
    at θ 1 without the MLM gather, which PLD turns off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    width = dict(vocab_size=BERT_VOCAB, hidden_size=1024,
                 num_hidden_layers=2, num_attention_heads=16)
    batches = parity_batches(np.random.default_rng(SEED + 7))
    off = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               max_predictions_per_seq=BERT_PRED)
    params = {head: parity_head(head, BertConfig(**width, **off)).init(SEED)
              for head in batches}
    torch.cuda.synchronize()
    reset_launches()
    report = {}
    for name, (head, changes, theta) in REMAT_PARITY_CASES.items():
        cfg = BertConfig(**width, **off, **changes)
        batch = batches[head]
        card = loss_and_grads(parity_head(head, cfg), params[head], batch,
                              DEVICE, theta, SEED)
        cpu = loss_and_grads(parity_head(head, cfg), params[head], batch,
                             torch.device("cpu"), theta, SEED)
        loss_rel = abs(float(card[0] - cpu[0])) / abs(float(cpu[0]))
        # a leaf is held to its own largest element, or to a thousandth
        # of the model's largest where its own is smaller: a gradient
        # that is 0 in exact arithmetic (the QA head's bias: each row's
        # softmax sums to 1) is rounding noise on both sides
        floor = 1e-3 * max(float(w.abs().max()) for w in cpu[1])
        grad_rel = max(float((g - w).abs().max())
                       / max(float(w.abs().max()), floor)
                       for g, w in zip(card[1], cpu[1]))
        check(loss_rel <= 1e-3 and grad_rel <= 1e-3,
              f"remat parity {name}: loss rel {loss_rel}, grad rel "
              f"{grad_rel}")
        on = dict(width, hidden_dropout_prob=DROPOUT,
                  attention_probs_dropout_prob=DROPOUT,
                  max_predictions_per_seq=None if theta == 1.0
                  else BERT_PRED)
        if theta == 0.0:
            same = None   # every layer passes through: nothing to compare
        else:
            knob = loss_and_grads(parity_head(head, BertConfig(
                **on, **changes)), params[head], batch, DEVICE, theta, SEED)
            plain = loss_and_grads(parity_head(head, BertConfig(**on)),
                                   params[head], batch, DEVICE, None, SEED)
            same = (torch.equal(knob[0], plain[0])
                    and all(torch.equal(a, b)
                            for a, b in zip(knob[1], plain[1])))
            check(same, f"remat parity {name}: with dropout, the card's "
                  f"loss or gradients differ from the run without it")
        report[name] = {"card_loss": float(card[0]),
                        "cpu_loss": float(cpu[0]), "loss_rel": loss_rel,
                        "grad_rel": grad_rel, "bitwise_with_dropout": same}
        print(f"remat parity {name} (2 layers, hidden 1024, seq 128, "
              f"fp32): card {float(card[0]):.6f} cpu {float(cpu[0]):.6f}, "
              f"loss rel {loss_rel:.3g}, grad rel {grad_rel:.3g}; with "
              f"dropout bitwise the run without it: {same}")
    torch.cuda.synchronize()
    launches = read_launches()
    check(only_launched(launches, ("B1", "B3", "B4"))
          and launches["B1"] > 0 and launches["B3"] > 0,
          f"remat parity: launches {launches}, expected B1 and B3 only")
    results["remat_parity"] = dict(report, launches=launches)
    return launches


# ----------------------------------------------------------------- offload
# phases 26-29: ZeRO-Offload at one rank
OFFLOAD_CONFIG = dict(TRAIN_CONFIG,
                      optimizer={"type": "Adam", "params": {"lr": 1e-4}})
OFFLOAD_STEPS = 5
OFFLOAD_CHUNK_MB = 512
OFFLOAD = {"stage": 2, "cpu_offload": True,
           "offload_chunk_mb": OFFLOAD_CHUNK_MB}
BF16_EF = {"master": "bf16", "momentum": "bf16", "variance": "bf16",
           "error_feedback": True}
# bench.py's offload legs: batch 4, seq 1024, dropout 0, remat,
# loss_chunk 256, Adam lr 1e-4, ZeRO-2, bf16
BENCH_OFFLOAD_MODEL = dict(embd_dropout=0.0, attn_dropout=0.0,
                           resid_dropout=0.0, remat=True, loss_chunk=256)
LARGE_BATCH, LARGE_WARMUP, LARGE_TIMED = 4, 2, 5
XL_WARMUP, XL_TIMED = 2, 3
ADAM_RTOL, ADAM_ATOL = 2e-6, 1e-7  # tests/test_torch_cpu_adam.py
MASTER_UPDATE_RTOL = 1e-3  # phase 29: 5.8e-5 measured on the H100


def host_buffers(engine):
    """The engine's host buffers under offload: master, moments,
    residuals, host gradient."""
    out = [engine.master, engine.opt_state.exp_avg,
           engine.opt_state.exp_avg_sq, *engine._qres.values()]
    return out + ([engine._host_grad] if engine._host_grad is not None
                  else [])


def offload_engine(cfg, params, zero, batch_size, optimizer=None):
    """GPT-2 ``cfg`` from ``params`` under ``OFFLOAD_CONFIG`` with the
    ``zero`` block (and ``optimizer``); checks that every host buffer of
    an offload engine is pinned."""
    config = dict(OFFLOAD_CONFIG, train_batch_size=batch_size,
                  zero_optimization=zero)
    if optimizer is not None:
        config["optimizer"] = optimizer
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(cfg), model_parameters=params, config=config)
    if zero.get("cpu_offload"):
        check(all(b.is_pinned() for b in host_buffers(engine)),
              "offload: a host buffer is not pinned")
    return engine


def phase_offload_parity(card, results, train_launches):
    """26. Phase 6's GPT-2-medium with Adam lr 1e-4, 5 steps on one
    batch each: without offload, then under ``cpu_offload`` at depth 2
    (the default) and 1, then the bf16 SR host state at depth 1 and 2.
    Losses and the master after the last step bitwise the run without
    offload (fp32 state), depth 1 against depth 2 (both layouts).  Every
    run launches B1, B2a, B2b and B4 a step as phase 6 did."""
    b, _, s, _ = TRAIN_ATTN
    cfg = GPT2Config.gpt2_medium(embd_dropout=DROPOUT, attn_dropout=DROPOUT,
                                 resid_dropout=DROPOUT)
    params = random_params(cfg, SEED)
    batch = {"input_ids": np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, size=(b, s))}
    want = {k: train_launches[k] // 7 * OFFLOAD_STEPS
            for k in ("B1", "B2a", "B2b", "B4")}
    runs = (("none", {"stage": 2}),
            ("fp32 depth 2", OFFLOAD),
            ("fp32 depth 1", dict(OFFLOAD, offload_prefetch_depth=1)),
            ("bf16 SR depth 1", dict(OFFLOAD, offload_prefetch_depth=1,
                                     offload_state_dtype="bf16")),
            ("bf16 SR depth 2", dict(OFFLOAD, offload_state_dtype="bf16")))
    out, total, receipt = {}, {}, {"card": card}
    for name, zero in runs:
        label = f"offload parity: {name}"
        engine = offload_engine(cfg, params, zero, b)
        run = stepped(label, engine, batch, OFFLOAD_STEPS)
        torch.cuda.synchronize()
        master = engine.master.to("cpu", copy=True)
        schedule = engine.host_stream_schedule()
        release(engine)
        expect_launches(label, run[2], want)
        total = {k: total.get(k, 0) + v for k, v in run[2].items()}
        out[name] = (run[0], master)
        receipt[name] = {"losses": run[0],
                         "step_ms": [1e3 * x for x in run[1]],
                         "peak_memory_bytes": run[3], "schedule": schedule}
        if zero.get("cpu_offload"):
            check(schedule["chunks"] == 3, f"{label}: schedule {schedule}")
        print(f"{label}: losses {run[0]}, step ms "
              f"{[round(1e3 * x, 1) for x in run[1]]}, peak "
              f"{run[3] / 1e9:.2f} GB, schedule {schedule} [{card}]")
    for a, ref in (("fp32 depth 2", "none"), ("fp32 depth 1", "fp32 depth 2"),
                   ("bf16 SR depth 2", "bf16 SR depth 1")):
        check(out[a][0] == out[ref][0], f"offload parity: losses of {a} "
              f"{out[a][0]} differ from {ref}'s {out[ref][0]}")
        check(torch.equal(out[a][1], out[ref][1]), f"offload parity: the "
              f"master of {a} differs from {ref}'s")
    results["offload_parity"] = receipt
    return total


def host_memory_rates(nbytes=1 << 30):
    """The host's memory rate between pinned buffers in two multithreaded
    torch passes, median of 3 each: one ``copy_`` (bytes read and
    written) and one ``torch.add(a, b, out=c)`` (two reads, one write).
    Both also read each line they write before writing it, which a pass
    that writes what it read (Adam's p, m and v) does not pay."""
    a = torch.ones(nbytes // 4, pin_memory=True)
    b = torch.ones_like(a, pin_memory=True)
    c = torch.empty_like(a, pin_memory=True)
    out = {}
    for name, fn, moved in (("copy", lambda: c.copy_(a), 2 * nbytes),
                            ("add", lambda: torch.add(a, b, out=c),
                             3 * nbytes)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        out[name] = moved / statistics.median(times)
    return out


def check_host_kernel(engine, results):
    """The host kernel in place on row (e)'s pinned master and moments
    (with its last step's gradient) against the plain version on copies,
    p, m and v within ``ADAM_RTOL``/``ADAM_ATOL``; its time, the plain
    version's, ``torch._fused_adamw_``'s on the copies (where this torch
    has a CPU one) and the bound: 28 bytes a parameter (p, m and v read
    and written, g read) over the host's memory rate, the largest this
    run reached: a pinned ``copy_``, a pinned ``add``, or the fused
    AdamW call over the same 28 bytes a parameter, so that no call
    beats the bound."""
    engine._sync_host()
    p, m, v = (t.view(-1) for t in (engine.master, engine.opt_state.exp_avg,
                                    engine.opt_state.exp_avg_sq))
    g = engine._host_grad.view(-1)
    step = engine.opt_state.step + 1
    copies = [t.clone() for t in (p, m, v)]
    hp = engine.optimizer.hyperparams()
    args = (hp["lr"], hp["beta1"], hp["beta2"], engine.optimizer.eps,
            hp["weight_decay"])
    bc1, bc2 = cpu_adam.bias_corrections(hp["beta1"], hp["beta2"], step)
    t0 = time.perf_counter()
    cpu_adam.ds_adam_step(p, m, v, g, *args, bc1, bc2, True)
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_adam.plain_adam_step(*copies, g, *args, step)
    plain_s = time.perf_counter() - t0
    err = max(float((a - b).abs().max()) for a, b in zip((p, m, v), copies))
    check(torch.allclose(p, copies[0], rtol=ADAM_RTOL, atol=ADAM_ATOL)
          and torch.allclose(m, copies[1], rtol=ADAM_RTOL, atol=ADAM_ATOL)
          and torch.allclose(v, copies[2], rtol=ADAM_RTOL, atol=1e-8),
          f"ds_adam_step: max abs error {err} against the plain version")
    n = p.numel()
    rates = host_memory_rates()
    library_s = None
    fused = getattr(torch, "_fused_adamw_", None)
    if fused is not None:
        try:
            t0 = time.perf_counter()
            fused([copies[0]], [g], [copies[1]], [copies[2]], [],
                  [torch.tensor(float(step))], lr=args[0], beta1=args[1],
                  beta2=args[2], weight_decay=args[4], eps=args[3],
                  amsgrad=False, maximize=False)
            library_s = time.perf_counter() - t0
            rates["fused_adamw"] = 28 * n / library_s
        except (RuntimeError, TypeError) as e:  # not in this torch build
            print(f"host kernel: torch._fused_adamw_ on the CPU: {e}")
    row = {"kernel_ms": 1e3 * kernel_s, "plain_ms": 1e3 * plain_s,
           "library_ms": None if library_s is None else 1e3 * library_s,
           "bound_ms": 1e3 * 28 * n / max(rates.values()),
           "bound_by": "bytes", "max_abs_err": err, "params": n,
           "host_bytes_per_s": rates, "host_cpus": os.cpu_count()}
    print(f"host kernel ds_adam_step on {n} parameters: {json.dumps(row)}")
    results["host_kernel"] = row
    return row


def offload_large_setup(zero=OFFLOAD, optimizer=None, params=None):
    """Phase 27's engine, model config and fixed batch: bench.py's
    GPT-2-large offload leg (``bench.py:514-526``) under ``zero`` (and
    ``optimizer``), random weights from ``SEED`` unless ``params``
    are given.  ``examples/profile_torch_train.py --offload`` profiles
    this set-up."""
    s = TRAIN_ATTN[2]
    cfg = GPT2Config.gpt2_large(max_position_embeddings=s,
                                **BENCH_OFFLOAD_MODEL)
    if params is None:
        params = random_params(cfg, SEED)
    batch = {"input_ids": np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, size=(LARGE_BATCH, s))}
    return offload_engine(cfg, params, zero, LARGE_BATCH, optimizer), cfg, \
        batch


def phase_offload_large(card, results):
    """27. bench.py's GPT-2-large offload leg, five rows: (a) without
    offload, (b) fp32 host state, (c) bf16 SR, (d) bf16 with error
    feedback, (e) DeepSpeedCPUAdam; 2 warm-up and 5 timed steps each.
    Returns the launches and the host kernel's row, with its launches
    in row (e)'s steps."""
    s = TRAIN_ATTN[2]
    cfg = GPT2Config.gpt2_large(max_position_embeddings=s,
                                **BENCH_OFFLOAD_MODEL)
    params = random_params(cfg, SEED)
    layers, steps = cfg.num_layers, LARGE_WARMUP + LARGE_TIMED
    # remat: B1 twice a layer a step (forward and recompute); dropout 0
    want = {"B1": 2 * layers * steps, "B2a": layers * steps,
            "B2b": layers * steps}
    rows = (("a", "no offload", {"stage": 2}, None),
            ("b", "fp32 host state", OFFLOAD, None),
            ("c", "bf16 SR", dict(OFFLOAD, offload_state_dtype="bf16"),
             None),
            ("d", "bf16 error feedback",
             dict(OFFLOAD, offload_state_dtype=BF16_EF), None),
            ("e", "DeepSpeedCPUAdam", OFFLOAD,
             {"type": "CPUAdam", "params": {"lr": 1e-4}}))
    flops = gpt2_model_flops_per_sample(cfg, s)
    receipts, total, host_row = {"card": card}, {}, None
    for key, name, zero, opt in rows:
        label = f"offload large ({key}) {name}"
        engine, _, batch = offload_large_setup(zero, opt, params)
        offload = zero.get("cpu_offload", False)
        kernel_s0 = cpu_adam.ds_adam_step.seconds
        cpu_adam.ds_adam_step.launches = 0
        if offload:
            engine.host_stream.timing = True

        def after(e, n=iter(range(steps)), offload=offload):
            if next(n) == LARGE_WARMUP - 1 and offload:
                torch.cuda.synchronize()
                e.host_stream.timing_report()  # drop the warm-up's

        run = stepped(label, engine, batch, steps, after)
        if key == "e":
            adam_launches = cpu_adam.ds_adam_step.launches
        timed = run[1][LARGE_WARMUP:]
        extra = {"optimizer": opt["type"] if opt else "Adam",
                 "step_ms_median": 1e3 * statistics.median(timed),
                 "step_ms_spread": 1e3 * (max(timed) - min(timed))}
        if offload:
            torch.cuda.synchronize()
            extra.update(
                pinned_host_bytes=sum(b.nbytes for b in host_buffers(engine)),
                host_state_dtype=engine.host_state_dtype(),
                host_state_bytes_per_step=engine.host_state_bytes_per_step(),
                schedule=engine.host_stream_schedule(),
                stream=engine.host_stream.timing_report())
        if key == "e":
            extra["host_kernel_ms"] = 1e3 * (
                cpu_adam.ds_adam_step.seconds - kernel_s0) / steps
            host_row = check_host_kernel(engine, results)
        release(engine)
        expect_launches(label, run[2], want)
        total = {k: total.get(k, 0) + v for k, v in run[2].items()}
        receipts[key] = train_receipt(card, label, run, LARGE_WARMUP,
                                      LARGE_BATCH, s, flops, **extra)
    for key in "bcde":
        check(receipts[key]["peak_memory_bytes"]
              < receipts["a"]["peak_memory_bytes"],
              f"offload large ({key}): peak "
              f"{receipts[key]['peak_memory_bytes']} not below the run "
              f"without offload's {receipts['a']['peak_memory_bytes']}")
    results["offload_large"] = receipts
    return total, dict(host_row, launches=adam_launches)


def mem_available():
    """``MemAvailable`` of ``/proc/meminfo``, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return None


def phase_offload_xl(card, results):
    """28. bench.py's GPT-2-xl leg: 1.56 B parameters with
    ``offload_gradients`` (the fp32 gradient in pinned host memory too),
    bf16, remat, ``loss_chunk`` 256, batch 4: 2 warm-up and 3 timed
    steps, after printing the host's ``MemAvailable``."""
    s = TRAIN_ATTN[2]
    avail = mem_available()
    print(f"offload xl: MemAvailable {avail} bytes before the engine")
    cfg = GPT2Config.gpt2_xl(max_position_embeddings=s,
                             **BENCH_OFFLOAD_MODEL)
    params = random_params(cfg, SEED)
    batch = {"input_ids": np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, size=(LARGE_BATCH, s))}
    engine = offload_engine(cfg, params, dict(OFFLOAD, offload_gradients=True),
                            LARGE_BATCH)
    del params
    steps, layers = XL_WARMUP + XL_TIMED, cfg.num_layers
    engine.host_stream.timing = True
    run = stepped("offload xl", engine, batch, steps)
    torch.cuda.synchronize()
    extra = {"mem_available_bytes": avail,
             "params": int(sum(engine.segments.sizes)),
             "pinned_host_bytes": sum(b.nbytes for b in host_buffers(engine)),
             "host_state_bytes_per_step": engine.host_state_bytes_per_step(),
             "schedule": engine.host_stream_schedule(),
             "stream": engine.host_stream.timing_report(),
             "step_ms_median": 1e3 * statistics.median(run[1][XL_WARMUP:])}
    release(engine)
    expect_launches("offload xl", run[2], {"B1": 2 * layers * steps,
                                           "B2a": layers * steps,
                                           "B2b": layers * steps})
    results["offload_xl"] = train_receipt(
        card, "offload xl (GPT-2-xl, offload_gradients)", run, XL_WARMUP,
        LARGE_BATCH, s, gpt2_model_flops_per_sample(cfg, s), **extra)
    return run[2]


def phase_offload_parity_cpu(results):
    """29. 2 layers at GPT-2-medium width, fp32 (TF32 off), dropout 0,
    seq 128, batch 2, Adam lr 1e-4, fp32 streamed offload in 1 MB
    chunks: 10 steps on the card within rtol 1e-3 of the CPU's, and the
    master's 10-step update on the card within ``MASTER_UPDATE_RTOL``
    of the CPU's (the norm of their difference over the norm of the
    CPU's update), which an update that did not run on the card fails
    by 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPT2Config(hidden_size=1024, num_heads=16, num_layers=2,
                     embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)
    params = random_params(cfg, SEED)
    rng = np.random.default_rng(SEED + 3)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(2, 128))}
               for _ in range(10)]
    config = {"train_batch_size": 2, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
              "zero_optimization": dict(OFFLOAD, offload_chunk_mb=1)}
    out, masters, launches, schedule = {}, {}, None, None
    for where, device in (("card", DEVICE), ("cpu", torch.device("cpu"))):
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=GPT2LMHead(cfg), model_parameters=params,
            config=dict(config), device=device)
        start = engine.master.clone()
        if where == "card":
            schedule = engine.host_stream_schedule()
            torch.cuda.synchronize()
            reset_launches()
        out[where] = [float(engine.train_batch(iter([bt])))
                      for bt in batches]
        if where == "card":
            torch.cuda.synchronize()
            launches = read_launches()
        masters[where] = engine.master.clone()
        del engine
    card, cpu = out["card"], out["cpu"]
    moved = masters["cpu"] - start
    diff = masters["card"] - masters["cpu"]
    master = {"update_rel_err": float(torch.linalg.vector_norm(diff)
                                      / torch.linalg.vector_norm(moved)),
              "max_abs_err": float(diff.abs().max()),
              "max_abs_update": float(moved.abs().max()),
              "elements_over_1e-5": int((diff.abs() > 1e-5).sum()),
              "elements": diff.numel()}
    print(f"offload parity cpu: master {master}")
    check(np.allclose(card, cpu, rtol=1e-3, atol=0.0),
          f"offload parity cpu: card {card} vs cpu {cpu}")
    check(master["update_rel_err"] <= MASTER_UPDATE_RTOL,
          f"offload parity cpu: the master's update on the card is "
          f"{master['update_rel_err']} from the CPU's (relative norm)")
    check(schedule["chunks"] > 1, f"offload parity cpu: {schedule}")
    expect_launches("offload parity cpu", launches,
                    {"B1": 2 * 10, "B3": 2 * 10})
    print(f"offload parity cpu (2 layers, hidden 1024, seq 128, fp32, "
          f"{schedule['chunks']} chunks): card {card}, cpu {cpu}")
    results["offload_parity_cpu"] = {"card": card, "cpu": cpu,
                                     "master": master,
                                     "schedule": schedule,
                                     "launches": launches}
    return launches


# ---------------------------------------------------------------------- dp
DP_CPU_WORLD = 2
DP_CPU_STEPS = 3
DP_CPU_MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2,
                    num_heads=4, max_position_embeddings=64,
                    embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)
DP_CPU_MICRO = 2
DP_CPU_TIMEOUT_S = 180


def build_dir():
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    return root


def dp_cpu_engine(mesh, world):
    """The tiny GPT-2 (2 layers, hidden 64, fp32, dropout 0) under ZeRO-2,
    Lamb, accumulation 2 and clipping 1.0 on the CPU, for the global
    micro-batch of ``DP_CPU_MICRO`` x 2 rows over ``world`` ranks."""
    cfg = GPT2Config(**DP_CPU_MODEL)
    micro = DP_CPU_MICRO * DP_CPU_WORLD // world
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(cfg), model_parameters=random_params(cfg, SEED),
        config={"train_batch_size": micro * 2 * world,
                "train_micro_batch_size_per_gpu": micro,
                "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
                "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Lamb", "params": {"lr": 3e-3}},
                "zero_optimization": {"stage": 2}},
        mesh=mesh, device="cpu")
    return engine


def dp_cpu_batches():
    rng = np.random.default_rng(SEED + 3)
    return [rng.integers(0, 256, size=(DP_CPU_MICRO * DP_CPU_WORLD, 32))
            for _ in range(2 * DP_CPU_STEPS)]


def dp_cpu_rank(rank, store, out_dir):
    """One gloo rank of the dp=2 CPU check: ``DP_CPU_STEPS`` steps on its
    rows of :func:`dp_cpu_batches`, then the losses and the gathered
    master into ``out_dir``.  The rank then leaves without tearing the
    gloo group down (its teardown can abort a rank whose peer closed its
    sockets first); an exception exits 1."""
    torch.set_num_threads(1)
    init_distributed(init_method=f"file://{store}", world_size=DP_CPU_WORLD,
                     rank=rank, device="cpu", timeout=60, verbose=False)
    engine = dp_cpu_engine(make_mesh({DATA_AXIS: DP_CPU_WORLD}),
                           DP_CPU_WORLD)
    per = DP_CPU_MICRO
    it = iter([{"input_ids": b[rank * per:(rank + 1) * per]}
               for b in dp_cpu_batches()])
    losses = [float(engine.train_batch(it)) for _ in range(DP_CPU_STEPS)]
    master = engine.flat.gather_master_unpadded(engine.master)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             losses=np.asarray(losses), master=master)
    dist.barrier()
    os._exit(0)


def dp_cpu_check(results):
    """dp=2 on two gloo CPU processes of this machine's torch against one
    CPU rank on the same global batches: losses to rtol 1e-5 and the
    master's update to 1e-4 of its norm.  A rank that fails or outlasts
    ``DP_CPU_TIMEOUT_S`` fails the phase."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=build_dir())
    try:
        store = os.path.join(out_dir, "store")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=dp_cpu_rank, args=(r, store, out_dir),
                             daemon=True) for r in range(DP_CPU_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP_CPU_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        check(codes == [0] * DP_CPU_WORLD,
              f"dp cpu: the gloo ranks exited with {codes}")
        ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz"))
                 for r in range(DP_CPU_WORLD)]
        engine = dp_cpu_engine(None, 1)
        start = engine.flat.gather_master_unpadded(engine.master)
        it = iter([{"input_ids": b} for b in dp_cpu_batches()])
        want = [float(engine.train_batch(it)) for _ in range(DP_CPU_STEPS)]
        master = engine.flat.gather_master_unpadded(engine.master)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    got = ranks[0]["losses"].tolist()
    check(ranks[1]["losses"].tolist() == got
          and np.array_equal(ranks[1]["master"], ranks[0]["master"]),
          "dp cpu: the two ranks disagree")
    check(np.allclose(got, want, rtol=1e-5, atol=0),
          f"dp cpu: dp=2 losses {got} vs one rank's {want}")
    update_rel = float(np.linalg.norm(ranks[0]["master"] - master)
                       / np.linalg.norm(master - start))
    check(update_rel <= 1e-4, f"dp cpu: the master's update is {update_rel} "
          f"from one rank's (relative norm)")
    print(f"dp cpu (2 gloo ranks, tiny GPT-2, ZeRO-2, Lamb, accumulation "
          f"2, clip 1.0, fp32; torch {torch.__version__}): dp=2 {got}, one "
          f"rank {want}, master update rel err {update_rel:.3g}")
    results["dp_cpu"] = {"dp2": got, "one_rank": want,
                         "master_update_rel_err": update_rel}


def exchange_times(engine):
    """Device ms of the step's collectives replayed on the engine's own
    buffers (median of 20 runs of 10, :func:`device_ms`): the gradient's
    reduce-scatter in the exchange dtype and in fp32 (the dtype above
    one rank), the compute params' all-gather, the step's stats
    all-reduce."""
    mesh = engine.mesh
    grad32 = engine._grad.float()
    shard32 = engine._gshard.float()
    cast = engine.master.to(engine.compute_dtype)
    stats = torch.zeros(3, device=engine.device)
    return {
        "reduce_scatter_ms": device_ms(lambda: comm.reduce_scatter(
            engine._grad, DATA_AXIS, mesh=mesh, out=engine._gshard)),
        "reduce_scatter_fp32_ms": device_ms(lambda: comm.reduce_scatter(
            grad32, DATA_AXIS, mesh=mesh, out=shard32)),
        "all_gather_ms": device_ms(lambda: comm.all_gather(
            cast, DATA_AXIS, mesh=mesh, out=engine._compute)),
        "stats_all_reduce_ms": device_ms(lambda: comm.psum(
            stats, DATA_AXIS, mesh, out=stats))}


def dp_run(label, setup, without_mesh, mesh):
    """2 + 3 steps of ``setup``'s engine on ``mesh``: losses bitwise the
    first five of ``without_mesh`` (the receipt of the phase that ran
    the set-up without a mesh), its attention launches a step, and the
    collectives a step; then the exchange's device times."""
    want_losses = without_mesh["losses"]
    want_launches = {k: n for k, n in
                     without_mesh["launches_per_step"].items() if n}
    engine, _, batch = setup(mesh=mesh)
    check(engine._partitioned and engine.dp_world_size == 1,
          f"{label}: the engine is not on the sharded path")
    comm.counter.reset()
    losses, step_s, launches = run_steps(label, engine, batch, 2, 3)
    steps = 5
    calls = dict(comm.counter.calls)
    nbytes = dict(comm.counter.bytes)
    check(losses == want_losses[:steps],
          f"{label}: losses {losses} are not the run without a mesh's "
          f"{want_losses[:steps]}")
    check(want_launches and all(launches[k] == n * steps
                                for k, n in want_launches.items())
          and only_launched(launches, tuple(want_launches)),
          f"{label}: launches {launches}, expected {want_launches} a step")
    # a step: the micro-batch's reduce-scatter, the stats all-reduce,
    # Lamb's one all-reduce of the per-tensor sums, the params' all-gather
    check(calls == {"reduce_scatter": steps, "psum": 2 * steps,
                    "all_gather": steps},
          f"{label}: collectives {calls}, expected 1 reduce_scatter, 2 "
          f"psum and 1 all_gather a step")
    times = exchange_times(engine)
    exchange_ms = (times["reduce_scatter_ms"] + times["all_gather_ms"]
                   + times["stats_all_reduce_ms"])
    params = sum(engine.segments.sizes)
    flat = engine.segments.total
    receipt = {
        "losses": losses, "step_ms": 1e3 * step_s,
        "collectives_per_step": {k: v / steps for k, v in calls.items()},
        "bytes_per_step": {k: v / steps for k, v in nbytes.items()},
        "exchange_ms_per_step": exchange_ms, **times,
        # above one rank the gradient goes over in fp32: what a step
        # would move, from the layout
        "bytes_per_step_above_one_rank": {
            "reduce_scatter": 4 * flat,
            "all_gather": flat * engine._compute.element_size(),
            "psum": 12},
        "parameters": params,
        "launches_per_step": {k: v / steps for k, v in launches.items()}}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return receipt, launches


def phase_dp(card, results):
    """NCCL at world size 1 through a ``file://`` store under ``build/``;
    GPT-2-medium (phase 6's set-up) and BERT-large (phase 12's) through
    ``initialize(mesh=make_mesh({"data": 1}))``, 2 + 3 steps each on the
    sharded path: losses bitwise their phases' first five, the same
    attention launches a step, the collectives, bytes and the exchange's
    device ms a step; then dp=2 against one rank on two gloo CPU
    processes (:func:`dp_cpu_check`).  The process group is torn down
    before the CPU check, whose parent engine has no mesh."""
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_nccl_", dir=build_dir())
    try:
        init_distributed(init_method=f"file://{store_dir}/store",
                         world_size=1, rank=0, device="cuda", timeout=300)
        version = torch.cuda.nccl.version()
        nccl = (".".join(str(v) for v in version)
                if isinstance(version, tuple) else str(version))
        print(f"dp: torch.distributed {dist.get_backend()} (NCCL {nccl}) "
              f"at world size {dist.get_world_size()}")
        mesh = make_mesh({DATA_AXIS: 1})
        gpt2, gpt2_launches = dp_run("dp gpt2", train_setup,
                                     results["train"], mesh)
        bert, bert_launches = dp_run("dp bert", bert_train_setup,
                                     results["bert_train"], mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    for label, r in (("GPT-2-medium, seq 1024, batch 8", gpt2),
                     ("BERT-large, seq 128, batch 64", bert)):
        print(f"dp receipt ({label}, bf16, Lamb, ZeRO-2, mesh data=1 on "
              f"NCCL; {card}):", json.dumps(r))
    dp_cpu_check(results)
    results["dp"] = {"card": card, "nccl": nccl, "gpt2": gpt2, "bert": bert}
    return {k: gpt2_launches[k] + bert_launches[k] for k in gpt2_launches}


def kernel_entry(name, source, replaces, launches, max_err, row):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err, "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the per-case numbers "
                        "to this JSON file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; run this on the card",
              file=sys.stderr)
        return 1
    results = {"kernel": [], "backward": []}
    # 1. env
    card = card_line()
    print(f"env: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.monotonic()
    op_builder.build([*op_builder.SOURCES, *op_builder.HOST_SOURCES])
    build_s = time.monotonic() - t0
    print(f"env: kernels built in {build_s:.1f} s "
          f"({[*op_builder.SOURCES, *op_builder.HOST_SOURCES]})")
    results["env"] = {"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "build_seconds": build_s}
    # wall seconds of each phase, for the run's time limit
    phase_s, clock = {}, [time.monotonic()]

    def lap(name):
        now = time.monotonic()
        phase_s[name] = now - clock[0]
        clock[0] = now

    # 2. kernel: B1 against its plain version
    max_err, timings = phase_kernel(card, results)
    lap("kernel")
    # 3. backward: B2a+B2b, B3 and B4 against their plain versions
    bwd_err, bwd_timings = phase_backward(card, results)
    lap("backward")

    # 4. serve, at the full width of GPT-2-medium
    config = GPT2Config.gpt2_medium()
    model = GPT2LMHead(config)
    params = random_params(config, seed=SEED)
    serve_launches = phase_serve(card, model, params, results)
    check(serve_launches > 0, "the serve path never launched B1")
    lap("serve")
    # 5. parity, fp32 on the card against the CPU
    phase_parity(model, params, results)
    lap("parity")
    del model, params

    # 6. train, GPT-2-medium at full width and depth
    train_launches = phase_train(card, results)
    lap("train")
    # 7. train parity, card against CPU
    parity_launches = phase_train_parity(results)
    lap("train_parity")

    # 8. sparse kernel: B5a and B5b against their plain versions
    sparse_err, sparse_timings = phase_sparse_kernel(card, results)
    lap("sparse_kernel")
    # 9. sparse train, GPT-2-medium at seq 4096
    sparse_launches = phase_sparse_train(card, results)
    lap("sparse_train")
    # 10. sparse train parity, card against CPU
    sparse_parity_launches = phase_sparse_parity(results)
    lap("sparse_train_parity")

    # 11. agg kernel: B6a, B6b and B6c against their plain versions and B5
    agg_err, agg_timings = phase_agg_kernel(card, results)
    lap("agg_kernel")
    # 12. bert train, BERT-large at seq 128
    bert_launches = phase_bert_train(card, results)
    lap("bert_train")
    # 13. bert sparse train, BERT-large at seq 4096 through B6
    bert_sparse_launches = phase_bert_sparse_train(card, results)
    lap("bert_sparse_train")
    # 14. bert parity, card against CPU, dense and sparse
    bert_parity_launches = phase_bert_parity(results)
    lap("bert_parity")
    save_dir = checkpoint_dir()
    try:
        # 15. checkpoint: save GPT-2-medium between steps, resume bitwise
        checkpoint_launches, run_a = phase_checkpoint(
            card, results, results["train"]["step_ms"], save_dir)
        lap("checkpoint")
        # 16. fp16 kernels: B1, B2a, B2b, B3 (B4 inside) against plain
        fp16_err, fp16_timing = phase_fp16_kernel(card, results)
        lap("fp16_kernel")
        # 17. fp16 train, GPT-2-medium under the dynamic loss scaler
        fp16_launches = phase_fp16_train(card, results)
        lap("fp16_train")
        # 18. fp16 train, BERT-large
        fp16_bert_launches = phase_fp16_bert_train(card, results)
        lap("fp16_bert_train")
        # 19. fp16 parity, card against CPU, with a forced overflow
        fp16_parity_launches = phase_fp16_parity(results)
        lap("fp16_parity")
        # 20. rollback to phase 15's checkpoint at full width
        rollback_launches = phase_rollback(card, results, save_dir, run_a)
        lap("rollback")
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    # 21. remat and the chunked LM loss, GPT-2-medium
    remat_launches = phase_remat(card, results)
    lap("remat")
    # 22. BERT-large under remat and Progressive Layer Drop
    bert_pld_launches = phase_bert_pld(card, results)
    lap("bert_pld")
    # 23. BERT-large SQuAD fine-tuning, seq 384 with ragged key padding
    squad_launches = phase_squad(card, results)
    lap("squad")
    # 24. BERT-large MNLI-style sequence classification
    mnli_launches = phase_mnli(card, results)
    lap("mnli")
    # 25. remat, the memory knobs and PLD: card against CPU, and bitwise
    remat_parity_launches = phase_remat_parity(results)
    lap("remat_parity")
    # 26. offload parity, GPT-2-medium, bitwise the run without offload
    offload_parity_launches = phase_offload_parity(card, results,
                                                   train_launches)
    lap("offload_parity")
    # 27. bench.py's GPT-2-large offload leg, five rows
    offload_large_launches, host_row = phase_offload_large(card, results)
    lap("offload_large")
    # 28. bench.py's GPT-2-xl leg, offload_gradients
    offload_xl_launches = phase_offload_xl(card, results)
    lap("offload_xl")
    # 29. offload, card against CPU
    offload_cpu_launches = phase_offload_parity_cpu(results)
    lap("offload_parity_cpu")
    # 30. data parallelism: NCCL at world size 1, the sharded path
    # bitwise phases 6 and 12; dp=2 on two gloo CPU processes
    dp_launches = phase_dp(card, results)
    lap("dp")

    paths = {"train": train_launches, "train_parity": parity_launches,
             "sparse_train": sparse_launches,
             "sparse_train_parity": sparse_parity_launches,
             "bert_train": bert_launches,
             "bert_sparse_train": bert_sparse_launches,
             "bert_parity": bert_parity_launches,
             "checkpoint": checkpoint_launches,
             "fp16_train": fp16_launches,
             "fp16_bert_train": fp16_bert_launches,
             "fp16_parity": fp16_parity_launches,
             "rollback": rollback_launches, "remat": remat_launches,
             "bert_pld": bert_pld_launches, "squad": squad_launches,
             "mnli": mnli_launches, "remat_parity": remat_parity_launches,
             "offload_parity": offload_parity_launches,
             "offload_large": offload_large_launches,
             "offload_xl": offload_xl_launches,
             "offload_parity_cpu": offload_cpu_launches,
             "dp": dp_launches}
    launches = {name: sum(path[name] for path in paths.values())
                for name in (*KERNEL_COUNTERS, *FP16_COUNTERS)}
    launches["B1"] += serve_launches
    results["launches"] = dict(paths, serve={"B1": serve_launches})
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main paths never launched: {launches}")

    main_shape = timings[BUCKETS[-1]]
    # B3 at the BERT train attention, bf16 on the tensor cores, on one
    # precomputed Δ (its fp32 time at the train-parity attention is in
    # the backward timing lines)
    b3 = results["b3_bert"]
    kernels = [
        kernel_entry("flash_attention_fwd (B1)", FLASH_SOURCE,
                     FLASH_REPLACES, launches["B1"],
                     max(max_err, bwd_err["b1_train"]), main_shape),
        kernel_entry("flash_attention_bwd_dq (B2a)",
                     CSRC + "flash_attention_bwd.cu", REF + ":263",
                     launches["B2a"], bwd_err["b2"], bwd_timings["dq"]),
        kernel_entry("flash_attention_bwd_dkv (B2b)",
                     CSRC + "flash_attention_bwd.cu", REF + ":311",
                     launches["B2b"], bwd_err["b2"], bwd_timings["dkv"]),
        kernel_entry("flash_attention_bwd_fused (B3)",
                     CSRC + "flash_attention_bwd.cu", REF + ":378",
                     launches["B3"], bwd_err["b3"], b3),
        kernel_entry("in-kernel dropout (B4)", CSRC + "flash_dropout.cuh",
                     REF + ":145", launches["B4"], bwd_err["dropout"],
                     bwd_timings["dropout"]),
        kernel_entry("flash_block_sparse_fwd (B5a)", AGG_SOURCE,
                     SPARSE_REF + ":213", launches["B5a"], sparse_err["fwd"],
                     sparse_timings["fwd"]),
        kernel_entry("flash_block_sparse_bwd (B5b)", AGG_SOURCE,
                     SPARSE_REF + ":253", launches["B5b"], sparse_err["bwd"],
                     sparse_timings["bwd"]),
        kernel_entry("flash_block_sparse_agg_fwd (B6a)", AGG_SOURCE,
                     SPARSE_REF + ":333", launches["B6a"], agg_err["fwd"],
                     agg_timings["fwd"]),
        kernel_entry("flash_block_sparse_agg_bwd_dq (B6b)", AGG_SOURCE,
                     SPARSE_REF + ":373", launches["B6b"], agg_err["dq"],
                     agg_timings["dq"]),
        kernel_entry("flash_block_sparse_agg_bwd_dkv (B6c)", AGG_SOURCE,
                     SPARSE_REF + ":402", launches["B6c"], agg_err["dkv"],
                     agg_timings["dkv"])]
    # B1-B4's fp16 instantiations: their main-path launches, errors
    # against the plain versions and times (phase 16)
    for entry, name in zip(kernels, ("B1", "B2a", "B2b", "B3", "B4")):
        row = fp16_timing[name]
        entry.update(fp16_launches=launches[f"{name} fp16"],
                     fp16_max_abs_err=fp16_err[name],
                     fp16_ms=row["kernel_ms"],
                     fp16_plain_ms=row["plain_ms"],
                     fp16_bound_ms=row["bound_ms"],
                     fp16_library_ms=row["library_ms"])
    check(host_row["launches"] > 0,
          "the offload path never launched ds_adam_step")
    host_kernels = [{
        "name": "ds_adam_step (DeepSpeedCPUAdam)", "route": "host",
        "source": "deepspeed_tpu_torch/csrc/adam/cpu_adam.cpp",
        "replaces": "deepspeed_tpu/csrc/adam/cpu_adam.cpp:12",
        "launches": host_row["launches"],
        "max_abs_err": host_row["max_abs_err"],
        "ms": host_row["kernel_ms"], "plain_ms": host_row["plain_ms"],
        "bound_ms": host_row["bound_ms"], "bound_by": host_row["bound_by"],
        "library_ms": host_row["library_ms"]}]
    results["kernels"] = kernels
    results["host_kernels"] = host_kernels
    results["phase_seconds"] = phase_s
    print("phase seconds:", json.dumps({k: round(v, 1)
                                        for k, v in phase_s.items()}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels, "host_kernels": host_kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
