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
CPU, and does the same two things again at seq 4096 with block-sparse
attention.  Phases, in order; any failure raises, so the script exits
non-zero:

1. env      — card name and power limit, torch/CUDA versions, kernel
              build (one nvcc per source, all started together);
2. kernel   — B1, the flash-attention forward, vs
              ``flash_attention_reference`` in fp32 and bf16, out and lse
              (at each prefill bucket on strided views of a fused QKV
              projection, as the prefill passes them), and its device
              time per launch at each bucket (median of 20 runs of 10
              back-to-back launches between CUDA events) beside the
              plain version's, ``scaled_dot_product_attention``'s (a
              yardstick the port never calls) and the card's bound;
3. backward — B2a+B2b and B3 (the backward kernels) and B4 (in-kernel
              dropout) vs ``flash_attention_bwd_reference`` with the
              ``philox_keep_mask`` mask, fp32 (TF32 off) and bf16: the
              buckets on fused-QKV views, causal and not, a fully masked
              batch row (exactly zero grads), masked keys (exactly zero
              dk, dv), ragged s, kv_len != s, d=128, dropout 0.1; two
              runs bitwise equal; B4's mask read back from B1 equal to
              the plain version's with a binomial keep rate; B1+B4, B2a
              and B2b again at GPT-2-medium's training attention (b=8,
              s=1024, bf16, dropout 0.1), and B3 at the train-parity
              phase's; device times at the training attention beside
              the plain version's, SDPA's backward and the bound;
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
8. sparse kernel — B5a and B5b (block-sparse flash forward and backward)
              vs ``flash_block_sparse_reference`` and
              ``flash_block_sparse_bwd_reference``, fp32 (TF32 off) and
              bf16, on fused-QKV views: the train layout (Fixed
              unidirectional, 256-row blocks, seq 4096) and the
              parity phase's (256-row blocks, seq 1024), the same
              pattern in 128-row blocks, BigBird with
              64-row blocks and with 512-row blocks at seq 16384, a
              random per-head layout with empty rows (exactly zero out
              and dq), 16- and 24-row blocks, d=128, causal and not;
              two runs bitwise equal; device
              times at the sparse training attention (b=2, h=16, s=4096,
              d=64, bf16) beside the plain versions', SDPA's with the
              layout as a boolean mask and the bound, and dense B1 and
              B2a+B2b at the same shape;
9. sparse train — GPT-2-medium with ``attn_impl="sparse"`` and that
              Fixed unidirectional layout, 4096 positions, seq 4096,
              micro-batch 2, dropout 0.1, Lamb, ZeRO-2, bf16: 2 warm-up
              and 3 timed steps; finite, falling losses, one B5a and one
              B5b launch per layer per step and no dense flash launch;
10. sparse train parity — 2 layers at GPT-2-medium width, fp32, seq 1024,
              256-row blocks, dropout 0: 3 steps on the card (B5a, B5b)
              and on the CPU (the gather path) agree to rtol 1e-3.

Phases 9 and 10 go through the layer, whose ``q_agg="auto"`` follows the
JAX package: at 256-row layout blocks that is G = 1, the work-list
kernels B5a/B5b replace.  At blocks of up to 128 rows the JAX package
runs its super-tile kernels (B6), which are not ported yet, and the
port's layer raises there; phase 8 checks that too.

Then one ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and last the line ``{"ok": true, "device": {...}}``.  With ``--out PATH``
the per-case numbers also go to PATH as JSON.  Needs one card and no
network; imports nothing of JAX.
"""

import argparse
import json
import math
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_block_sparse as fbs
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, FixedSparsityConfig)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_bwd_fused, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_reference, philox_keep_mask)
from deepspeed_tpu_torch.utils.params import params_from_numpy

DEVICE = torch.device("cuda")
# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
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
GRAD_TOLS = {torch.float32: 5e-4, torch.bfloat16: 1e-2}
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
SPARSE_SOURCE = "deepspeed_tpu_torch/csrc/sparse_attention/" \
    "flash_block_sparse.cu"
SPARSE_REF = "deepspeed_tpu/ops/sparse_attention/flash_block_sparse.py"
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


def device_ms(fn, calls=10, repeats=20, warmup=3):
    """Device time per call, in ms: the median over ``repeats`` runs of
    ``calls`` back-to-back calls between two CUDA events, each run's
    time over ``calls``.  A spin kernel holds the stream until the host
    has queued the whole run, so no host time is in it; a run whose
    start event already fired when its last call was queued is retried
    with a longer spin."""
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
    return statistics.median(times)


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
    """(label, b, h, s, kv_len, d, causal, mask kind, fused).  The bucket
    cases are the prefill's: q, k and v are strided views of one fused
    [b, s, 3, h, d] projection, as ``inference/model.py`` passes them."""
    cases = [(f"bucket{s}", 1, 16, s, s, 64, True, "tail", True)
             for s in BUCKETS]
    cases += [("b2_full_masked_row", 2, 16, 256, 256, 64, False, "row",
               False),
              ("ragged_s300", 1, 16, 300, 300, 64, True, "tail", False),
              ("kv_len_ne_s", 2, 8, 256, 384, 64, False, "tail", False),
              ("kv_len_ne_s_causal", 1, 8, 200, 320, 64, True, "none",
               False),
              ("d128", 1, 8, 512, 512, 128, True, "tail", False)]
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
          "rounded to bf16 before P·V, as on the TPU)")
    max_err = 0.0
    timings = {}
    for i, (label, b, h, s, kv_len, d, causal, kind, fused) in \
            enumerate(kernel_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = make_case(b, h, s, kv_len, d, kind, fused,
                                      dtype, SEED + i)
            out, lse = flash_attention_fwd(q, k, v, mask, causal=causal)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_attention_reference(q, k, v, mask,
                                                         causal)
            check(out.shape == ref_out.shape and lse.shape == ref_lse.shape,
                  f"{label}: shapes {out.shape}/{lse.shape}")
            check(bool(torch.isfinite(out.float()).all()),
                  f"{label}: non-finite output")
            tol = TOLS[dtype]
            torch.testing.assert_close(out.float(), ref_out.float(),
                                       atol=tol, rtol=tol)
            torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
            err_out = float((out.float() - ref_out.float()).abs().max())
            err_lse = float((lse - ref_lse).abs().max())
            max_err = max(max_err, err_out)
            if kind == "row":
                check(bool((out[1] == 0).all()), "masked row is not zero")
            row = {"case": label, "dtype": str(dtype).split(".")[-1],
                   "b": b, "h": h, "s": s, "kv_len": kv_len, "d": d,
                   "causal": causal, "fused_qkv_views": fused,
                   "max_abs_err_out": err_out,
                   "max_abs_err_lse": err_lse}
            print(f"kernel {label} {row['dtype']}: max |out-plain| "
                  f"{err_out:.3g}, max |lse-plain| {err_lse:.3g} ok")
            if dtype == torch.bfloat16 and label.startswith("bucket"):
                bound, bound_by = attention_bound(q, k, mask, causal)
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                row.update(
                    kernel_ms=device_ms(lambda: flash_attention_fwd(
                        q, k, v, mask, causal=causal)),
                    plain_ms=device_ms(lambda: flash_attention_reference(
                        q, k, v, mask, causal)),
                    library_ms=device_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True)),
                    bound_ms=bound, bound_by=bound_by)
                timings[s] = row
                print(f"bucket s={s} (b=1 h=16 d=64 causal bf16, fused "
                      f"QKV views): "
                      f"kernel_ms={row['kernel_ms']:.4f} "
                      f"plain_ms={row['plain_ms']:.4f} "
                      f"library_ms={row['library_ms']:.4f} "
                      f"bound_ms={bound:.5f} ({bound_by}) [{card}]")
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
         DROPOUT)]
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
    """B4's keep mask read back from B1 itself: with q = 0 every score is
    0, and with V the identity over kv_len = head_dim keys each output
    element is keep·inv_keep/kv_len.  The mask must equal the plain
    version's, keep the binomial rate within 5 sigma, and change with the
    seed."""
    b, h, s, d = 1, 16, 4096, 64
    q = torch.zeros(b, s, h, d, device=DEVICE)
    k = torch.randn(b, d, h, d, device=DEVICE)
    v = torch.eye(d, device=DEVICE)[None, :, None, :].expand(
        b, d, h, d).contiguous()
    masks = []
    for seed in (11, 12):
        out, _ = flash_attention_fwd(q, k, v, None, False, DROPOUT,
                                     seed_words(seed))
        kept = out.permute(0, 2, 1, 3).reshape(b * h, s, d) > 0
        check(torch.equal(kept, philox_keep_mask(seed_words(seed), b * h, s,
                                                 d, DROPOUT)),
              "B4: the kernel's keep mask differs from philox_keep_mask")
        masks.append(kept)
    check(not torch.equal(masks[0], masks[1]), "B4: another seed gives the "
          "same mask")
    thresh, _ = fa.dropout_thresh(DROPOUT)
    p_keep = 1.0 - thresh / 2.0 ** 32
    n = masks[0].numel()
    rate = float(masks[0].float().mean())
    sigma = math.sqrt(p_keep * (1 - p_keep) / n)
    check(abs(rate - p_keep) <= 5 * sigma, f"B4: keep rate {rate} is "
          f"{abs(rate - p_keep) / sigma:.1f} sigma from {p_keep}")
    print(f"B4 keep mask from B1 ({n} elements): equals the plain version "
          f"for two seeds, keep rate {rate:.6f} vs {p_keep:.6f} "
          f"({abs(rate - p_keep) / sigma:.2f} sigma) [{card}]")
    results["keep_mask"] = {"elements": n, "keep_rate": rate,
                            "expected": p_keep,
                            "sigmas": abs(rate - p_keep) / sigma}


def check_train_shape(card, q, k, v, out, lse, dout, seed, plain_bwd,
                      max_err):
    """B1 with B4, then B2a and B2b, at the train phase's attention
    against their plain versions with the same Philox mask, at the bf16
    tolerances of the backward phase; the errors join ``max_err``."""
    keep, inv_keep = plain_keep(q, k, DROPOUT, seed)
    ref_out, ref_lse = flash_attention_reference(q, k, v, None, True, keep,
                                                 inv_keep)
    del keep
    tol, gtol = TOLS[torch.bfloat16], GRAD_TOLS[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=tol, rtol=tol)
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
          f" |lse-plain| {errs['lse']:.3g}; B2a+B2b max |grad-plain| dq "
          f"{errs['dq']:.3g} dk {errs['dk']:.3g} dv {errs['dv']:.3g} ok "
          f"[{card}]")
    return errs


def time_backward(card, results, max_err):
    """Checks the kernels at GPT-2-medium's training attention (b=8,
    h=16, s=1024, d=64, causal, bf16, fused QKV views, dropout 0.1)
    against their plain versions, then takes device times at the shapes
    the main paths give the kernels: B1, B2a, B2b and B4 at that
    attention, B3 at the train-parity phase's (b=2, h=16, s=128, fp32, no
    dropout), and B3 against B2a+B2b at s=128 for the dispatch
    threshold."""
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
    timings = {}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = dout.transpose(1, 2)
    sdpa_bwd = device_ms(lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dot, retain_graph=True))
    plain_ms = device_ms(plain_bwd, calls=1, repeats=3, warmup=1)
    for kind, fn in (("dq", flash_attention_bwd_dq),
                     ("dkv", flash_attention_bwd_dkv)):
        bound, by = backward_bound(kind, q, k, None, True)
        timings[kind] = {"kernel_ms": device_ms(lambda: fn(*args)),
                         "plain_ms": plain_ms, "library_ms": sdpa_bwd,
                         "bound_ms": bound, "bound_by": by}
    fwd_bound, fwd_by = attention_bound(q, k, None, True)
    timings["fwd_train"] = {
        "kernel_ms": device_ms(lambda: flash_attention_fwd(
            q, k, v, None, True, DROPOUT, seed)),
        "bound_ms": fwd_bound, "bound_by": fwd_by}

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
    for name, row in timings.items():
        print(f"backward timing {name} (b=8 h=16 s=1024 d=64 causal bf16, "
              f"dropout 0.1): " + " ".join(
                  f"{key}={val:.5f}" if isinstance(val, float) else
                  f"{key}={val}" for key, val in row.items()) + f" [{card}]")

    # B3 at the parity phase's shape, and B3 against B2a+B2b at s=128
    for label, shape, dtype in (("parity_fp32", (2, 16, 128, 64),
                                 torch.float32),
                                ("train_s128_bf16", (8, 16, 128, 64),
                                 torch.bfloat16)):
        b3, h3, s3, d3 = shape
        q3, k3, v3, do3 = (torch.randn(b3, s3, h3, d3, generator=g)
                           .to(DEVICE, dtype) for _ in range(4))
        o3, l3 = flash_attention_fwd(q3, k3, v3, None, True)
        a3 = (q3, k3, v3, o3, l3, do3, None, True)
        bound, by = backward_bound("fused", q3, k3, None, True)
        row = {"fused_ms": device_ms(lambda: flash_attention_bwd_fused(*a3)),
               "b2_ms": device_ms(lambda: (flash_attention_bwd_dq(*a3),
                                           flash_attention_bwd_dkv(*a3))),
               "plain_ms": device_ms(lambda: flash_attention_bwd_reference(
                   *a3), calls=2, repeats=5),
               "bound_ms": bound, "bound_by": by}
        qt3, kt3, vt3 = (x.transpose(1, 2).detach().requires_grad_()
                         for x in (q3, k3, v3))
        os3 = F.scaled_dot_product_attention(qt3, kt3, vt3, is_causal=True)
        dot3 = do3.transpose(1, 2)
        row["library_ms"] = device_ms(lambda: torch.autograd.grad(
            os3, (qt3, kt3, vt3), dot3, retain_graph=True))
        timings["b3_" + label] = row
        print(f"backward timing B3 vs B2a+B2b {label} (b={b3} h={h3} "
              f"s={s3} d={d3} causal): " + " ".join(
                  f"{key}={val:.5f}" if isinstance(val, float) else
                  f"{key}={val}" for key, val in row.items()) + f" [{card}]")
    results["backward_timing"] = timings
    return timings


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
            paths = ["b2"] + (["b3"] if fa.use_fused_backward(d, s, kv_len)
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
    return max_err, time_backward(card, results, max_err)


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
                   "B5b": fbs.flash_block_sparse_bwd}


def reset_launches():
    for counter in KERNEL_COUNTERS.values():
        counter.launches = 0


def read_launches():
    return {name: counter.launches
            for name, counter in KERNEL_COUNTERS.items()}


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


def train_setup():
    """The train phase's engine, model config and fixed batch on the
    card: GPT-2-medium at full width and depth, bench.py's GPT-2 leg
    (``bench.py:806-816``): seq 1024, micro-batch 8, dropout 0.1 at all
    three sites, Lamb lr 1e-4, ZeRO-2, bf16, random weights from
    ``SEED`` and token ids from ``SEED + 1``.
    ``examples/profile_torch_train.py`` profiles this same set-up."""
    b, _, s, _ = TRAIN_ATTN
    cfg = GPT2Config.gpt2_medium(embd_dropout=DROPOUT, attn_dropout=DROPOUT,
                                 resid_dropout=DROPOUT)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(cfg), model_parameters=random_params(cfg, SEED),
        config=dict(TRAIN_CONFIG))
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
          == layers * steps and launches["B3"] == 0
          and launches["B4"] == 3 * layers * steps
          and launches["B5a"] == launches["B5b"] == 0,
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


def card_vs_cpu(label, cfg, seq, seed):
    """3 steps of ``PARITY_CONFIG`` (micro-batch 2, accumulation 2,
    clipping 1.0, Adam under WarmupLR) of ``cfg``'s model in fp32 with
    TF32 off, on the card and on the CPU from the same weights and
    batches: the loss trajectories must agree to rtol 1e-3.  Returns
    ``(card losses, cpu losses, the card run's launches)``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = random_params(cfg, SEED)
    rng = np.random.default_rng(seed)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(2, seq))}
               for _ in range(6)]
    trajectories, launches = {}, None
    for where, device in (("card", DEVICE), ("cpu", torch.device("cpu"))):
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=GPT2LMHead(cfg), model_parameters=params,
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


def only_launched(launches, names, expected):
    """Whether every kernel of ``names`` launched ``expected`` times and
    no other kernel launched at all."""
    return all(n == (expected if name in names else 0)
               for name, n in launches.items())


def phase_train_parity(results):
    """Card against CPU (:func:`card_vs_cpu`): 2 layers at GPT-2-medium
    width, dropout 0, seq 128.  At seq 128 the backward takes B3."""
    cfg = GPT2Config(hidden_size=1024, num_heads=16, num_layers=2,
                     embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)
    card, cpu, launches = card_vs_cpu("train parity", cfg, 128, SEED + 2)
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
    """The bound of one B5a ("fwd") or B5b ("bwd") call: q, k, v (and dO,
    lse, Δ) read once, out and lse (or dq, dk, dv) written once, against
    4·d (forward) or 10·d (backward) flops per visible pair of the
    active tiles."""
    b, s, h, d = q.shape
    tensor = b * s * h * d * q.element_size()
    rows = b * h * s * 4
    nbytes, per_pair = ((4 * tensor + rows, 4) if kind == "fwd"
                        else (7 * tensor + 2 * rows, 10))
    return bound_ms(nbytes, per_pair * d * b * sparse_pairs(layout, s, h,
                                                            causal),
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
    check_aggregation_raises()
    return max_err, time_sparse(card, results)


def check_aggregation_raises():
    """Where the JAX package runs its G×G super-tile kernels ("auto" at
    layout blocks of up to 128 rows, or an explicit factor), the entry
    point raises and launches nothing: B5 never stands in for them."""
    q = torch.zeros(1, 1024, 2, 64, device=DEVICE)
    before = read_launches()
    for blk, q_agg in ((128, "auto"), (16, "auto"), (256, 2)):
        layout = np.tril(np.ones((1, 1024 // blk, 1024 // blk), np.int64))
        try:
            fbs.flash_block_sparse_attention(q, q, q, layout, causal=True,
                                             q_agg=q_agg)
        except NotImplementedError as e:
            check("B6" in str(e), f"blk {blk} q_agg {q_agg}: {e}")
        else:
            check(False, f"blk {blk} q_agg={q_agg!r} ran, where the JAX "
                         f"package runs super-tile kernels")
    check(read_launches() == before, "a refused call launched a kernel")
    print("sparse kernel: q_agg='auto' at blk 128 and 16 and q_agg=2 at blk "
          "256 raise, naming B6; nothing launched")


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
    card, cpu, launches = card_vs_cpu("sparse train parity", cfg, PARITY_SEQ,
                                      SEED + 3)
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
    op_builder.build()
    build_s = time.monotonic() - t0
    print(f"env: kernels built in {build_s:.1f} s ({list(op_builder.SOURCES)})")
    results["env"] = {"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "build_seconds": build_s}

    # 2. kernel: B1 against its plain version
    max_err, timings = phase_kernel(card, results)
    # 3. backward: B2a+B2b, B3 and B4 against their plain versions
    bwd_err, bwd_timings = phase_backward(card, results)

    # 4. serve, at the full width of GPT-2-medium
    config = GPT2Config.gpt2_medium()
    model = GPT2LMHead(config)
    params = random_params(config, seed=SEED)
    serve_launches = phase_serve(card, model, params, results)
    check(serve_launches > 0, "the serve path never launched B1")
    # 5. parity, fp32 on the card against the CPU
    phase_parity(model, params, results)
    del model, params

    # 6. train, GPT-2-medium at full width and depth
    train_launches = phase_train(card, results)
    # 7. train parity, card against CPU
    parity_launches = phase_train_parity(results)

    # 8. sparse kernel: B5a and B5b against their plain versions
    sparse_err, sparse_timings = phase_sparse_kernel(card, results)
    # 9. sparse train, GPT-2-medium at seq 4096
    sparse_launches = phase_sparse_train(card, results)
    # 10. sparse train parity, card against CPU
    sparse_parity_launches = phase_sparse_parity(results)

    launches = {name: train_launches[name] + parity_launches[name]
                + sparse_launches[name] + sparse_parity_launches[name]
                for name in KERNEL_COUNTERS}
    launches["B1"] += serve_launches
    results["launches"] = {"serve": {"B1": serve_launches},
                           "train": train_launches,
                           "train_parity": parity_launches,
                           "sparse_train": sparse_launches,
                           "sparse_train_parity": sparse_parity_launches}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main paths never launched: {launches}")

    main_shape = timings[BUCKETS[-1]]
    b3 = dict(bwd_timings["b3_parity_fp32"],
              kernel_ms=bwd_timings["b3_parity_fp32"]["fused_ms"])
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
        kernel_entry("flash_block_sparse_fwd (B5a)", SPARSE_SOURCE,
                     SPARSE_REF + ":213", launches["B5a"], sparse_err["fwd"],
                     sparse_timings["fwd"]),
        kernel_entry("flash_block_sparse_bwd (B5b)", SPARSE_SOURCE,
                     SPARSE_REF + ":253", launches["B5b"], sparse_err["bwd"],
                     sparse_timings["bwd"])]
    results["kernels"] = kernels
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
