#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on
one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources, holds
each against its plain PyTorch version on the card, serves GPT-2-medium
at full width through the port's ``InferenceEngine``, and checks greedy
tokens on the card against a CPU serve of the same weights.  Phases, in
order; any failure raises, so the script exits non-zero:

1. env     — card name and power limit, torch/CUDA versions, kernel build;
2. kernel  — the flash-attention forward kernel vs
             ``flash_attention_reference`` in fp32 and bf16, out and lse
             (at each prefill bucket on strided views of a fused QKV
             projection, as the prefill passes them), and its device
             time per launch at each bucket (median of 20 runs of 10
             back-to-back launches between CUDA events) beside the
             plain version's, ``scaled_dot_product_attention``'s (a
             yardstick the port never calls) and the card's bound;
3. serve   — GPT-2-medium, bf16, random weights from a fixed numpy seed,
             16 staggered requests; every request gets its 32 tokens and
             the flash kernel runs once per layer per prefill;
4. parity  — the same GPT-2-medium in fp32 served on the card and on the
             CPU: greedy tokens must agree.

Then one ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and last the line ``{"ok": true, "device": {...}}``.  With ``--out PATH``
the per-case numbers also go to PATH as JSON.  Needs one card and no
network; imports nothing of JAX.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.transformer.flash_attention import (
    flash_attention_fwd, flash_attention_reference)
from deepspeed_tpu_torch.utils.params import params_from_numpy

DEVICE = torch.device("cuda")
# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BUCKETS = (128, 256, 512, 1024)
SEED = 0
FLASH_SOURCE = "deepspeed_tpu_torch/csrc/transformer/flash_attention_fwd.cu"
FLASH_REPLACES = "deepspeed_tpu/ops/transformer/flash_attention.py:183"
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
    vis = (torch.ones(b, kv_len) if mask is None
           else (mask.float().cpu() > 0).float())
    if causal:
        rows = torch.arange(s)[:, None] >= torch.arange(kv_len)[None, :]
        pairs = (rows[None].float() * vis[:, None, :]).sum()
    else:
        pairs = vis.sum() * s
    flops = 4.0 * d * h * float(pairs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the per-case numbers "
                        "to this JSON file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; run this on the card",
              file=sys.stderr)
        return 1
    results = {"kernel": []}
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

    # 2. kernel
    max_err, timings = phase_kernel(card, results)

    # 3. serve, at the full width of GPT-2-medium
    config = GPT2Config.gpt2_medium()
    model = GPT2LMHead(config)
    params = random_params(config, seed=SEED)
    launches = phase_serve(card, model, params, results)
    check(launches > 0, "the main path never launched the flash kernel")

    # 4. parity, fp32 on the card against the CPU
    phase_parity(model, params, results)

    main_shape = timings[BUCKETS[-1]]
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
        "launches": launches, "max_abs_err": max_err,
        "ms": main_shape["kernel_ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"]}]
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
