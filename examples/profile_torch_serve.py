#!/usr/bin/env python3
"""Where serving time goes on the card, for the PyTorch/CUDA port.

Times the port's prefill (one request per declared bucket) and its
full-width decode iteration at GPT-2-medium width in bf16, random
weights from a numpy seed, on one CUDA card:

    python3 examples/profile_torch_serve.py [--out PATH]

Wall times are host clocks around calls that end in a token fetch (the
serve loop's own sync), median of repeats after warm-up.  Device busy
time is the sum of the card's kernel and copy times that
``torch.profiler`` records over the same calls; idle share is
1 - busy / wall.  Prints one JSON object (also written to ``--out PATH``
if given) with the card's name and power limit beside the numbers.
"""

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deepspeed_tpu_torch.inference import (  # noqa: E402
    DeepSpeedInferenceConfig, build_decode, build_prefill, init_kv_cache)
from deepspeed_tpu_torch.models.gpt2 import (  # noqa: E402
    GPT2Config, random_params)
from deepspeed_tpu_torch.ops.transformer.flash_attention import (  # noqa: E402
    flash_attention_fwd)
from deepspeed_tpu_torch.utils.params import params_from_numpy  # noqa: E402

CONFIG = {"inference": {
    "kv_block_size": 16, "max_seq_len": 1024,
    "prefill_buckets": [128, 256, 512, 1024], "max_batch_slots": 8,
    "kv_blocks": 520, "token_budget": 8192, "max_new_tokens": 32,
    "weights_dtype": "bfloat16"}}
SEED = 0


def wall_ms(fn, repeats, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()   # ends in a host fetch of the token(s)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn, calls, top=8):
    """Device busy ms per call, CUDA events per call, top kernels."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return {"device_busy_ms": None, "note": "profiler saw no device "
                "activity"}
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    return {
        "device_busy_ms": busy_us / 1e3 / calls,
        "device_events_per_call": len(events) / calls,
        "top_kernels_ms_per_call": [
            [name[:80], us / 1e3 / calls]
            for name, us in by_name.most_common(top)],
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the result to this "
                        "JSON file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = GPT2Config.gpt2_medium()
    icfg = DeepSpeedInferenceConfig(CONFIG)
    dev = torch.device("cuda")
    params = params_from_numpy(random_params(cfg, SEED), dev,
                               torch.bfloat16)
    k_cache, v_cache = init_kv_cache(
        cfg.num_layers, icfg.kv_blocks, icfg.kv_block_size, cfg.num_heads,
        cfg.hidden_size // cfg.num_heads, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(SEED + 1)
    width = icfg.max_blocks_per_seq
    result = {"card": card, "model": "gpt2-medium", "layers": cfg.num_layers,
              "dtype": "bfloat16", "torch": torch.__version__,
              "prefill": {}}

    with torch.no_grad():
        for bucket in icfg.prefill_buckets:
            prefill = build_prefill(cfg, icfg, bucket)
            true_len = bucket - bucket // 5
            ids = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, size=(1, bucket))).to(dev)
            table = torch.zeros(width, dtype=torch.int64, device=dev)
            table[:bucket // icfg.kv_block_size] = torch.arange(
                1, 1 + bucket // icfg.kv_block_size)

            def one_prefill():
                int(prefill(params, k_cache, v_cache, ids, true_len, table))

            row = {"true_len": true_len,
                   "wall_ms": wall_ms(one_prefill, repeats=10)}
            before = flash_attention_fwd.launches
            row.update(device_profile(one_prefill, calls=3))
            row["flash_fwd_launches_per_call"] = \
                (flash_attention_fwd.launches - before) / 3
            row["idle_share"] = (None if row["device_busy_ms"] is None else
                                 1.0 - row["device_busy_ms"] / row["wall_ms"])
            result["prefill"][bucket] = row

        # one full-width decode iteration: 8 live slots, contexts ~500
        n = icfg.max_batch_slots
        per_slot = width // n
        tables = torch.zeros((n, width), dtype=torch.int64)
        for slot in range(n):
            tables[slot, :per_slot] = torch.arange(
                1 + slot * per_slot, 1 + (slot + 1) * per_slot)
        tables = tables.to(dev)
        ctx_lens = torch.arange(500, 500 + n, device=dev)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               size=n)).to(dev)
        decode = build_decode(cfg, icfg)

        def one_decode():
            decode(params, k_cache, v_cache, tables, ctx_lens,
                   tokens).tolist()

        row = {"slots": n, "context": 500,
               "wall_ms": wall_ms(one_decode, repeats=20)}
        row.update(device_profile(one_decode, calls=10))
        row["idle_share"] = (None if row["device_busy_ms"] is None else
                             1.0 - row["device_busy_ms"] / row["wall_ms"])
        result["decode"] = row

    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
