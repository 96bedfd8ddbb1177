#!/usr/bin/env python3
"""Where a training step's time goes on the card, for the PyTorch/CUDA port.

Trains GPT-2-medium at full width and depth on one CUDA card, set up by
``chip_smoke.train_setup`` exactly as ``chip_smoke.py``'s train phase
(bench.py's GPT-2 leg: seq 1024, micro-batch 8, dropout 0.1, Lamb lr
1e-4, ZeRO-2, bf16, random weights from a numpy seed), or, with
``--sparse``, by ``chip_smoke.sparse_train_setup`` as its sparse train
phase (4096 positions, seq 4096, micro-batch 2, block-sparse attention
under the Fixed unidirectional layout of 256-row blocks):

    python3 examples/profile_torch_train.py [--sparse] [--out PATH]

Step wall time is a host clock around ``train_batch`` calls that end in
``torch.cuda.synchronize()``, median of 5 after 2 warm-up steps.  Device
busy time is the sum of the card's kernel and copy times that
``torch.profiler`` records over 2 more steps; idle share is
1 - busy / wall.  Busy time is split by kernel family: the flash kernels
B1 (forward), B2a and B2b (backward), the block-sparse kernels B5a
(forward) and B5b (its dq and its dk/dv kernel), matrix products
(cuBLAS/CUTLASS), and everything else (elementwise, reductions, copies, the optimizer).
Prints one JSON object (also written to ``--out PATH``) with the card's
name and power limit beside the numbers.
"""

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (SPARSE_ATTN, TRAIN_ATTN,  # noqa: E402
                        sparse_train_setup, train_setup)

FAMILIES = (("B1 flash forward", ("flash_fwd",)),
            ("B2a flash dq", ("flash_bwd_dq",)),
            ("B2b flash dk/dv", ("flash_bwd_dkv",)),
            ("B5a sparse flash forward", ("fbs_fwd",)),
            ("B5b sparse flash dq", ("fbs_bwd_dq",)),
            ("B5b sparse flash dk/dv", ("fbs_bwd_dkv",)),
            ("matrix products", ("gemm", "cutlass", "xmma", "cublas",
                                 "nvjet")))


def family(name):
    lowered = name.lower()
    for label, keys in FAMILIES:
        if any(key in lowered for key in keys):
            return label
    return "other"


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the result to this "
                        "JSON file")
    parser.add_argument("--sparse", action="store_true", help="profile the "
                        "sparse train set-up (seq 4096, block-sparse "
                        "attention) instead of the dense one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    engine, cfg, batch = (sparse_train_setup if args.sparse
                          else train_setup)()
    b, _, s, _ = SPARSE_ATTN if args.sparse else TRAIN_ATTN

    def step():
        return engine.train_batch(iter([batch]))

    for _ in range(2):
        step()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)

    steps = 2
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    by_family = collections.Counter()
    for name, us in by_name.items():
        by_family[family(name)] += us
    busy = sum(by_name.values()) / 1e3 / steps if events else None
    result = {
        "card": card, "model": "gpt2-medium", "layers": cfg.num_layers,
        "attn_impl": cfg.attn_impl,
        "seq": s, "micro_batch": b, "dtype": "bfloat16",
        "torch": torch.__version__, "step_wall_ms": wall,
        "step_wall_ms_all": walls,
        "device_busy_ms_per_step": busy,
        "idle_share": None if busy is None else 1.0 - busy / wall,
        "device_events_per_step": len(events) / steps,
        "busy_ms_per_step_by_family": {
            k: v / 1e3 / steps for k, v in by_family.most_common()},
        "top_kernels_ms_per_step": [
            [name[:80], us / 1e3 / steps]
            for name, us in by_name.most_common(12)],
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
