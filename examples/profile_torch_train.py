#!/usr/bin/env python3
"""Where a training step's time goes on the card, for the PyTorch/CUDA port.

Trains one of ``chip_smoke.py``'s train set-ups on one CUDA card, at
full width and depth, exactly as that script's phase does:

- default: GPT-2-medium, ``chip_smoke.train_setup`` (bench.py's GPT-2
  leg: seq 1024, micro-batch 8, dropout 0.1, Lamb lr 1e-4, ZeRO-2, bf16,
  random weights from a numpy seed);
- ``--sparse``: ``chip_smoke.sparse_train_setup`` (GPT-2-medium, seq
  4096, micro-batch 2, block-sparse attention under the Fixed
  unidirectional layout of 256-row blocks: B5);
- ``--bert``: ``chip_smoke.bert_train_setup`` (BERT-large pretraining,
  seq 128, micro-batch 64, MLM gather of 20 + NSP);
- ``--bert-sparse``: ``chip_smoke.bert_sparse_train_setup`` (BERT-large,
  seq 4096, micro-batch 2, Fixed bidirectional layout of 128-row blocks:
  the super-tile kernels B6);
- ``--offload``: ``chip_smoke.offload_large_setup`` (bench.py's
  GPT-2-large offload leg: seq 1024, batch 4, remat, ``loss_chunk`` 256,
  Adam, bf16, ZeRO-2 with ``cpu_offload``, fp32 host state streamed in
  512 MB chunks at depth 2).

``--dp`` (with the GPT-2 or the BERT set-up) trains on the data-parallel
path instead, as ``chip_smoke.py``'s phase 30 does: ``torch.distributed``
on NCCL at world size 1 through a ``file://`` store under ``build/``, and
``make_mesh({"data": 1})`` (the ZeRO-2 reduce-scatter, the rank's rows
of the master and the all-gather of the params).

    python3 examples/profile_torch_train.py [--sparse | --bert |
        --bert-sparse | --offload] [--dp] [--out PATH]

Step wall time is a host clock around ``train_batch`` calls that end in
``torch.cuda.synchronize()``, median of 5 after 2 warm-up steps.  Device
busy time is the sum of the card's kernel and copy times that
``torch.profiler`` records over 2 more steps; idle share is
1 - busy / wall.  Busy time is split by kernel family: the flash kernels
B1 (forward), B2a and B2b (backward), B3 (fused backward), the
block-sparse kernels B5a (forward) and B5b (its dq and its dk/dv
kernel; in bf16 these are B6a's, B6b's and B6c's tensor-core kernels at
G = 1, counted as B5's in the ``--sparse`` step, which launches no B6),
the super-tile kernels B6a, B6b and B6c, matrix products
(cuBLAS/CUTLASS), the NCCL collectives, and everything else (elementwise, reductions, copies,
the optimizer), and the copies between host and card (H2D, D2H).
Under ``--offload`` it also gives the copies' time that runs beside a
kernel (their overlap with the update and the rest of the step), the
share of the wall in which the card runs no kernel and no copy, and
the two ways the params can go back after a host update
(:func:`params_back_ms`: the design measurement behind
``ops/adam/cpu_adam.py``'s choice).
Beside them, the registers and spills (``nvcc -Xptxas -v``) of every
kernel in the sources of the attention kernels the step runs.
Prints one JSON object (also written to ``--out PATH``) with the card's
name and power limit beside the numbers.
"""

import argparse
import collections
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.parallel import DATA_AXIS, make_mesh  # noqa: E402
from deepspeed_tpu_torch.utils.distributed import \
    init_distributed  # noqa: E402

# --mode -> (set-up, model name, (batch, seq))
SETUPS = {
    "gpt2": (chip_smoke.train_setup, "gpt2-medium",
             chip_smoke.TRAIN_ATTN[0::2]),
    "sparse": (chip_smoke.sparse_train_setup, "gpt2-medium",
               chip_smoke.SPARSE_ATTN[0::2]),
    "bert": (chip_smoke.bert_train_setup, "bert-large",
             (chip_smoke.BERT_BATCH, chip_smoke.BERT_SEQ)),
    "bert-sparse": (chip_smoke.bert_sparse_train_setup, "bert-large",
                    chip_smoke.SPARSE_ATTN[0::2]),
    "offload": (chip_smoke.offload_large_setup, "gpt2-large",
                (chip_smoke.LARGE_BATCH, chip_smoke.TRAIN_ATTN[2])),
}

FAMILIES = (("B1 flash forward", ("flash_fwd",)),
            ("B2a flash dq", ("flash_bwd_dq",)),
            ("B2b flash dk/dv", ("flash_bwd_dkv",)),
            ("B3 flash fused backward", ("flash_bwd_fused",)),
            ("B6a super-tile forward", ("agg_fwd",)),
            ("B6b super-tile dq", ("agg_bwd_dq",)),
            ("B6c super-tile dk/dv", ("agg_bwd_dkv",)),
            ("B5a sparse flash forward", ("fbs_fwd",)),
            ("B5b sparse flash dq", ("fbs_bwd_dq",)),
            ("B5b sparse flash dk/dv", ("fbs_bwd_dkv",)),
            ("matrix products", ("gemm", "cutlass", "xmma", "cublas",
                                 "nvjet")),
            ("NCCL collectives", ("nccl",)),
            ("H2D copies", ("memcpy htod",)),
            ("D2H copies", ("memcpy dtoh",)))


# the bf16 B5a and B5b run B6a's, B6b's and B6c's kernels at G = 1
B5_AT_G1 = {"B6a super-tile forward": "B5a sparse flash forward",
            "B6b super-tile dq": "B5b sparse flash dq",
            "B6c super-tile dk/dv": "B5b sparse flash dk/dv"}

# --mode -> the kernel libraries of its attention
LIBRARIES = {"gpt2": ("flash_attention_fwd", "flash_attention_bwd"),
             "sparse": ("flash_block_sparse_agg",),
             "bert": ("flash_attention_fwd", "flash_attention_bwd"),
             "bert-sparse": ("flash_block_sparse_agg",),
             "offload": ("flash_attention_fwd", "flash_attention_bwd")}


def family(name, mode):
    lowered = name.lower()
    for label, keys in FAMILIES:
        if any(key in lowered for key in keys):
            return B5_AT_G1.get(label, label) if mode == "sparse" else label
    return "other"


def is_copy(name):
    return family(name, "offload") in ("H2D copies", "D2H copies")


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


def copy_overlap(events):
    """(copy time, copy time beside a kernel, device time with neither)
    over ``events`` (name, start us, end us), in microseconds."""
    copies = [(a, b) for n, a, b in events if is_copy(n)]
    kernels = [(a, b) for n, a, b in events if not is_copy(n)]
    c, k = union_us(copies), union_us(kernels)
    both = c + k - union_us(copies + kernels)
    return c, both, union_us(copies + kernels)


def registers_spills(mode):
    """{kernel: [registers, spill bytes stored]} of the sources of
    ``mode``'s attention kernels, from a ``-Xptxas -v`` build."""
    out_dir = op_builder.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    usage = {}
    for lib in LIBRARIES[mode]:
        usage.update(op_builder.ptxas_usage(
            op_builder.CSRC_DIR / op_builder.SOURCES[lib],
            out_dir / f"{lib}.so"))
    return usage


def params_back_ms(engine):
    """ms of the two ways the compute params can go back from the host
    master, twice each in turns: ``card``, the engine's (the fp32
    master up in chunks, cast on the card), and ``host`` (cast to bf16
    on the host into a pinned staging buffer, one 2-byte copy up)."""
    staging = torch.empty_like(engine.master, dtype=engine.compute_dtype,
                               pin_memory=True)

    def host():
        staging.copy_(engine.master)
        engine._compute.copy_(staging, non_blocking=True)

    out = {}
    for how, fn in (("card", engine._params_from_host), ("host", host)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.setdefault(how, []).append(1e3 * (time.perf_counter() - t0))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the result to this "
                        "JSON file")
    modes = parser.add_mutually_exclusive_group()
    for mode in ("sparse", "bert", "bert-sparse", "offload"):
        modes.add_argument(f"--{mode}", dest="mode", action="store_const",
                           const=mode, help=f"profile the {mode} train "
                           f"set-up of chip_smoke.py instead of GPT-2's")
    parser.add_argument("--dp", action="store_true", help="train on the "
                        "data-parallel path (NCCL at world size 1, "
                        "make_mesh({'data': 1})); GPT-2 and BERT only")
    parser.set_defaults(mode="gpt2")
    args = parser.parse_args()
    if args.dp and args.mode not in ("gpt2", "bert"):
        parser.error("--dp goes with the GPT-2 or the BERT set-up")
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    setup, model_name, (b, s) = SETUPS[args.mode]
    store_dir = None
    if args.dp:
        store_dir = tempfile.mkdtemp(prefix="profile_nccl_",
                                     dir=chip_smoke.build_dir())
        init_distributed(init_method=f"file://{store_dir}/store",
                         world_size=1, rank=0, device="cuda")
        engine, cfg, batch = setup(mesh=make_mesh({DATA_AXIS: 1}))
    else:
        engine, cfg, batch = setup()

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
        by_family[family(name, args.mode)] += us
    busy = sum(by_name.values()) / 1e3 / steps if events else None
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events]
    copy_us, beside_us, active_us = copy_overlap(spans)
    result = {
        "card": card, "model": model_name, "mode": args.mode,
        "layers": getattr(cfg, "num_layers", None)
        or cfg.num_hidden_layers, "attn_impl": cfg.attn_impl,
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
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "copy_ms_per_step": copy_us / 1e3 / steps,
        "copy_ms_beside_a_kernel_per_step": beside_us / 1e3 / steps,
        "idle_share_no_kernel_no_copy": (
            None if not events else 1.0 - active_us / 1e3 / steps / wall),
        "registers_spills": registers_spills(args.mode)}
    if args.mode == "offload":
        result["params_back_ms"] = params_back_ms(engine)
    result["dp"] = args.dp
    if store_dir is not None:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
