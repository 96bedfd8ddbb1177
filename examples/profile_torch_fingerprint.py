#!/usr/bin/env python3
"""What the fleet integrity fingerprint costs on the card, for the
PyTorch/CUDA port (``deepspeed_tpu_torch/resilience/fingerprint.py``).

1. ``train``: chip_smoke phase 38b's training replica (GPT-2-medium,
   bf16, micro-batch 1, seq 1024, dropout 0.1, Adam, ``steps_per_print``
   1, resilience and ``resilience.integrity`` on), built here as rank 0
   of a fleet of 2 so the consensus arms: 2 warm-up steps, then
   ``--pairs`` pairs of steps in turns, one with the fingerprint
   switched off and one with it due, each step's wall time (a step ends
   on its one fetch, which carries the fingerprint).  Then one
   ``fingerprint`` call on the engine's (master, moments) alone.  The
   card's fingerprint of the master must equal the CPU's.
2. ``leaves``: the same call on the replica's leaves
   (``train_state``) and on the model's weights in bf16, leaf by leaf as
   a serving replica votes on them (``serve_weights``), for this
   checkout's module and each ``--impl PATH`` (other copies of it, an
   older commit's unpacked with ``git archive``); each must give the
   same value.

    python3 examples/profile_torch_fingerprint.py [--impl PATH ...]
        [--pairs 10] [--out PATH]

Device ms: the median of 5 runs of one call between CUDA events after a
spin kernel that holds the stream until the call is queued
(``chip_smoke.device_times``), so no host time is in it; a call of more
launches than the stream's queue holds cannot be timed so, and has
``null``.  Stream ms: the median of 3 runs of one call between CUDA
events with no spin (device time, or the host's queueing where that is
longer).  Host ms: the median time to queue one call.  The bound: each
word read once over the card's memory rate.  Prints one JSON object
(also written to ``--out PATH``) with the card's name and power limit.
"""

import argparse
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,  # noqa: E402
                                             GPT2LMHead, random_params)
from deepspeed_tpu_torch.resilience import fingerprint as ours  # noqa: E402
from deepspeed_tpu_torch.utils.params import tree_leaves  # noqa: E402

FLEET_ENV = ("DS_PROCESS_ID", "DS_NUM_PROCESSES", "DS_TELEMETRY_DIR")


def load_impl(path):
    spec = importlib.util.spec_from_file_location(
        f"fingerprint_{len(path)}_{abs(hash(path))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.fingerprint


def time_call(fn, leaves):
    """{device_ms, stream_ms, host_ms, value} of ``fn(leaves)``."""
    value = int(fn(leaves))                          # warm-up
    try:
        device = statistics.median(chip_smoke.device_times(
            lambda: fn(leaves), calls=1, repeats=5, warmup=0))
    except RuntimeError:
        device = None                                # outran the queue
    stream, host = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn(leaves)
        end.record()
        host.append(1e3 * (time.perf_counter() - t0))
        end.synchronize()
        stream.append(start.elapsed_time(end))
    return {"device_ms": device, "stream_ms": statistics.median(stream),
            "host_ms": statistics.median(host), "value": value}


def replica_engine(run_dir, params):
    """Phase 38b's replica as rank 0 of a fleet of 2."""
    d = chip_smoke.DROPOUT
    cfg = GPT2Config.gpt2_medium(embd_dropout=d, attn_dropout=d,
                                 resid_dropout=d)
    config = {"train_batch_size": 1, "steps_per_print": 1,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "bf16": {"enabled": True},
              "resilience": {"enabled": True, "integrity": True},
              "telemetry": {"enabled": True, "run_dir": run_dir}}
    os.environ.update(DS_PROCESS_ID="0", DS_NUM_PROCESSES="2")
    os.environ.pop("DS_TELEMETRY_DIR", None)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2LMHead(cfg),
        model_parameters=params, config=config, dist_init_required=False)
    chip_smoke.check(engine._integrity is not None,
                     "the fingerprint consensus did not arm")
    batch = {"input_ids": np.random.default_rng(chip_smoke.SEED + 1)
             .integers(0, cfg.vocab_size, size=(1, 1024))}
    return engine, batch


def train(engine, batch, pairs):
    """Step wall ms with the fingerprint switched off and due, in
    turns, after 2 warm-up steps."""
    for _ in range(2):
        engine.train_batch(iter([batch]))
    step_ms = {"off": [], "on": []}
    for _ in range(pairs):
        for key in ("off", "on"):
            engine._fingerprint_off = key == "off"
            t0 = time.perf_counter()
            loss = engine.train_batch(iter([batch]))
            step_ms[key].append(1e3 * (time.perf_counter() - t0))
            chip_smoke.check(math.isfinite(float(loss)), f"loss {loss}")
    engine._fingerprint_off = False
    out = {}
    for key, times in step_ms.items():
        q1, median, q3 = statistics.quantiles(times, n=4)
        out[f"step_ms_{key}"] = times
        out[f"step_ms_{key}_median"] = median
        out[f"step_ms_{key}_quartiles"] = [q1, q3]
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--impl", nargs="*", default=[],
                        help="other fingerprint.py files to time beside "
                        "this checkout's")
    parser.add_argument("--pairs", type=int, default=10,
                        help="step pairs (fingerprint off, due) to time")
    parser.add_argument("--out", help="also write the JSON object here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_fingerprint: no CUDA device", file=sys.stderr)
        return 1
    chip_smoke.op_builder.build()
    saved = {k: os.environ.get(k) for k in FLEET_ENV}
    with tempfile.TemporaryDirectory(
            dir=chip_smoke.build_dir()) as run_dir:
        try:
            params = random_params(GPT2Config.gpt2_medium(), chip_smoke.SEED)
            engine, batch = replica_engine(run_dir, params)
            out = {"card": chip_smoke.card_line(),
                   "train": train(engine, batch, args.pairs), "leaves": {}}
            cases = {"train_state": engine._integrity_leaves(),
                     "serve_weights": [
                         torch.from_numpy(x).to(engine.device, torch.bfloat16)
                         for x in tree_leaves(params)[1]]}
            impls = {"checkout": ours.fingerprint,
                     **{path: load_impl(path) for path in args.impl}}
            for case, leaves in cases.items():
                nbytes = sum(x.numel() * x.element_size() for x in leaves
                             if torch.is_tensor(x))
                bound, by = chip_smoke.bound_ms(nbytes, 0, torch.float32)
                row = {"leaves": len(leaves), "bytes": nbytes,
                       "bound_ms": bound, "bound_by": by}
                for name, fn in impls.items():
                    row[name] = time_call(fn, leaves)
                values = {row[name]["value"] for name in impls}
                chip_smoke.check(len(values) == 1, f"{case}: the "
                                 f"implementations disagree: {values}")
                out["leaves"][case] = row
            on_card = int(ours.fingerprint([engine.master]))
            on_cpu = int(ours.fingerprint([engine.master.cpu()]))
            chip_smoke.check(on_card == on_cpu,
                             f"the card's fingerprint of the master "
                             f"{on_card:#x} is not the CPU's {on_cpu:#x}")
            out["master_card_equals_cpu"] = True
            engine.close()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
