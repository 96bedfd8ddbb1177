#!/usr/bin/env python3
"""Times the host Adam kernel of DeepSpeedCPUAdam (``csrc/adam/cpu_adam.cpp``)
on this machine's CPUs, against another build of it.

    python3 examples/profile_torch_cpu_adam.py --base build/parent/deepspeed_tpu_torch/csrc/adam/cpu_adam.cpp

The kernel runs in place over ``--params`` fp32 parameters (p, m, v
and g, pinned where a card is present), as the engine runs it on its
host state: each time is the median of ``--repeats`` calls after one
warm-up, at each OpenMP team size of ``--threads`` (0: OpenMP's own
choice).  ``--base`` is an earlier source of the kernel (its C entry
without the team argument), built with the JAX builder's flags (this
package's without ``-fno-math-errno``) and timed at OpenMP's choice;
the two builds' outputs from the same inputs must be bitwise equal.
Prints one JSON line: the times, the parameters, the host's CPUs and
the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from deepspeed_tpu_torch.ops import op_builder  # noqa: E402
from deepspeed_tpu_torch.ops.adam import cpu_adam  # noqa: E402
import train_torch_pipe as pipe_example  # noqa: E402

HP = (1e-4, 0.9, 0.999, 1e-8, 0.01)


def base_kernel(src):
    """The C entry of an earlier source, built with the JAX builder's
    flags into ``build/``."""
    flags = [f for f in op_builder.GXX_FLAGS if f != "-fno-math-errno"]
    out = op_builder.BUILD_DIR / "cpu_adam_base.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([op_builder.find_gxx(), *flags, "-o", str(out), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(out)).ds_adam_step
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + \
        [ctypes.c_float] * 7 + [ctypes.c_int]
    fn.restype = None
    return fn


def tensors(n, pin, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        t = torch.empty(n, dtype=torch.float32, pin_memory=pin)
        chunk = 1 << 24
        for a in range(0, n, chunk):
            b = min(n, a + chunk)
            x = rng.standard_normal(b - a, dtype=np.float32)
            t[a:b] = torch.from_numpy(np.abs(x) if i == 2 else x)
        out.append(t)
    return out


def timed(call, repeats):
    call()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times), times


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--params", type=int, default=774_030_080,
                        help="default: GPT-2-large's parameters")
    parser.add_argument("--threads", default="0",
                        help="comma-separated OpenMP team sizes")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--base", help="an earlier cpu_adam.cpp to time "
                        "and hold bitwise against this one")
    args = parser.parse_args(argv)
    pin = torch.cuda.is_available()
    n = args.params
    p, m, v, g = tensors(n, pin)
    bc = cpu_adam.bias_corrections(HP[1], HP[2], 3)
    result = {"params": n, "host_cpus": len(os.sched_getaffinity(0)),
              "pinned": pin, "card": pipe_example.card_line(),
              "bytes_per_call": 28 * n, "kernel_ms": {}}
    for threads in (int(x) for x in args.threads.split(",")):
        med, runs = timed(lambda: cpu_adam.ds_adam_step(
            p, m, v, g, *HP, *bc, True, threads=threads), args.repeats)
        result["kernel_ms"][str(threads)] = {"median": med, "runs": runs}
    if args.base:
        fn = base_kernel(args.base)

        def base(state, grad):
            ptrs = [t.data_ptr() for t in (*state, grad)]
            fn(*ptrs[:3], *ptrs, grad.numel(), *HP, *bc, 1)

        med, runs = timed(lambda: base((p, m, v), g), args.repeats)
        result["base_ms"] = {"median": med, "runs": runs}
        # one step of each build from the same state, on a prefix
        k = min(n, (1 << 24) + 3)
        ours, theirs = ([t[:k].clone() for t in (p, m, v)]
                        for _ in range(2))
        cpu_adam.ds_adam_step(*ours, g[:k].clone(), *HP, *bc, True)
        base(theirs, g[:k].clone())
        result["bitwise_equal_to_base"] = all(
            torch.equal(a, b) for a, b in zip(ours, theirs))
    print(json.dumps(result))
    return 0 if result.get("bitwise_equal_to_base", True) else 1


if __name__ == "__main__":
    sys.exit(main())
