"""Run a function on N gloo ranks, for the port's data-parallel tests.

Jax-free, so the spawned ranks import neither jax nor the JAX package.
:func:`run_ranks` spawns ``world`` processes, each of which joins a gloo
process group through a ``file://`` store under the test's ``tmp_path``
(no fixed port that two pytest workers could both take), runs ``fn(rank,
world, seed, *args)`` on one torch thread, and hands back what it
returned (pickled numpy arrays and plain values).  Every wait is bounded:
the process group's own timeout covers a collective that one rank never
joins, and the parent kills the whole group when a rank dies or the
deadline passes, so the test fails instead of hanging.
"""

import multiprocessing
import os
import pickle
import time
import traceback

GROUP_TIMEOUT_SECS = 60.0


def _rank_main(fn, rank, world, store, out_dir, seed, args):
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch.utils.distributed import init_distributed

    torch.set_num_threads(1)
    try:
        init_distributed(init_method=f"file://{store}", world_size=world,
                         rank=rank, device="cpu", timeout=GROUP_TIMEOUT_SECS,
                         verbose=False)
        result = fn(rank, world, seed, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    # the results are on disk: leave without tearing the gloo group down
    # (its teardown can abort a rank whose peer closed its sockets first)
    os._exit(0)


def run_ranks(fn, world, tmp_path, *args, seed=0, timeout=240.0):
    """``[fn's result on rank 0, ..., on rank world-1]``; raises
    RuntimeError (with the failing rank's traceback) when a rank fails,
    dies or outlasts ``timeout`` seconds.  ``fn`` must be importable by
    name (a module-level function of a module under ``tests/``)."""
    out_dir = os.path.join(str(tmp_path), f"ranks-{fn.__name__}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, store, out_dir, seed, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            for p in procs:
                p.join(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10.0)
    errors = []
    for rank, p in enumerate(procs):
        err = os.path.join(out_dir, f"rank{rank}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {rank}: exit code {p.exitcode}"
                          + (" (a signal: a crash, or killed by this "
                             "harness)" if p.exitcode is not None
                             and p.exitcode < 0 else ""))
    if errors:
        raise RuntimeError(f"{fn.__name__} on {world} gloo ranks failed:\n"
                           + "\n".join(errors))
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
