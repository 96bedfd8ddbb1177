"""Rank functions and helpers for the port's launcher, elasticity and
integrity tests (jax-free: ``tests/torch_dist.py`` spawns the rank
functions by name, and the launcher's children import nothing of jax).

:func:`launch_main` runs the port's node spawner in this process on one
host's slots and returns its exit code; :func:`launcher_events` reads
its ``events-launcher.jsonl``.  ``REPLICA`` is the fleet child script
(``examples/torch_fleet_replica.py``).
"""

import json
import os
import signal
import socket

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPLICA = os.path.join(REPO, "examples", "torch_fleet_replica.py")
# a schedule of global batch 6 that admits worlds 1, 2 and 3
ELASTIC_1_3 = {"enabled": True, "max_train_batch_size": 6,
               "micro_batch_sizes": [1, 2], "min_gpus": 1, "max_gpus": 3,
               "version": 0.1}
# the replica script's own schedule (global batch 8 on 1, 2 or 4 ranks)
ELASTIC_1_4 = {"enabled": True, "max_train_batch_size": 8,
               "micro_batch_sizes": [2, 4], "min_gpus": 1, "max_gpus": 4,
               "version": 0.1}
# fast supervision for tests: poll, backoff and grace in fractions of
# a second
FAST = {"DS_MONITOR_POLL_SECS": "0.05", "DS_RESTART_BACKOFF_SECS": "0.05",
        "DS_TERM_GRACE_SECS": "5"}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_main(launch, script, script_args=(), slots=(0,),
                max_restarts=0, extra_argv=()):
    """``launch.main`` (either package's spawner module) on this host's
    ``slots``; its exit code.  Signal handlers are restored after."""
    from deepspeed_tpu_torch.launcher.runner import encode_world_info

    world_info = encode_world_info({socket.gethostname(): list(slots)})
    argv = ["--world_info", world_info, "--node_rank", "0",
            "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
            "--max-restarts", str(max_restarts), *extra_argv,
            str(script), *script_args]
    old = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        launch.main(argv)
    except SystemExit as e:
        return e.code
    finally:
        for s, handler in old.items():
            signal.signal(s, handler)
    return 0


def elastic_argv(tmp_path, block, devices):
    path = os.path.join(str(tmp_path), "elastic.json")
    with open(path, "w") as f:
        json.dump({"elasticity": block}, f)
    return ["--elastic-config", path, "--elastic-devices", str(devices),
            "--telemetry-dir", os.path.join(str(tmp_path), "tel")]


def launcher_events(tmp_path, event_type=None):
    path = os.path.join(str(tmp_path), "tel", "events-launcher.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if event_type is None or r["type"] == event_type]


def read_jsonl_dir(out_dir, prefix):
    """Every JSON line of the files under ``out_dir`` named
    ``prefix*``, with the file name under ``"file"``."""
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith(prefix):
            with open(os.path.join(out_dir, name)) as f:
                recs += [dict(json.loads(line), file=name) for line in f
                         if line.strip()]
    return recs


# ------------------------------------------------------------ gloo ranks
def order_check_rank(rank, world, seed, seeds):
    """Iterate one epoch of a shuffled loader whose seed is
    ``seeds[rank]`` with the order check on the world group; returns
    ``"ok"`` or the error text."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

    data = [np.full(3, i, np.float32) for i in range(16)]
    loader = DeepSpeedDataLoader(data, 4 * world, shuffle=True,
                                 seed=seeds[rank],
                                 data_parallel_world_size=world,
                                 data_parallel_rank=rank,
                                 group=dist.group.WORLD)
    try:
        next(iter(loader))
    except RuntimeError as e:
        return str(e)
    return "ok"


def arming_rank(rank, world, seed, run_dir):
    """Build the tiny GPT-2 engine with ``resilience.integrity`` on this
    gloo world at ZeRO-0 and ZeRO-2; returns ``{stage: (consensus armed,
    heartbeat armed)}``."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHead,
                                                 random_params)

    cfg = GPT2Config(vocab_size=256, hidden_size=32, num_layers=2,
                     num_heads=2, max_position_embeddings=64)
    out = {}
    for stage in (0, 2):
        config = {"train_batch_size": 2 * world,
                  "zero_optimization": {"stage": stage},
                  "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                  "resilience": {"enabled": True, "integrity": True,
                                 "integrity_peer_timeout_secs": 30.0},
                  "telemetry": {"enabled": True,
                                "run_dir": os.path.join(run_dir,
                                                        f"s{stage}")}}
        engine, *_ = tds.initialize(model=GPT2LMHead(cfg),
                                    model_parameters=random_params(cfg, 0),
                                    config=config, device="cpu")
        out[stage] = (engine._integrity is not None,
                      engine._fleet_heartbeat is not None)
        engine.close()
    return out


def onebit_integrity_rank(rank, world, seed, run_dir, steps, freeze):
    """Train the tiny GPT-2 with OneBitAdam (``freeze_step`` ``freeze``)
    and ``resilience.integrity`` on this gloo world for ``steps`` steps,
    each rank on its own rows; then, once every rank has published, the
    consensus over the fleet's last fingerprints.  Returns (consensus
    armed, the fingerprinted optimizer fields, the verdicts the steps
    emitted, the final consensus)."""
    import torch.distributed as dist

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHead,
                                                 random_params)
    from deepspeed_tpu_torch.parallel import make_mesh
    from deepspeed_tpu_torch.resilience import integrity as integ
    from deepspeed_tpu_torch.telemetry import read_events

    cfg = GPT2Config(vocab_size=256, hidden_size=32, num_layers=2,
                     num_heads=2, max_position_embeddings=64)
    config = {"train_batch_size": 2 * world, "steps_per_print": 1,
              "optimizer": {"type": "OneBitAdam",
                            "params": {"lr": 1e-3, "freeze_step": freeze}},
              "resilience": {"enabled": True, "integrity": True},
              "telemetry": {"enabled": True, "run_dir": run_dir}}
    engine, *_ = tds.initialize(model=GPT2LMHead(cfg),
                                model_parameters=random_params(cfg, 0),
                                config=config, device="cpu",
                                mesh=make_mesh({"data": world}))
    rng = np.random.default_rng(seed + 1 + rank)
    data = [{"input_ids": rng.integers(0, 256, size=(2, 16))}
            for _ in range(steps)]
    it = iter(data)
    for _ in range(steps):
        engine.train_batch(it)
    engine.vote_integrity()
    dist.barrier()
    final = integ.fingerprint_consensus(
        integ.read_fleet_fingerprints(run_dir, world), world)
    leaves = engine._integrity_leaves()
    fields = [tuple(x.shape) if hasattr(x, "shape") else x
              for x in leaves[1:]]
    engine.close()
    verdicts = [(e["data"]["voted_step"], e["data"]["verdict"],
                 e["data"]["voters"])
                for e in read_events(run_dir)
                if e["type"] == "integrity" and e["rank"] == rank]
    return (engine._integrity is not None, fields, verdicts,
            (final["verdict"], final["step"], final["voters"]))
