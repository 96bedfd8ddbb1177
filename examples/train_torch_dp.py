#!/usr/bin/env python3
"""Data-parallel training with the PyTorch/CUDA port, one process a rank.

    torchrun --nproc-per-node N examples/train_torch_dp.py [--cpu]

Each process joins the ``torch.distributed`` world that torchrun
describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``): NCCL with one card a rank, or gloo with ``--cpu``.
It trains GPT-2 (2 layers at hidden 64 with ``--cpu``, else
GPT-2-medium) under ZeRO-``--stage`` on ``make_mesh({"data": -1})``,
from a seeded dataset through the engine's dataloader, which hands each
rank its slice of every global batch; rank 0 prints the losses (the
mean over every rank's samples).
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import deepspeed_tpu_torch as tds  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import (  # noqa: E402
    GPT2Config, GPT2LMHead, random_params)
from deepspeed_tpu_torch.parallel import DATA_AXIS, make_mesh  # noqa: E402
from deepspeed_tpu_torch.utils.distributed import (  # noqa: E402
    init_distributed)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="gloo on the CPU and a 2-layer GPT-2")
    parser.add_argument("--stage", type=int, default=2)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--micro-batch", type=int, default=2)
    parser.add_argument("--seq", type=int, default=64)
    args = parser.parse_args()
    device = "cpu" if args.cpu else None
    init_distributed(device=device)
    mesh = make_mesh({DATA_AXIS: -1})
    cfg = (GPT2Config(vocab_size=256, hidden_size=64, num_layers=2,
                      num_heads=4, max_position_embeddings=args.seq)
           if args.cpu else GPT2Config.gpt2_medium())
    world = mesh.size(DATA_AXIS)
    rows = np.random.default_rng(0).integers(
        0, cfg.vocab_size,
        size=(args.steps * args.micro_batch * world, args.seq))
    engine, *_ = tds.initialize(
        model=GPT2LMHead(cfg), model_parameters=random_params(cfg, 0),
        config={"train_micro_batch_size_per_gpu": args.micro_batch,
                "gradient_accumulation_steps": 1, "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
                "zero_optimization": {"stage": args.stage},
                "bf16": {"enabled": not args.cpu}},
        training_data=[{"input_ids": row} for row in rows],
        mesh=mesh, device=device)
    losses = [float(engine.train_batch()) for _ in range(args.steps)]
    if engine.dp_rank == 0:
        print(f"dp={world} ZeRO-{args.stage} on {engine.device}: losses "
              f"{losses}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
