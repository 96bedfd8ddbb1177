"""Elastic-config inspector CLI (port of ``deepspeed_tpu/elasticity/cli.py``,
the reference's ``bin/ds_elastic``): show the final batch size, valid
card counts, and micro-batch plan an elastic config resolves to::

    python -m deepspeed_tpu_torch.elasticity.cli -c ds_config.json [-w N]
"""
import argparse
import json

from deepspeed_tpu_torch.elasticity import compute_elastic_config


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="DeepSpeed-TPU PyTorch port elasticity")
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="DeepSpeed config json with an elasticity block")
    parser.add_argument("-w", "--world-size", type=int, default=0,
                        help="resolve for this card count")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        ds_config = json.load(f)
    res = compute_elastic_config(ds_config, target_deepspeed_version="0.3.11",
                                 world_size=args.world_size)
    if args.world_size:
        final_batch, valid_gpus, micro_batch = res
        print(f"final global batch:   {final_batch}")
        print(f"valid card counts:    {valid_gpus}")
        print(f"micro batch @ w={args.world_size}: {micro_batch}")
    else:
        final_batch, valid_gpus = res
        print(f"final global batch:   {final_batch}")
        print(f"valid card counts:    {valid_gpus}")


if __name__ == "__main__":
    main()
