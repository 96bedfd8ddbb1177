"""Port of ``deepspeed_tpu/ops``: the Hopper kernels and their wrappers."""
