"""Port of ``deepspeed_tpu/runtime`` (the parts serving reads)."""
