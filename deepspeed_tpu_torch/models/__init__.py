"""Port of ``deepspeed_tpu/models`` (the GPT-2 eval forward)."""

from .gpt2 import GPT2Config, GPT2LMHead, random_params
from .layers import dense, gelu, layer_norm

__all__ = ["GPT2Config", "GPT2LMHead", "random_params", "dense", "gelu",
           "layer_norm"]
