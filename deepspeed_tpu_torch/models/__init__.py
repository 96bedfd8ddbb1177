"""Port of ``deepspeed_tpu/models``: GPT-2 (training loss and forward)
and the transformer building blocks."""

from .gpt2 import GPT2Config, GPT2LMHead, random_params
from .layers import dense, gelu, layer_norm

__all__ = ["GPT2Config", "GPT2LMHead", "random_params", "dense", "gelu",
           "layer_norm"]
