"""Port of ``deepspeed_tpu/module_inject`` (the GPT-2 policy)."""

from .replace_module import (cast_weights, ingest_gpt2_model,
                             inject_gpt2_layer,
                             replace_gpt2_transformer_layer,
                             revert_gpt2_layer)

__all__ = ["cast_weights", "ingest_gpt2_model", "inject_gpt2_layer",
           "replace_gpt2_transformer_layer", "revert_gpt2_layer"]
