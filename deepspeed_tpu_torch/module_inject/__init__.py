"""Port of ``deepspeed_tpu/module_inject`` (the BERT and GPT-2
policies)."""

from .replace_module import (cast_weights, ingest_gpt2_model,
                             inject_bert_layer, inject_gpt2_layer,
                             replace_gpt2_transformer_layer, replace_module,
                             replace_transformer_layer, revert_bert_layer,
                             revert_gpt2_layer)

__all__ = ["cast_weights", "ingest_gpt2_model", "inject_bert_layer",
           "inject_gpt2_layer", "replace_gpt2_transformer_layer",
           "replace_module", "replace_transformer_layer",
           "revert_bert_layer", "revert_gpt2_layer"]
