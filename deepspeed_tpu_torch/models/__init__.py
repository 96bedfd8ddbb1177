"""Port of ``deepspeed_tpu/models``: GPT-2 (training loss and forward),
BERT with its pretraining, question-answering and sequence-classification
heads, and the transformer building blocks."""

from .bert import (BertConfig, BertForPreTraining,
                   BertForQuestionAnsweringTPU,
                   BertForSequenceClassificationTPU, BertModel)
from .gpt2 import GPT2Config, GPT2LMHead, random_params
from .layers import dense, gelu, layer_norm

__all__ = ["BertConfig", "BertForPreTraining", "BertForQuestionAnsweringTPU",
           "BertForSequenceClassificationTPU", "BertModel", "GPT2Config",
           "GPT2LMHead", "random_params", "dense", "gelu", "layer_norm"]
