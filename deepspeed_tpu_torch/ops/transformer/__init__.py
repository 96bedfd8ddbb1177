"""Port of ``deepspeed_tpu/ops/transformer``: attention."""

from .attention import (dot_product_attention, key_padding_to_additive,
                        reference_attention)
from .flash_attention import (MAX_FLOOR, NEG_INF, flash_attention_fwd,
                              flash_attention_reference)

__all__ = ["dot_product_attention", "key_padding_to_additive",
           "reference_attention", "MAX_FLOOR", "NEG_INF",
           "flash_attention_fwd", "flash_attention_reference"]
