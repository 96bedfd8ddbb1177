"""BertSparseSelfAttention: BERT's self-attention with a sparse core.

Port of ``deepspeed_tpu/ops/sparse_attention/bert_sparse_self_attention.py``
in the same functional style (``init``/``apply`` over a dict of weights
with the JAX keys ``query``/``key``/``value`` and ``[in, out]`` kernels):
Q/K/V projections and a :class:`SparseSelfAttention` core, returning the
merged-head context.
"""

import numpy as np
import torch

from .sparse_self_attention import SparseSelfAttention
from .sparsity_config import FixedSparsityConfig


class BertSparseSelfAttention:
    def __init__(self, config, sparsity_config=None):
        """``config`` needs ``hidden_size`` and ``num_attention_heads``."""
        if config.hidden_size % config.num_attention_heads != 0:
            raise ValueError(
                f"The hidden size ({config.hidden_size}) is not a multiple of "
                f"the number of attention heads ({config.num_attention_heads})")
        self.config = config
        self.num_attention_heads = config.num_attention_heads
        self.attention_head_size = config.hidden_size // config.num_attention_heads
        self.all_head_size = self.num_attention_heads * self.attention_head_size
        # 'mul' mode: apply()'s attention_mask contract is 1-keep/0-drop
        self.sparse_self_attention = SparseSelfAttention(
            sparsity_config or FixedSparsityConfig(
                num_heads=config.num_attention_heads),
            key_padding_mask_mode="mul")

    def init(self, seed, device="cpu"):
        """Weights drawn with numpy from the integer ``seed`` (normal,
        ``initializer_range``), so a test can hand the same arrays to the
        JAX module."""
        h = self.config.hidden_size
        rng = np.random.default_rng(seed)
        init_range = getattr(self.config, "initializer_range", 0.02)

        def dense():
            kernel = rng.standard_normal((h, self.all_head_size)) * init_range
            return {"kernel": torch.tensor(kernel, dtype=torch.float32,
                                           device=device),
                    "bias": torch.zeros(self.all_head_size, device=device)}

        return {"query": dense(), "key": dense(), "value": dense()}

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_attention_heads,
                         self.attention_head_size).transpose(1, 2)

    def apply(self, params, hidden_states, attention_mask=None):
        """hidden_states ``[b, s, hidden]``; attention_mask ``[b, s]``
        multiplicative key-padding mask (1 keep / 0 drop)."""

        def proj(p, x):
            return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)

        q = self._split_heads(proj(params["query"], hidden_states))
        k = self._split_heads(proj(params["key"], hidden_states))
        v = self._split_heads(proj(params["value"], hidden_states))
        ctx = self.sparse_self_attention(
            q, k, v, key_padding_mask=attention_mask)
        b, h, s, d = ctx.shape
        return ctx.transpose(1, 2).reshape(b, s, self.all_head_size)
