"""SparseSelfAttention: layout-driven sparse softmax(QKᵀ)V module.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``.
Same contract: inputs ``[batch, heads, seq, head_dim]``, optional additive
or multiplicative key-padding and attention masks, a relative position
bias; output a dense context tensor.  The core is the gather path of
``block_sparse.py``; layouts are sliced per sequence length from one
master layout built at ``max_seq_length`` and cached.
"""

import torch

from .block_sparse import NEG_INF, block_sparse_attention
from .sparsity_config import FixedSparsityConfig, SparsityConfig


class SparseSelfAttention:
    def __init__(self, sparsity_config=None, key_padding_mask_mode="add",
                 attn_mask_mode="mul", max_seq_length=2048):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        assert isinstance(self.sparsity_config, SparsityConfig)
        if key_padding_mask_mode not in ("add", "mul"):
            raise ValueError(f"bad key_padding_mask_mode {key_padding_mask_mode}")
        if attn_mask_mode not in ("add", "mul"):
            raise ValueError(f"bad attn_mask_mode {attn_mask_mode}")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self._master_layout = None
        self._layout_cache = {}

    def get_layout(self, seq_len):
        """Layout for ``seq_len``, sliced from a lazily built master
        layout."""
        if seq_len in self._layout_cache:
            return self._layout_cache[seq_len]
        if self._master_layout is None:
            self._master_layout = self.sparsity_config.make_layout(
                self.max_seq_length)
        if seq_len % self.sparsity_config.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be a multiple of block "
                f"{self.sparsity_config.block}")
        num_blocks = seq_len // self.sparsity_config.block
        if num_blocks > self._master_layout.shape[1]:
            raise ValueError(
                f"seq_len {seq_len} exceeds max_seq_length {self.max_seq_length}")
        layout = self._master_layout[:, :num_blocks, :num_blocks]
        self._layout_cache[seq_len] = layout
        return layout

    def _additive(self, mask, mode, device):
        """'mul' masks (1 keep / 0 drop) -> additive finite NEG_INF form."""
        mask = torch.as_tensor(mask, device=device)
        if mode == "mul":
            return torch.where(mask != 0, 0.0, NEG_INF)
        return mask.float()

    def __call__(self, query, key, value, rpe=None, key_padding_mask=None,
                 attn_mask=None):
        """query/key/value: ``[batch, heads, seq, head_dim]``."""
        if query.shape != key.shape or key.shape != value.shape:
            raise NotImplementedError("only self-attention is supported for now")
        b, h, s, d = query.shape
        layout = self.get_layout(s)

        if key_padding_mask is not None:
            key_padding_mask = self._additive(
                torch.as_tensor(key_padding_mask).reshape(b, s),
                self.key_padding_mask_mode, query.device)
        if attn_mask is not None:
            attn_mask = torch.as_tensor(attn_mask)
            attn_mask = self._additive(
                attn_mask.reshape(attn_mask.shape[-2:]), self.attn_mask_mode,
                query.device)

        causal = getattr(self.sparsity_config, "attention",
                         "bidirectional") == "unidirectional"
        # block_sparse_attention takes [b, s, h, d]
        ctx = block_sparse_attention(
            query.transpose(1, 2), key.transpose(1, 2),
            value.transpose(1, 2), layout, causal=causal,
            key_padding_mask=key_padding_mask, attn_mask=attn_mask, rpe=rpe)
        return ctx.transpose(1, 2)

    forward = __call__
