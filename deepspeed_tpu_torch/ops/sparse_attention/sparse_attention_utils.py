"""Helpers for adopting sparse attention in existing models.

Port of ``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``:
padding and unpadding of the sequence to block multiples and the
extension of a position-embedding table are tensor ops; the module
surgery (``replace_model_self_attention_with_sparse_self_attention``) is
refused as in the JAX package, whose functional models swap attention
cores through ``module_inject`` instead.
"""

import torch
import torch.nn.functional as F


class SparseAttentionUtils:
    @staticmethod
    def extend_position_embedding(position_embedding, max_position):
        """Tile an existing ``[orig_max, hidden]`` position-embedding
        table up to ``max_position``; returns the new table."""
        orig_max, hidden = position_embedding.shape
        if max_position <= orig_max:
            return position_embedding[:max_position]
        reps = -(-max_position // orig_max)
        return torch.as_tensor(position_embedding).repeat(reps, 1)[
            :max_position]

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position):
        """Bump a tokenizer's max length."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def pad_to_block_size(block_size, input_ids=None, attention_mask=None,
                          token_type_ids=None, position_ids=None,
                          inputs_embeds=None, pad_token_id=0,
                          model_embeddings=None):
        """Pad the sequence dimension to a multiple of ``block_size``.
        Returns ``(pad_len, input_ids, attention_mask, token_type_ids,
        position_ids, inputs_embeds)``; padded attention-mask positions
        are 0 (masked out)."""
        if input_ids is not None:
            seq_len = input_ids.shape[1]
        else:
            seq_len = inputs_embeds.shape[1]
        pad_len = (block_size - seq_len % block_size) % block_size
        if pad_len == 0:
            return (pad_len, input_ids, attention_mask, token_type_ids,
                    position_ids, inputs_embeds)

        def pad2d(x, value):
            if x is None:
                return None
            return F.pad(torch.as_tensor(x), (0, pad_len), value=value)

        if inputs_embeds is not None:
            inputs_embeds = torch.as_tensor(inputs_embeds)
            batch = inputs_embeds.shape[0]
            pad_ids = torch.full((batch, pad_len), pad_token_id,
                                 dtype=torch.int32,
                                 device=inputs_embeds.device)
            assert model_embeddings is not None, (
                "padding inputs_embeds requires model_embeddings")
            pad_embeds = model_embeddings(pad_ids)
            inputs_embeds = torch.cat([inputs_embeds, pad_embeds], dim=1)
        input_ids = pad2d(input_ids, pad_token_id)
        position_ids = pad2d(position_ids, pad_token_id)
        attention_mask = pad2d(attention_mask, 0)
        token_type_ids = pad2d(token_type_ids, 0)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len, sequence_output):
        """Drop padding added by :meth:`pad_to_block_size`."""
        if pad_len > 0:
            return sequence_output[:, :-pad_len]
        return sequence_output

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
            model, max_position, sparsity_config=None):
        """Module surgery is not part of the functional models; use
        ``deepspeed_tpu_torch.module_inject`` policies."""
        raise NotImplementedError(
            "use deepspeed_tpu_torch.module_inject to swap attention cores "
            "in functional models")
