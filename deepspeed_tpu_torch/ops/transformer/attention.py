"""Attention dispatch: the Hopper flash kernel on CUDA, dense PyTorch
elsewhere (port of ``deepspeed_tpu/ops/transformer/attention.py``).

``dot_product_attention`` takes the flash kernel when the tensors are on
CUDA, no additive ``mask`` is given and there is more than one query row
— every prefill bucket.  CPU tensors (as the JAX package does on CPU) and
decode's single query row (as it does on the TPU) take
:func:`reference_attention`.  The JAX package's v5e dispatch thresholds
are not carried over; an H100 threshold comes from H100 measurement.
"""

import math

import torch

from .flash_attention import flash_attention_fwd


def key_padding_to_additive(key_padding_mask):
    """[b, s] 1/0 key-padding mask -> additive [b, s] bias (0 / -1e9)."""
    return (1.0 - key_padding_mask.float()) * -1e9


def reference_attention(q, k, v, mask=None, causal=False):
    """Dense attention on [b, s, h, d] inputs, fp32 softmax (no dropout)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        causal_mask = torch.ones((s, k.shape[1]), dtype=torch.bool,
                                 device=q.device).tril()
        scores = torch.where(causal_mask[None, None], scores, -1e9)
    if mask is not None:
        scores = scores + mask.float()
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q, k, v, mask=None, key_padding_mask=None,
                          causal=False, dropout_rate=0.0):
    """Multi-head attention on [batch, seq, heads, head_dim] tensors.

    ``mask`` is an additive bias broadcastable to [b, h, q, k];
    ``key_padding_mask`` is [b, kv_len] with 1 at visible keys, the form
    the flash kernel fuses.  Pass one or the other, not both.  Attention
    dropout is not ported yet, so ``dropout_rate > 0`` raises."""
    if mask is not None and key_padding_mask is not None:
        raise ValueError(
            "pass either an additive mask or a key_padding_mask, not both")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet; it comes with the "
            "training slice")
    if q.is_cuda and mask is None and q.shape[1] > 1:
        out, _ = flash_attention_fwd(q, k, v, kv_mask=key_padding_mask,
                                     causal=causal)
        return out
    if key_padding_mask is not None:
        mask = key_padding_to_additive(key_padding_mask)[:, None, None, :]
    return reference_attention(q, k, v, mask=mask, causal=causal)
