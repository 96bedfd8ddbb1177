"""Attention dispatch: the Hopper flash kernels on CUDA, dense PyTorch
elsewhere (port of ``deepspeed_tpu/ops/transformer/attention.py``).

``dot_product_attention`` takes :class:`FlashAttention` (B1 forward,
B3 or B2a+B2b backward) when no additive ``mask`` is given and either
the tensors are on CUDA with at least ``FLASH_MIN_ROWS`` (two) query
rows — every prefill bucket and every training step — or attention
dropout is on (:func:`takes_flash`).  With
dropout the seed is two int32 words drawn on the tensors' device from
the caller's generator, and the kernels drop inside (the JAX TPU path,
``attention.py:106-120``).  On the CPU the same autograd function runs
the plain versions with the same Philox keep mask, so a CPU run and a
card run given one seed drop the same entries (the JAX CPU path drops
probs with ``random_keep`` bytes instead; with an additive ``mask`` this
module does that too).  Otherwise — CPU without dropout, as the JAX
package on CPU, and decode's single query row, as on the TPU —
:func:`reference_attention` computes it densely.  The JAX package's v5e
dispatch thresholds are not carried over.
"""

import math

import torch

from ..op_common import random_keep
from .flash_attention import FlashAttention

# rates below the byte-mask quantum pass through (layers.dropout)
MIN_DROPOUT = 1.0 / 512.0
# CUDA query rows from which a call without dropout takes B1 in place of
# reference_attention: more than one.  On the H100 B1 is faster than
# reference_attention at every prefill bucket, 128 to 1024 rows
# (`chip_smoke.py`'s bucket rows, PERF.md §6); decode's single row stays
# dense.
FLASH_MIN_ROWS = 2


def key_padding_to_additive(key_padding_mask):
    """[b, s] 1/0 key-padding mask -> additive [b, s] bias (0 / -1e9)."""
    return (1.0 - key_padding_mask.float()) * -1e9


def dropout_active(rate, generator, deterministic):
    return (not deterministic and rate >= MIN_DROPOUT
            and generator is not None)


def reference_attention(q, k, v, mask=None, causal=False, dropout_rate=0.0,
                        dropout_rng=None, deterministic=True):
    """Dense attention on [b, s, h, d] inputs, fp32 softmax; dropout on the
    probabilities from ``random_keep`` bytes of the ``dropout_rng``
    generator."""
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
    if dropout_active(dropout_rate, dropout_rng, deterministic):
        keep, inv_keep = random_keep(dropout_rng, probs.shape, dropout_rate,
                                     probs.device)
        probs = torch.where(keep, probs * inv_keep, 0.0).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def takes_flash(device_type, rows, additive_mask, dropout):
    """Whether :func:`dot_product_attention` runs :class:`FlashAttention`
    for ``rows`` query rows on ``device_type``: never under an additive
    ``mask``; always under dropout (the kernels drop inside, the plain
    versions with the same mask); else on CUDA from ``FLASH_MIN_ROWS``
    rows."""
    if additive_mask:
        return False
    return dropout or (device_type == "cuda" and rows >= FLASH_MIN_ROWS)


def dropout_seed(generator, device):
    """Two int32 seed words for the in-kernel dropout, drawn on
    ``device`` from ``generator`` (no host round trip)."""
    return torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=generator, device=device)


def dot_product_attention(q, k, v, mask=None, key_padding_mask=None,
                          causal=False, dropout_rate=0.0, dropout_rng=None,
                          deterministic=True, head_offset=0,
                          total_heads=None):
    """Multi-head attention on [batch, seq, heads, head_dim] tensors.

    ``mask`` is an additive bias broadcastable to [b, h, q, k];
    ``key_padding_mask`` is [b, kv_len] with 1 at visible keys, the form
    the flash kernels fuse.  Pass one or the other, not both.
    ``dropout_rng`` is a ``torch.Generator`` on the tensors' device; the
    probabilities are dropped at ``dropout_rate`` when it is given and
    ``deterministic`` is false.  ``head_offset`` and ``total_heads``
    place the heads in a whole call's (a tensor-parallel rank's range):
    the flash path then drops the whole call's entries of those heads
    (the additive-``mask`` path draws its bytes per call, at the local
    shape)."""
    if mask is not None and key_padding_mask is not None:
        raise ValueError(
            "pass either an additive mask or a key_padding_mask, not both")
    drop = dropout_active(dropout_rate, dropout_rng, deterministic)
    if takes_flash(q.device.type, q.shape[1], mask is not None, drop):
        seed = dropout_seed(dropout_rng, q.device) if drop else None
        return FlashAttention.apply(q, k, v, key_padding_mask, seed, causal,
                                    float(dropout_rate) if drop else 0.0,
                                    head_offset, total_heads)
    if key_padding_mask is not None:
        mask = key_padding_to_additive(key_padding_mask)[:, None, None, :]
    return reference_attention(q, k, v, mask=mask, causal=causal,
                               dropout_rate=dropout_rate,
                               dropout_rng=dropout_rng,
                               deterministic=deterministic)
