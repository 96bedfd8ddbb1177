"""Transformer building blocks (port of ``deepspeed_tpu/models/layers.py``).

Weights are plain dicts of tensors with the JAX package's keys and its
``[in, out]`` kernel layout, so ``dense`` is ``x @ kernel + bias`` with no
transpose.  Dtypes follow the JAX package: ``dense`` casts the kernel to
``x.dtype``; ``layer_norm`` and ``gelu`` compute in fp32 and cast back.

Randomness: where the JAX package splits ``jax.random`` keys, the port
draws from ``torch.Generator`` objects on the activations' device, made
from integer seeds by :func:`generator`; a layer's three dropout sites
draw from its own generator in a fixed order (attention, attention
output, MLP output).
"""

import logging

import torch

from ..ops.op_common import random_keep
from ..ops.transformer.attention import (MIN_DROPOUT,
                                         dot_product_attention)

logger = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1


def mix_seed(seed, index):
    """A 63-bit seed for stream ``index`` under ``seed`` (splitmix64), so
    sibling streams share no prefix."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(seed, index, device):
    """A ``torch.Generator`` on ``device`` seeded with stream ``index``
    of ``seed``; the JAX package's ``jax.random.split`` in torch form."""
    return torch.Generator(device=device).manual_seed(mix_seed(seed, index))


def dense(params, x):
    return x @ params["kernel"].to(x.dtype) + params["bias"].to(x.dtype)


def layer_norm(params, x, eps=1e-12):
    """LayerNorm with fp32 statistics (bf16-safe)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def gelu(x):
    # tanh approximation, as in the JAX package
    x32 = x.float()
    y = 0.5 * x32 * (1.0 + torch.tanh(
        0.7978845608028654 * (x32 + 0.044715 * x32 ** 3)))
    return y.to(x.dtype)


def dropout(rng, x, rate, deterministic):
    """Inverted dropout with one random byte per element from the
    generator ``rng`` (``random_keep``); identity when deterministic,
    without a generator, or below the 1/512 quantum."""
    if deterministic or rate < MIN_DROPOUT or rng is None:
        return x
    keep, scale = random_keep(rng, x.shape, rate, x.device)
    return torch.where(keep, x * scale, torch.zeros_like(x))


class TransformerLayer:
    """One encoder/decoder layer with the dense attention core.

    The config mirrors the JAX ``TransformerLayer`` (``pre_layer_norm``,
    ``attn_dropout_ratio``, ``hidden_dropout_ratio``, ``causal``).  Not
    ported yet, and refused: the ring and sparse cores (``attn_impl``
    'ring'/'sparse', ROADMAP A10/A11), the memory knobs
    (``gelu_checkpoint``, ``attn_dropout_checkpoint``,
    ``normalize_invertible``, ROADMAP A7) and query-gathered ``positions``
    (BERT's MLM gather, ROADMAP A3)."""

    def __init__(self, hidden_size, heads, intermediate_size=None,
                 causal=False, attn_dropout_ratio=0.1,
                 hidden_dropout_ratio=0.1, pre_layer_norm=False,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 attn_impl="auto", sparsity_config=None,
                 gelu_checkpoint=False, attn_dropout_checkpoint=False,
                 normalize_invertible=False, stochastic_mode=False):
        if hidden_size % heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of heads {heads}")
        if attn_impl in ("ring", "sparse"):
            raise NotImplementedError(
                f"attn_impl={attn_impl!r} is not ported yet (ROADMAP "
                f"{'A10' if attn_impl == 'ring' else 'A11'})")
        if attn_impl != "auto":
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if gelu_checkpoint or attn_dropout_checkpoint or normalize_invertible:
            raise NotImplementedError(
                "gelu_checkpoint, attn_dropout_checkpoint and "
                "normalize_invertible are not ported yet (ROADMAP A7)")
        if stochastic_mode:
            logger.warning("stochastic_mode=True is accepted for config "
                           "parity and has no effect: the port's kernels "
                           "are deterministic")
        # intermediate_size, initializer_range and sparsity_config size
        # and draw params in the JAX layer; here the param dict carries
        # its shapes, so they are accepted for the JAX signature only
        self.hidden_size = hidden_size
        self.heads = heads
        self.head_dim = hidden_size // heads
        self.causal = causal
        self.attn_dropout_ratio = attn_dropout_ratio
        self.hidden_dropout_ratio = hidden_dropout_ratio
        self.pre_layer_norm = pre_layer_norm
        self.layer_norm_eps = layer_norm_eps

    def attention_core(self, params, y, mask=None, key_padding_mask=None,
                       attn_rng=None, deterministic=True):
        """Fused-QKV attention -> [b, s, h] context.  q, k and v are
        strided views of the one [b, s, 3, heads, head_dim] projection,
        which the flash kernels read as they are."""
        b, s, h = y.shape
        qkv = dense(params["qkv"], y).reshape(b, s, 3, self.heads,
                                              self.head_dim)
        ctx = dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask=mask,
            key_padding_mask=key_padding_mask, causal=self.causal,
            dropout_rate=self.attn_dropout_ratio, dropout_rng=attn_rng,
            deterministic=deterministic)
        return ctx.reshape(b, s, h)

    def apply(self, params, x, mask=None, key_padding_mask=None, rng=None,
              deterministic=True, positions=None):
        """x: [batch, seq, hidden]; ``mask`` additive [batch, 1, 1, seq]
        or ``key_padding_mask`` [batch, seq] with 1 at visible tokens (the
        flash kernels' fused form); ``rng`` a ``torch.Generator`` on
        x's device, drawn by the attention, attention-output and MLP
        dropouts in that order."""
        if positions is not None:
            raise NotImplementedError(
                "query-gathered positions (the MLM gather) are not ported "
                "yet (ROADMAP A3)")
        if mask is not None and key_padding_mask is not None:
            raise ValueError(
                "pass either an additive mask or a key_padding_mask, not both")
        rate = self.hidden_dropout_ratio

        def attention_block(y):
            ctx = self.attention_core(params, y, mask=mask,
                                      key_padding_mask=key_padding_mask,
                                      attn_rng=rng,
                                      deterministic=deterministic)
            return dropout(rng, dense(params["attn_out"], ctx), rate,
                           deterministic)

        def mlp_block(y):
            z = dense(params["fc2"], gelu(dense(params["fc1"], y)))
            return dropout(rng, z, rate, deterministic)

        def ln(p, y):
            return layer_norm(p, y, self.layer_norm_eps)

        if self.pre_layer_norm:
            x = x + attention_block(ln(params["ln_attn"], x))
            return x + mlp_block(ln(params["ln_mlp"], x))
        x = ln(params["ln_attn"], x + attention_block(x))
        return ln(params["ln_mlp"], x + mlp_block(x))


def cross_entropy_with_logits(logits, labels, ignore_index=-100):
    """Mean token cross entropy with masking; fp32 logsumexp.
    ``labels == ignore_index`` positions contribute nothing."""
    logits = logits.float()
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, 0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe_labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / mask.sum().clamp_min(1)
