"""Transformer building blocks (port of ``deepspeed_tpu/models/layers.py``).

Weights are plain dicts of tensors with the JAX package's keys and its
``[in, out]`` kernel layout, so ``dense`` is ``x @ kernel + bias`` with no
transpose.  Dtypes follow the JAX package: ``dense`` casts the kernel to
``x.dtype``; ``layer_norm`` and ``gelu`` compute in fp32 and cast back.

Randomness: where the JAX package splits ``jax.random`` keys, the port
draws from ``torch.Generator`` objects on the activations' device, made
from integer seeds by :func:`generator`; a layer's three dropout sites
draw from its own generator in a fixed order (attention, attention
output, MLP output).  A sub-block recomputed in backward (the layer's
memory knobs) replays its generator from the state its forward started
from (:func:`recomputed`), so the recompute draws the forward's masks.
"""

import functools
import logging
import os

import torch
from torch.utils.checkpoint import checkpoint

from ..comm import data_parallel_mean_count
from ..ops.op_common import random_keep
from ..ops.sparse_attention.block_sparse import block_sparse_attention
from ..ops.sparse_attention.flash_block_sparse import (
    FP16_ITEM, flash_block_sparse_attention, kernel_takes)
from ..ops.transformer.attention import (MIN_DROPOUT,
                                         dot_product_attention,
                                         key_padding_to_additive)

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


def recomputed(block, rng=None):
    """``block`` recomputed in backward (``torch.utils.checkpoint``,
    non-reentrant) instead of keeping its activations.  Its draws from the
    generator ``rng`` are replayed: each call notes the generator's state
    before the forward runs the block, and the recompute starts from that
    state, so it draws the same dropout masks and B4 seed words
    (``torch.utils.checkpoint`` restores only the global RNG states)."""
    def call(*args):
        state = None if rng is None else rng.get_state()

        def replay(*a):
            if state is not None:
                rng.set_state(state)
            return block(*a)

        return checkpoint(replay, *args, use_reentrant=False)

    return call


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


def sparse_core(q, has_key_padding):
    """Which sparse attention core takes a call, "kernel" or "gather":
    the JAX layer's own dispatch in the port's terms.  The gather path,
    which is the general one, takes a call with a key-padding mask (the
    flash kernels have no mask operand) and a call on the CPU.  Every
    other call is the block-sparse flash kernels': it launches them or
    raises, here for a type or head_dim they do not take.
    ``flash_block_sparse_attention`` then resolves the aggregation factor
    G as the JAX package does and launches B5a/B5b (G = 1, layout blocks
    above 128 rows) or the super-tile kernels B6a/B6b/B6c (G > 1).
    ``DS_SPARSE_FLASH=never`` (read at call time) sends such a call to
    the gather path instead, and says so once.  The JAX test
    ``blk % 128 == 0`` is a TPU tile rule and is not carried over: on the
    card the port runs B6 at 16- and 64-row blocks too, where the JAX
    layer takes the gather path; the function is the same."""
    if has_key_padding or not q.is_cuda:
        return "gather"
    if os.environ.get("DS_SPARSE_FLASH", "auto") == "never":
        _log_gather_once()
        return "gather"
    if not kernel_takes(q):
        raise NotImplementedError(
            f"the block-sparse flash kernels take fp32 or bf16 at head_dim "
            f"64 or 128, not {q.dtype} at head_dim {q.shape[-1]} (fp16 "
            f"B5/B6 is {FP16_ITEM}); DS_SPARSE_FLASH=never takes the gather "
            f"path instead")
    return "kernel"


@functools.lru_cache(maxsize=None)
def _log_gather_once():
    logger.warning("DS_SPARSE_FLASH=never: sparse attention on the card "
                   "takes the gather path, not the block-sparse flash "
                   "kernels")


class TransformerLayer:
    """One encoder/decoder layer with the dense (``attn_impl="auto"``)
    or the block-sparse (``"sparse"``, with a ``sparsity_config``)
    attention core.

    The config mirrors the JAX ``TransformerLayer`` (``pre_layer_norm``,
    ``attn_dropout_ratio``, ``hidden_dropout_ratio``, ``causal``) and its
    memory knobs, each of which recomputes a sub-block in backward instead
    of keeping its activations (the JAX layer's ``jax.checkpoint``
    regions, ``layers.py:291-305``): ``attn_dropout_checkpoint`` the
    attention block (QKV, B1, attention output and its dropout),
    ``gelu_checkpoint`` the MLP block, ``normalize_invertible`` each
    layernorm.  Not ported yet, and refused: the ring core (``attn_impl``
    'ring', ROADMAP A10).  ``apply(..., positions=...)`` computes the
    layer at a few gathered rows only (BERT's last layer under the MLM
    gather)."""

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
        if attn_impl == "ring":
            raise NotImplementedError(
                "attn_impl='ring' is not ported yet (ROADMAP A10)")
        if attn_impl not in ("auto", "sparse"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if attn_impl == "sparse" and sparsity_config is None:
            raise ValueError("attn_impl='sparse' requires a SparsityConfig")
        if stochastic_mode:
            logger.warning("stochastic_mode=True is accepted for config "
                           "parity and has no effect: the port's kernels "
                           "are deterministic")
        # intermediate_size and initializer_range size and draw params
        # in the JAX layer; here the param dict carries its shapes, so
        # they are accepted for the JAX signature only
        self.hidden_size = hidden_size
        self.heads = heads
        self.head_dim = hidden_size // heads
        self.causal = causal
        self.attn_dropout_ratio = attn_dropout_ratio
        self.hidden_dropout_ratio = hidden_dropout_ratio
        self.pre_layer_norm = pre_layer_norm
        self.layer_norm_eps = layer_norm_eps
        self.gelu_checkpoint = gelu_checkpoint
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.normalize_invertible = normalize_invertible
        self.attn_impl = attn_impl
        self.sparsity_config = sparsity_config
        self._layout_cache = {}  # seq_len -> layout

    def _sparse_layout(self, seq_len):
        """Layout cached per sequence length: randomized configs (BigBird,
        Variable) must give the same pattern in every call, and the
        kernels' device tables are cached on the array's identity."""
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = \
                self.sparsity_config.make_layout(seq_len)
        return self._layout_cache[seq_len]

    def _sparse_attention(self, q, k, v, mask, key_padding_mask, attn_rng,
                          deterministic):
        """The sparse core on [b, s, heads, head_dim] views, and the
        attention dropout on its context: the sparse cores have none
        inside."""
        b, s = q.shape[:2]
        kpm_add = None  # additive [b, s] form
        if key_padding_mask is not None:
            kpm_add = key_padding_to_additive(key_padding_mask)
        elif mask is not None:
            # the general additive [b, 1, 1, s] broadcast collapses
            if mask.numel() != b * s:
                raise ValueError(
                    f"attn_impl='sparse' supports key-padding masks "
                    f"([b,1,1,s]), got mask shape {tuple(mask.shape)}")
            kpm_add = mask.reshape(b, s)
        layout = self._sparse_layout(s)
        causal_sp = self.causal or getattr(
            self.sparsity_config, "attention",
            "bidirectional") == "unidirectional"
        if sparse_core(q, kpm_add is not None) == "kernel":
            ctx = flash_block_sparse_attention(q, k, v, layout,
                                               causal=causal_sp)
        else:
            ctx = block_sparse_attention(q, k, v, layout, causal=causal_sp,
                                         key_padding_mask=kpm_add)
        if attn_rng is not None and self.attn_dropout_ratio > 0.0:
            ctx = dropout(attn_rng, ctx, self.attn_dropout_ratio,
                          deterministic)
        return ctx

    def attention_core(self, params, y, mask=None, key_padding_mask=None,
                       attn_rng=None, deterministic=True, positions=None):
        """Fused-QKV attention -> [b, s, h] context.  q, k and v are
        strided views of the one [b, s, 3, heads, head_dim] projection,
        which the flash kernels read as they are.

        ``positions`` [b, K] (int64): queries, and so output rows, only at
        those positions, with keys and values over the whole sequence;
        the dense bidirectional core only.  Returns [b, K, h]."""
        b, s, h = y.shape
        if positions is not None:
            if self.attn_impl != "auto" or self.causal:
                raise ValueError("query-gathered attention supports the "
                                 "dense bidirectional core only")
            n = positions.shape[1]
            w = params["qkv"]["kernel"].to(y.dtype)
            bias = params["qkv"]["bias"].to(y.dtype)
            y_sel = torch.take_along_dim(y, positions[..., None], dim=1)
            q = (y_sel @ w[:, :h] + bias[:h]).reshape(b, n, self.heads,
                                                      self.head_dim)
            kv = (y @ w[:, h:] + bias[h:]).reshape(b, s, 2, self.heads,
                                                   self.head_dim)
            ctx = dot_product_attention(
                q, kv[:, :, 0], kv[:, :, 1], mask=mask,
                key_padding_mask=key_padding_mask, causal=False,
                dropout_rate=self.attn_dropout_ratio, dropout_rng=attn_rng,
                deterministic=deterministic)
            return ctx.reshape(b, n, h)
        qkv = dense(params["qkv"], y).reshape(b, s, 3, self.heads,
                                              self.head_dim)
        if self.attn_impl == "sparse":
            return self._sparse_attention(
                qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask,
                key_padding_mask, attn_rng, deterministic).reshape(b, s, h)
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
        dropouts in that order.  ``positions`` [b, K]: outputs only at
        those rows (queries gathered, keys and values over the whole
        sequence, the residuals, MLP and layernorms on the K rows), for a
        last layer whose head reads few positions; returns [b, K,
        hidden]."""
        if mask is not None and key_padding_mask is not None:
            raise ValueError(
                "pass either an additive mask or a key_padding_mask, not both")
        rate = self.hidden_dropout_ratio

        def attention_block(y):
            ctx = self.attention_core(params, y, mask=mask,
                                      key_padding_mask=key_padding_mask,
                                      attn_rng=rng,
                                      deterministic=deterministic,
                                      positions=positions)
            return dropout(rng, dense(params["attn_out"], ctx), rate,
                           deterministic)

        def mlp_block(y):
            z = dense(params["fc2"], gelu(dense(params["fc1"], y)))
            return dropout(rng, z, rate, deterministic)

        def ln(p, y):
            return layer_norm(p, y, self.layer_norm_eps)

        if self.attn_dropout_checkpoint:
            attention_block = recomputed(attention_block, rng)
        if self.gelu_checkpoint:
            mlp_block = recomputed(mlp_block, rng)
        if self.normalize_invertible:
            ln = recomputed(ln)

        def sel(t):   # the residual's rows where the queries are
            if positions is None:
                return t
            return torch.take_along_dim(t, positions[..., None], dim=1)

        if self.pre_layer_norm:
            x = sel(x) + attention_block(ln(params["ln_attn"], x))
            return x + mlp_block(ln(params["ln_mlp"], x))
        x = ln(params["ln_attn"], sel(x) + attention_block(x))
        return ln(params["ln_mlp"], x + mlp_block(x))


def cross_entropy_with_logits(logits, labels, ignore_index=-100):
    """Mean token cross entropy with masking; fp32 logsumexp.
    ``labels == ignore_index`` positions contribute nothing.  Under an
    engine's data-parallel mesh the count is the global batch's
    (:func:`~deepspeed_tpu_torch.comm.data_parallel_mean_count`), so the
    ranks' losses average to the global batch's mean, as in the JAX
    engine, where ranks count different labels."""
    logits = logits.float()
    mask = labels != ignore_index
    safe_labels = torch.where(mask, labels, 0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe_labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / data_parallel_mean_count(mask.sum())
