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

Tensor parallelism (Megatron, over the current mesh's ``model`` axis):
a layer whose params are a rank's slices (:func:`~deepspeed_tpu_torch.utils.params.tp_slice`
by :meth:`TransformerLayer.partition_specs`) runs its heads and its
slice of the MLP: QKV and ``fc1`` column-parallel on the replicated
input (:func:`~deepspeed_tpu_torch.comm.copy_to`), ``attn_out`` and
``fc2`` row-parallel, their partial products summed over the ranks
(:func:`~deepspeed_tpu_torch.comm.reduce_from`) before the bias is
added once.  Every rank of a data coordinate draws the same dropout
streams, and the flash kernels drop the entries of the rank's GLOBAL
heads, so a sharded layer drops what the whole layer drops.

Sequence parallelism (the current mesh's ``seq`` axis): a layer takes
this rank's chunk of the sequence; ``attn_impl="ring"`` runs ring
attention over the axis, the dense (``"auto"``) and sparse cores their
gather form (:mod:`~deepspeed_tpu_torch.ops.transformer.gather_attention`:
K/V gathered, the kernels on the chunk's rows at their query-row
offset, the dk/dv partials reduce-scattered), on its heads under
``model``; every other part of the layer is per position and runs on
the chunk as it is.  A model cuts its chunk with :func:`seq_chunk` and
draws its dropout streams from :func:`seq_stream_seed`, so each chunk
drops its own entries; the dense core's in-kernel dropout draws its seed
words from the layer's stream before that mixing (``attn_seed_rng``,
the same on every seq rank), so each chunk draws its rows of one whole
call's keep bits.
"""

import functools
import logging
import os

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..comm import (axis_index, axis_size, copy_to, data_parallel_mean_count,
                    gather_seq, pmax, reduce_from)
from ..parallel.mesh import MODEL_AXIS, SEQ_AXIS
from ..profiling.flops_profiler.profiler import named_scope
from ..utils.params import MODEL, QKV
from ..ops.op_common import random_keep
from ..ops.sparse_attention.block_sparse import block_sparse_attention
from ..ops.sparse_attention.flash_block_sparse import (
    flash_block_sparse_attention, kernel_takes)
from ..ops.transformer.attention import (MIN_DROPOUT, dot_product_attention,
                                         dropout_active, dropout_seed,
                                         key_padding_to_additive)
from ..ops.transformer.gather_attention import (
    gather_attention, gather_block_sparse_attention, seq_rows,
    seq_sparse_factor)
from ..ops.transformer.ring_attention import ring_attention

logger = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1
# the sub-stream under a step's seed from which seq rank r > 0 draws
# its chunk's dropout (rank 0 draws the seed's own streams)
SEQ_STREAM = 0x5E9 << 20


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


def recomputed(block, *rngs):
    """``block`` recomputed in backward (``torch.utils.checkpoint``,
    non-reentrant) instead of keeping its activations.  Its draws from the
    generators ``rngs`` (None entries skipped) are replayed: each call
    notes their states before the forward runs the block, and the
    recompute starts from those states, so it draws the same dropout
    masks and B4 seed words (``torch.utils.checkpoint`` restores only the
    global RNG states)."""
    gens = [g for g in rngs if g is not None]

    def call(*args):
        states = [g.get_state() for g in gens]

        def replay(*a):
            for g, state in zip(gens, states):
                g.set_state(state)
            return block(*a)

        return checkpoint(replay, *args, use_reentrant=False)

    return call


def seq_chunk(x, dim=1):
    """This ``seq`` rank's chunk of ``x`` along ``dim`` (rank r of N:
    positions ``[r·s/N, (r+1)·s/N)``); ``x`` itself at one rank."""
    n = axis_size(SEQ_AXIS)
    if n == 1:
        return x
    s = x.shape[dim]
    if s % n:
        raise ValueError(f"a sequence of {s} positions does not split over "
                         f"{n} seq ranks")
    return x.narrow(dim, axis_index(SEQ_AXIS) * (s // n), s // n)


def seq_offset(s):
    """The global position of this ``seq`` rank's first row of a
    length-``s`` sequence (0 at one rank)."""
    return axis_index(SEQ_AXIS) * (s // axis_size(SEQ_AXIS))


def seq_stream_seed(seed):
    """The seed a ``seq`` rank's chunk draws its dropout from: ``seed``
    at rank 0 (and at one rank), a sub-stream of it above."""
    r = axis_index(SEQ_AXIS)
    return seed if seed is None or r == 0 else mix_seed(seed,
                                                        SEQ_STREAM + r)


def dense(params, x):
    return x @ params["kernel"].to(x.dtype) + params["bias"].to(x.dtype)


def row_dense(params, x, axis=MODEL_AXIS):
    """A row-parallel ``dense``: each rank's partial product of its rows
    of the kernel, summed over ``axis``, then the (replicated) bias added
    once; ``dense`` itself where the axis has one member."""
    if axis_size(axis) == 1:
        return dense(params, x)
    return reduce_from(x @ params["kernel"].to(x.dtype), axis) \
        + params["bias"].to(x.dtype)


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
            f"the block-sparse flash kernels take fp32, bf16 or fp16 at "
            f"head_dim 64 or 128, not {q.dtype} at head_dim {q.shape[-1]}; "
            f"DS_SPARSE_FLASH=never takes the gather path instead")
    return "kernel"


@functools.lru_cache(maxsize=None)
def _log_gather_once():
    logger.warning("DS_SPARSE_FLASH=never: sparse attention on the card "
                   "takes the gather path, not the block-sparse flash "
                   "kernels")


class TransformerLayer:
    """One encoder/decoder layer with the dense (``attn_impl="auto"``),
    the block-sparse (``"sparse"``, with a ``sparsity_config``) or the
    ring (``"ring"``, sequence parallelism over the mesh's ``seq`` axis)
    attention core.

    The config mirrors the JAX ``TransformerLayer`` (``pre_layer_norm``,
    ``attn_dropout_ratio``, ``hidden_dropout_ratio``, ``causal``) and its
    memory knobs, each of which recomputes a sub-block in backward instead
    of keeping its activations (the JAX layer's ``jax.checkpoint``
    regions, ``layers.py:291-305``): ``attn_dropout_checkpoint`` the
    attention block (QKV, B1, attention output and its dropout),
    ``gelu_checkpoint`` the MLP block, ``normalize_invertible`` each
    layernorm.  Under a ``model`` axis the params
    are the rank's slices (:meth:`partition_specs`) and the layer is its
    Megatron shard (see the module docstring): the sparse core runs the
    rank's heads on their rows of a per-head layout, and the sparse and
    ring cores' context dropout cuts the whole layer's mask to them;
    under ``seq`` the input is this rank's chunk of the sequence and
    every core attends over the whole sequence (the ring, or the gather
    form of the dense and sparse cores).  ``apply(..., positions=...)``
    computes the layer at a few gathered rows only (BERT's last layer
    under the MLM gather; the dense core only, so never with the ring, as
    in the JAX layer; under ``seq`` the rows are the chunk's, against the
    gathered keys)."""

    # right on a chunk of the sequence under ``seq`` (a pipeline layer's
    # declaration, runtime/pipe/module.py)
    seq_parallel = True

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
        if attn_impl not in ("auto", "sparse", "ring"):
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        if attn_impl == "sparse" and sparsity_config is None:
            raise ValueError("attn_impl='sparse' requires a SparsityConfig")
        if stochastic_mode:
            logger.warning("stochastic_mode=True is accepted for config "
                           "parity and has no effect: the port's kernels "
                           "are deterministic")
        # intermediate_size and initializer_range size and draw the
        # params of :meth:`init`; apply reads the shapes from the dict
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.initializer_range = initializer_range
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

    def init(self, seed):
        """The layer's params as numpy (JAX ``layers.py:141-153``):
        normal(0, ``initializer_range``) kernels, zero biases, unit
        layernorm scales, from a numpy generator seeded with ``seed``
        (a pipeline stage draws each of its layers so)."""
        rng = np.random.default_rng(seed)
        h, i = self.hidden_size, self.intermediate_size

        def dense_p(n_in, n_out):
            kernel = rng.standard_normal((n_in, n_out), dtype=np.float32)
            return {"kernel": kernel * np.float32(self.initializer_range),
                    "bias": np.zeros((n_out,), np.float32)}

        def ln_p():
            return {"scale": np.ones((h,), np.float32),
                    "bias": np.zeros((h,), np.float32)}

        return {"qkv": dense_p(h, 3 * h), "attn_out": dense_p(h, h),
                "fc1": dense_p(h, i), "fc2": dense_p(i, h),
                "ln_attn": ln_p(), "ln_mlp": ln_p()}

    @staticmethod
    def partition_specs():
        """The port's slicing of the layer's params over ``model``
        (the JAX layer's ``partition_specs``, ``layers.py:156-163``): QKV
        column-parallel by heads inside each of Q, K and V, ``fc1``
        column-parallel, ``attn_out`` and ``fc2`` row-parallel with their
        bias replicated, the layernorms replicated."""
        return {"qkv": {"kernel": (None, QKV), "bias": (QKV,)},
                "attn_out": {"kernel": (MODEL, None), "bias": (None,)},
                "fc1": {"kernel": (None, MODEL), "bias": (MODEL,)},
                "fc2": {"kernel": (MODEL, None), "bias": (None,)},
                "ln_attn": {"scale": (None,), "bias": (None,)},
                "ln_mlp": {"scale": (None,), "bias": (None,)}}

    def local_heads(self, params):
        """``(heads this rank holds, its first head)``: all of them at
        one ``model`` rank, ``heads / m`` at rank r of m from ``r·heads /
        m``."""
        hl = params["qkv"]["kernel"].shape[1] // (3 * self.head_dim)
        if hl == self.heads:
            return hl, 0
        m = axis_size(MODEL_AXIS)
        if hl * m != self.heads:
            raise ValueError(f"the QKV holds {hl} of {self.heads} heads but "
                             f"the model axis has {m} ranks")
        return hl, axis_index(MODEL_AXIS) * hl

    def _sparse_layout(self, seq_len, h0=0, heads=None):
        """Layout cached per sequence length: randomized configs (BigBird,
        Variable) must give the same pattern in every call, and the
        kernels' device tables are cached on the array's identity.  On a
        ``model`` rank that holds heads ``[h0, h0 + heads)`` a per-head
        layout (``different_layout_per_head``) is cut to those heads'
        rows, and the cut is cached too; a shared layout (one row) serves
        every rank as it is."""
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = \
                self.sparsity_config.make_layout(seq_len)
        layout = self._layout_cache[seq_len]
        if heads is None or layout.shape[0] == 1 or heads == layout.shape[0]:
            return layout
        key = (seq_len, h0, heads)
        if key not in self._layout_cache:
            self._layout_cache[key] = np.ascontiguousarray(
                layout[h0:h0 + heads])
        return self._layout_cache[key]

    def _additive_key_padding(self, mask, key_padding_mask, b, s):
        """The additive ``[b, s]`` key-padding form the sparse and ring
        cores take, or None."""
        if key_padding_mask is not None:
            return key_padding_to_additive(key_padding_mask)
        if mask is None:
            return None
        # the general additive [b, 1, 1, s] broadcast collapses
        if mask.numel() != b * s:
            raise ValueError(
                f"attn_impl={self.attn_impl!r} supports key-padding masks "
                f"([b,1,1,s]), got mask shape {tuple(mask.shape)}")
        return mask.reshape(b, s)

    def _context_dropout(self, ctx, attn_rng, deterministic, h0=0):
        """The sparse and ring cores drop nothing inside: the layer drops
        their ``[b, s, heads, head_dim]`` context with its generator, as
        the JAX layer does.  On a ``model`` rank holding heads ``[h0, h0
        + heads)`` the keep mask is drawn for every head and cut to the
        rank's, so each rank drops what the whole layer drops (the ranks
        of a data coordinate share the generator's stream)."""
        if (attn_rng is None or self.attn_dropout_ratio <= 0.0
                or deterministic or self.attn_dropout_ratio < MIN_DROPOUT):
            return ctx
        shape = (*ctx.shape[:2], self.heads, ctx.shape[3])
        keep, scale = random_keep(attn_rng, shape, self.attn_dropout_ratio,
                                  ctx.device)
        keep = keep[:, :, h0:h0 + ctx.shape[2]]
        return torch.where(keep, ctx * scale, torch.zeros_like(ctx))

    def _sparse_attention(self, q, k, v, mask, key_padding_mask, attn_rng,
                          deterministic, h0=0):
        """The sparse core on [b, s, heads, head_dim] views (this rank's
        heads ``[h0, h0 + heads)`` under ``model``, with their rows of a
        per-head layout), and the attention dropout on its context.
        Under ``seq`` the views are this rank's chunk: the layout is the
        whole sequence's and the rank runs its block rows of it against
        the gathered K/V (the flash kernels' gather core, or the gather
        path on K/V gathered with their gradient)."""
        b, s = q.shape[:2]
        kpm_add = self._additive_key_padding(mask, key_padding_mask, b, s)
        n = axis_size(SEQ_AXIS)
        layout = self._sparse_layout(s * n, h0, q.shape[2])
        causal_sp = self.causal or getattr(
            self.sparsity_config, "attention",
            "bidirectional") == "unidirectional"
        kernel = sparse_core(q, kpm_add is not None) == "kernel"
        if n == 1:
            if kernel:
                ctx = flash_block_sparse_attention(q, k, v, layout,
                                                   causal=causal_sp)
            else:
                ctx = block_sparse_attention(q, k, v, layout,
                                             causal=causal_sp,
                                             key_padding_mask=kpm_add)
            return self._context_dropout(ctx, attn_rng, deterministic, h0)
        r = axis_index(SEQ_AXIS)
        rows = seq_rows(layout, n, r)
        if kernel:
            ctx = gather_block_sparse_attention(
                q, k, v, rows, seq_sparse_factor(layout, s * n, n),
                causal_sp)
        else:
            if kpm_add is not None:
                kpm_add = gather_seq(kpm_add.detach(), dim=1)
            ctx = block_sparse_attention(
                q, gather_seq(k), gather_seq(v), rows, causal=causal_sp,
                key_padding_mask=kpm_add, q_offset=r * s)
        return self._context_dropout(ctx, attn_rng, deterministic, h0)

    def _gather_attention(self, q, k, v, mask, key_padding_mask, attn_rng,
                          deterministic, h0=0, positions=False,
                          seed_rng=None):
        """The dense core above one ``seq`` rank: this rank's rows (its
        chunk, or the gathered ``positions`` rows) against the K/V
        gathered over the axis, attention dropout inside the kernels from
        seed words drawn from ``seed_rng`` (else ``attn_rng``)."""
        kpm_add = self._additive_key_padding(mask, key_padding_mask,
                                             *k.shape[:2])
        drop = dropout_active(self.attn_dropout_ratio, attn_rng,
                              deterministic)
        return gather_attention(
            q, k, v, causal=self.causal, key_padding_mask=kpm_add,
            dropout_rate=self.attn_dropout_ratio if drop else 0.0,
            seed=dropout_seed(attn_rng if seed_rng is None else seed_rng,
                              q.device) if drop else None,
            head_offset=h0, total_heads=self.heads,
            q_offset=0 if positions else None)

    def _ring_attention(self, q, k, v, mask, key_padding_mask, attn_rng,
                        deterministic, h0=0):
        """The ring core on this rank's [b, s/N, heads, head_dim] chunk
        (its key-padding chunk rotates with K/V), and the attention
        dropout on its context (JAX ``layers.py:250-255``)."""
        kpm_add = self._additive_key_padding(mask, key_padding_mask,
                                             *q.shape[:2])
        ctx = ring_attention(q, k, v, causal=self.causal,
                             key_padding_mask=kpm_add)
        return self._context_dropout(ctx, attn_rng, deterministic, h0)

    def attention_core(self, params, y, mask=None, key_padding_mask=None,
                       attn_rng=None, deterministic=True, positions=None,
                       attn_seed_rng=None):
        """Fused-QKV attention -> [b, s, h] context.  q, k and v are
        strided views of the one [b, s, 3, heads, head_dim] projection,
        which the flash kernels read as they are.  ``attn_seed_rng``:
        the generator the dense core under ``seq`` draws its in-kernel
        dropout's seed words from (default ``attn_rng``).

        ``positions`` [b, K] (int64): queries, and so output rows, only at
        those positions, with keys and values over the whole sequence;
        the dense bidirectional core only.  Returns [b, K, h]."""
        b, s = y.shape[:2]
        seq = axis_size(SEQ_AXIS) > 1
        heads, h0 = self.local_heads(params)
        h = heads * self.head_dim   # this rank's width of the context
        y = copy_to(y, MODEL_AXIS)
        if positions is not None:
            if self.attn_impl != "auto" or self.causal:
                raise ValueError("query-gathered attention supports the "
                                 "dense bidirectional core only")
            n = positions.shape[1]
            w = params["qkv"]["kernel"].to(y.dtype)
            bias = params["qkv"]["bias"].to(y.dtype)
            y_sel = torch.take_along_dim(y, positions[..., None], dim=1)
            q = (y_sel @ w[:, :h] + bias[:h]).reshape(b, n, heads,
                                                      self.head_dim)
            kv = (y @ w[:, h:] + bias[h:]).reshape(b, s, 2, heads,
                                                   self.head_dim)
            if seq:
                return self._gather_attention(
                    q, kv[:, :, 0], kv[:, :, 1], mask, key_padding_mask,
                    attn_rng, deterministic, h0, positions=True,
                    seed_rng=attn_seed_rng).reshape(
                        b, n, h)
            ctx = dot_product_attention(
                q, kv[:, :, 0], kv[:, :, 1], mask=mask,
                key_padding_mask=key_padding_mask, causal=False,
                dropout_rate=self.attn_dropout_ratio, dropout_rng=attn_rng,
                deterministic=deterministic, head_offset=h0,
                total_heads=self.heads)
            return ctx.reshape(b, n, h)
        qkv = dense(params["qkv"], y).reshape(b, s, 3, heads,
                                              self.head_dim)
        if self.attn_impl == "ring":
            return self._ring_attention(
                qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask,
                key_padding_mask, attn_rng, deterministic,
                h0).reshape(b, s, h)
        if self.attn_impl == "sparse":
            return self._sparse_attention(
                qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask,
                key_padding_mask, attn_rng, deterministic,
                h0).reshape(b, s, h)
        if seq:
            return self._gather_attention(
                qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask,
                key_padding_mask, attn_rng, deterministic, h0,
                seed_rng=attn_seed_rng).reshape(b, s, h)
        ctx = dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask=mask,
            key_padding_mask=key_padding_mask, causal=self.causal,
            dropout_rate=self.attn_dropout_ratio, dropout_rng=attn_rng,
            deterministic=deterministic, head_offset=h0,
            total_heads=self.heads)
        return ctx.reshape(b, s, h)

    def apply(self, params, x, mask=None, key_padding_mask=None, rng=None,
              deterministic=True, positions=None, attn_seed_rng=None):
        """x: [batch, seq, hidden]; ``mask`` additive [batch, 1, 1, seq]
        or ``key_padding_mask`` [batch, seq] with 1 at visible tokens (the
        flash kernels' fused form); ``rng`` a ``torch.Generator`` on
        x's device, drawn by the attention, attention-output and MLP
        dropouts in that order; under ``seq``, ``attn_seed_rng`` (the
        layer's stream before the seq mixing, the same on every seq rank)
        gives the dense core's in-kernel dropout its seed words, so the
        chunks drop the rows of one call.  ``positions`` [b, K]: outputs only at
        those rows (queries gathered, keys and values over the whole
        sequence, the residuals, MLP and layernorms on the K rows), for a
        last layer whose head reads few positions; returns [b, K,
        hidden]."""
        if mask is not None and key_padding_mask is not None:
            raise ValueError(
                "pass either an additive mask or a key_padding_mask, not both")
        rate = self.hidden_dropout_ratio

        def attention_block(y):
            with named_scope("attention"):
                ctx = self.attention_core(params, y, mask=mask,
                                          key_padding_mask=key_padding_mask,
                                          attn_rng=rng,
                                          deterministic=deterministic,
                                          positions=positions,
                                          attn_seed_rng=attn_seed_rng)
                return dropout(rng, row_dense(params["attn_out"], ctx), rate,
                               deterministic)

        def mlp_block(y):
            with named_scope("mlp"):
                z = gelu(dense(params["fc1"], copy_to(y, MODEL_AXIS)))
                return dropout(rng, row_dense(params["fc2"], z), rate,
                               deterministic)

        def ln(p, y):
            return layer_norm(p, y, self.layer_norm_eps)

        if self.attn_dropout_checkpoint:
            attention_block = recomputed(attention_block, rng,
                                         attn_seed_rng)
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


def vocab_parallel_embedding(table, ids):
    """``table[ids]`` for a ``[V, H]`` table sliced over ``model`` by
    rows (vocab-parallel, ``P("model", None)``): each rank looks up the
    ids in its rows, zeros elsewhere, and one sum over the ranks gives
    every rank the whole lookup (bitwise: one rank adds a row to zeros).
    ``table[ids]`` itself at one ``model`` rank."""
    if axis_size(MODEL_AXIS) == 1:
        return table[ids]
    rows = table.shape[0]
    local = ids - axis_index(MODEL_AXIS) * rows
    inside = (local >= 0) & (local < rows)
    x = table[torch.where(inside, local, 0)]
    return reduce_from(torch.where(inside[..., None], x, 0.0).to(x.dtype),
                       MODEL_AXIS)


def vocab_parallel_nll_sum(logits, labels, ignore_index=-100):
    """``(Σ token nll, mask)`` of a rank's ``[..., V/m]`` slice of the
    logits (vocab rows ``[r·V/m, (r+1)·V/m)``, as the tied head makes
    them), without gathering them: the row max over the ranks (a max
    all-reduce, no gradient), then the sum of exponentials and the
    target's logit in one sum all-reduce; fp32.  At one ``model`` rank,
    the JAX package's logsumexp form."""
    logits = logits.float()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0).long()
    if axis_size(MODEL_AXIS) == 1:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        return ((lse - gold) * mask).sum(), mask
    rows = logits.shape[-1]
    local = safe - axis_index(MODEL_AXIS) * rows
    inside = (local >= 0) & (local < rows)
    gmax = pmax(logits.detach().amax(dim=-1), MODEL_AXIS)
    sumexp = (logits - gmax[..., None]).exp().sum(-1)
    gold = torch.where(inside, torch.gather(
        logits, -1, torch.where(inside, local, 0)[..., None])[..., 0], 0.0)
    sumexp, gold = reduce_from(torch.stack([sumexp, gold]), MODEL_AXIS)
    return ((sumexp.log() + gmax - gold) * mask).sum(), mask


def vocab_parallel_cross_entropy(logits, labels, ignore_index=-100):
    """:func:`cross_entropy_with_logits` of logits sliced over ``model``
    by vocab (:func:`vocab_parallel_nll_sum`); the function itself at
    one ``model`` rank."""
    if axis_size(MODEL_AXIS) == 1:
        return cross_entropy_with_logits(logits, labels, ignore_index)
    total, mask = vocab_parallel_nll_sum(logits, labels, ignore_index)
    return total / data_parallel_mean_count(mask.sum())
