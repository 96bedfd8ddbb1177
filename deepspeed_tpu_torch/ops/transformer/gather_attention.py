"""Gather attention: exact attention over a sequence cut on the mesh's
``seq`` axis by gathering K and V, the dense and the block-sparse cores'
form of sequence parallelism (the JAX package runs those cores over a
``seq`` mesh through GSPMD, which gathers the sequence the same way).

Rank ``r`` of ``N`` holds rows ``[r·s/N, (r+1)·s/N)`` of q, k, v
(``[b, s/N, h, d]`` chunks).  Its core:

1. all-gathers K, V and the key-padding chunk over ``seq`` (one message
   a rank, :func:`~.ring_attention._pack`'s);
2. runs the kernels on its own Q rows against the gathered K/V, the rows
   carrying their global place, the query-row offset ``q_offset =
   r·s/N``.  The dense core runs B1 (:func:`~.flash_attention.flash_attention_fwd`)
   and, under ``causal``, only against the keys its rows can see,
   ``kv_len = (r+1)·s/N``; attention dropout is B4's bits of the rank's
   rows of the whole call (:func:`~.flash_attention.draw_keep_bits` with
   the offset), drawn from seed words every ``seq`` rank shares, so the
   ranks drop exactly what one call on the whole sequence drops.  The sparse core
   runs B5a or B6a on the rank's block rows of the WHOLE sequence's
   layout (``[H, nb/N, nb]``) with the same offset;
3. backward: gathers K/V again (the state a layer saves stays the
   chunk's, plus the keep bits), runs B3 or B2a+B2b (dense) or B5b /
   B6b+B6c (sparse) for dq and the partial dk, dv of every gathered key,
   and reduce-scatters the partials (fp32 sum) back to their owners.

On CUDA tensors the wrappers launch their kernels or raise; on CPU
tensors they run their plain versions, so the CPU computes what the
card does.  At one ``seq`` rank the layer runs its ordinary core.

:func:`gather_flash_attention_local` and
:func:`gather_block_sparse_attention_local` run the same per-rank code
for all ``N`` shards in one process, the gather done as indexing and
the reduce-scatter as a sum (its result is the ranks'); the tests and
``chip_smoke.py`` use them, since NCCL takes one rank a card.  Nothing
on the training path calls them.
"""

import weakref

import numpy as np
import torch

from ... import comm
from ...parallel.mesh import SEQ_AXIS, get_current_mesh
from ..sparse_attention import flash_block_sparse as fbs
from .flash_attention import (draw_keep_bits, flash_attention_bwd,
                              flash_attention_fwd)
from .ring_attention import _pack, _unpack, visible_keys


def _gather_kv(k, v, kv_mask, mesh, axis_name):
    """Every rank's K, V (and key mask) joined along the sequence:
    ``[b, N·s/N, h, d]`` and ``[b, N·s/N]``, from one all-gather."""
    n = mesh.size(axis_name)
    parts = comm.all_gather(_pack(k, v, kv_mask), axis_name, mesh=mesh,
                            tiled=False)
    chunks = [_unpack(parts[r], k.shape, kv_mask is not None)
              for r in range(n)]
    ks, vs, ms = zip(*chunks)
    return (torch.cat(ks, dim=1), torch.cat(vs, dim=1),
            None if kv_mask is None else torch.cat(ms, dim=1))


def _scatter_partials(dk, dv, n, r_keys, sl):
    """The fp32 ``[n, 2, b, sl, h, d]`` message of a rank's partial dk and
    dv: chunk c's keys in row c (zeros past the ``r_keys`` chunks the
    rank's rows saw)."""
    b, _, h, d = dk.shape
    parts = torch.zeros((n, 2, b, sl, h, d), dtype=torch.float32,
                        device=dk.device)
    for i, g in enumerate((dk, dv)):
        parts[:r_keys, i] = g.float().view(b, r_keys, sl, h, d) \
            .transpose(0, 1)
    return parts


# ------------------------------------------------------------- the shards
class _DenseShard:
    """One ``seq`` rank's dense core on its rows, the same code on the
    ranks and in the one-process form."""

    def __init__(self, causal, dropout_rate, head_offset, total_heads):
        self.causal, self.rate = causal, dropout_rate
        self.head_offset, self.total_heads = head_offset, total_heads

    def keys(self, q, kg, q_offset):
        """The gathered keys the rows see: all, or under ``causal`` the
        first ``q_offset + rows``."""
        return (min(kg.shape[1], q_offset + q.shape[1]) if self.causal
                else kg.shape[1])

    def forward(self, q, kg, vg, mg, seed, q_offset):
        kv_len = self.keys(q, kg, q_offset)
        bits = None
        if self.rate:
            b, s, h, _ = q.shape
            bits = draw_keep_bits(seed, b, h, s, kv_len, self.rate,
                                  self.causal, self.head_offset,
                                  self.total_heads, q_offset)
        out, lse = flash_attention_fwd(
            q, kg[:, :kv_len], vg[:, :kv_len],
            None if mg is None else mg[:, :kv_len], self.causal, self.rate,
            keep_bits=bits, q_offset=q_offset)
        return out, lse, bits

    def backward(self, q, kg, vg, mg, out, lse, dout, bits, q_offset):
        kv_len = self.keys(q, kg, q_offset)
        return flash_attention_bwd(
            q, kg[:, :kv_len], vg[:, :kv_len], out, lse, dout,
            None if mg is None else mg[:, :kv_len], self.causal, self.rate,
            bits, q_offset)


class _SparseShard:
    """One ``seq`` rank's block-sparse core on its block rows ``rows``
    (``[H, nb/N, nb]`` of the whole sequence's layout) at factor ``G``:
    B6 for G > 1, B5 at G = 1."""

    def __init__(self, rows, G, causal):
        self.rows, self.G, self.causal = rows, G, causal

    def forward(self, q, kg, vg, mg, seed, q_offset):
        if self.G > 1:
            out, lse = fbs.flash_block_sparse_agg_fwd(
                q, kg, vg, self.rows, self.G, self.causal, q_offset)
        else:
            out, lse = fbs.flash_block_sparse_fwd(q, kg, vg, self.rows,
                                                  self.causal, q_offset)
        return out, lse, None

    def backward(self, q, kg, vg, mg, out, lse, dout, bits, q_offset):
        if self.G > 1:
            return fbs.flash_block_sparse_agg_bwd(
                q, kg, vg, out, lse, dout, self.rows, self.G, self.causal,
                q_offset)
        return fbs.flash_block_sparse_bwd(q, kg, vg, out, lse, dout,
                                          self.rows, self.causal, q_offset)


class GatherAttention(torch.autograd.Function):
    """``GatherAttention.apply(q, k, v, kv_mask, seed, shard, mesh,
    axis_name, q_offset)`` -> this rank's out ``[b, rows, h, d]``: the
    kernel path of the gather cores on one rank (see the module
    docstring).  ``shard`` is a :class:`_DenseShard` or
    :class:`_SparseShard`; ``kv_mask`` is the fp32 key mask of the rank's
    chunk (1 visible); ``q_offset`` the global row of q's first row."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seed, shard, mesh, axis_name,
                q_offset):
        kg, vg, mg = _gather_kv(k, v, kv_mask, mesh, axis_name)
        out, lse, bits = shard.forward(q, kg, vg, mg, seed, q_offset)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse, bits)
        ctx.shard, ctx.mesh, ctx.axis_name = shard, mesh, axis_name
        ctx.q_offset = q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse, bits = ctx.saved_tensors
        mesh, axis_name = ctx.mesh, ctx.axis_name
        kg, vg, mg = _gather_kv(k, v, kv_mask, mesh, axis_name)
        dq, dk, dv = ctx.shard.backward(q, kg, vg, mg, out, lse,
                                        dout.contiguous(), bits,
                                        ctx.q_offset)
        sl = k.shape[1]
        parts = _scatter_partials(dk, dv, mesh.size(axis_name),
                                  dk.shape[1] // sl, sl)
        mine = comm.reduce_scatter(parts, axis_name, mesh=mesh, tiled=False)
        return (dq, mine[0].to(k.dtype), mine[1].to(v.dtype), None, None,
                None, None, None, None)


def gather_attention(q, k, v, mesh=None, axis_name=SEQ_AXIS, causal=False,
                     key_padding_mask=None, dropout_rate=0.0, seed=None,
                     head_offset=0, total_heads=None, q_offset=None):
    """The dense core over the sequence cut on ``axis_name`` (B1, B4, and
    B3 or B2a+B2b on the card).

    Args:
        q: this rank's ``[batch, rows, heads, head_dim]`` queries: its
            chunk (``q_offset`` None: the chunk's own rows, at ``r·s/N``)
            or gathered rows (BERT's MLM positions: ``q_offset`` 0,
            bidirectional only).
        k, v: this rank's ``[batch, seq/N, heads, head_dim]`` chunks.
        key_padding_mask: additive ``[batch, seq/N]`` chunk (0 visible,
            −1e9 padded); it is gathered with K/V.
        dropout_rate, seed: attention dropout inside the kernels, drawn
            from the two int32 ``seed`` words, the same on every ``seq``
            rank (the layer's attention stream before the seq mixing:
            ``TransformerLayer.apply``'s ``attn_seed_rng``), so each
            chunk drops its rows of one call.
        head_offset, total_heads: the heads' place in the whole layer's
            (a ``model`` rank's range).
    """
    mesh = mesh if mesh is not None else get_current_mesh()
    if q_offset is None:
        q_offset = mesh.index(axis_name) * k.shape[1]
    elif causal:
        raise ValueError("gathered query rows attend bidirectionally only")
    shard = _DenseShard(causal, float(dropout_rate), head_offset,
                        total_heads)
    return GatherAttention.apply(q, k, v, visible_keys(key_padding_mask),
                                 seed, shard, mesh, axis_name, q_offset)


# id(layout) -> (weak reference to the layout, {n: [rows of each rank]})
_rows_cache = {}


def seq_rows(layout, n, r):
    """Rank ``r`` of ``n``'s block rows ``[H, nb/n, nb]`` of a whole
    sequence's layout, a contiguous array made once per (layout array,
    n) and kept while the layout lives, so the kernels' device tables
    (cached on the array) are built once."""
    nb = layout.shape[1]
    if nb % n:
        raise ValueError(f"a layout of {nb} block rows does not split over "
                         f"{n} seq ranks")
    key = id(layout)
    entry = _rows_cache.get(key)
    if entry is None or entry[0]() is not layout:
        entry = _rows_cache[key] = (weakref.ref(
            layout, lambda _, key=key: _rows_cache.pop(key, None)), {})
    per = nb // n
    rows = entry[1].get(n)
    if rows is None:
        rows = entry[1][n] = [np.ascontiguousarray(
            layout[:, i * per:(i + 1) * per]) for i in range(n)]
    return rows[r]


def seq_sparse_factor(layout, s, n, q_agg="auto"):
    """The aggregation factor of a rank's rows: the whole layout's G
    (:func:`~..sparse_attention.flash_block_sparse.sparse_factor`) where
    it divides the ``nb/n`` block rows, else 1 (B5)."""
    G = fbs.sparse_factor(layout, s, q_agg)
    return G if (layout.shape[1] // n) % G == 0 else 1


def gather_block_sparse_attention(q, k, v, rows, G, causal=False, mesh=None,
                                  axis_name=SEQ_AXIS):
    """The block-sparse flash core over the sequence cut on ``axis_name``
    (B5a/B5b at ``G`` 1, B6a/B6b/B6c above): this rank's ``[b, s/N, h,
    d]`` chunks and its block rows ``rows`` (:func:`seq_rows`) of the
    whole sequence's layout.  No key mask (the gather path takes a
    masked call)."""
    mesh = mesh if mesh is not None else get_current_mesh()
    q_offset = mesh.index(axis_name) * q.shape[1]
    return GatherAttention.apply(q, k, v, None, None,
                                 _SparseShard(rows, G, bool(causal)), mesh,
                                 axis_name, q_offset)


# ----------------------------------------------------- one-process forms
class _GatherLocal(torch.autograd.Function):
    """The kernel path's gather core for all ``n`` shards in one
    process: each shard's rows against the whole K/V (the gather), and
    the shards' partial dk, dv summed per chunk (the reduce-scatter)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seed, shards, n):
        sl = q.shape[1] // n
        outs, lses, bits = [], [], []
        for r, shard in enumerate(shards):
            o, l, b = shard.forward(q[:, r * sl:(r + 1) * sl], k, v, kv_mask,
                                    seed, r * sl)
            outs.append(o)
            lses.append(l)
            bits.append(b)
        out = torch.cat(outs, dim=1)
        ctx.save_for_backward(q, k, v, kv_mask, out, *lses)
        ctx.bits, ctx.shards, ctx.n = bits, shards, n
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, *lses = ctx.saved_tensors
        n = ctx.n
        sl = q.shape[1] // n
        dout = dout.contiguous()
        parts, dqs = None, []
        for r, shard in enumerate(ctx.shards):
            rows = slice(r * sl, (r + 1) * sl)
            dq, dk, dv = shard.backward(q[:, rows], k, v, kv_mask,
                                        out[:, rows].contiguous(), lses[r],
                                        dout[:, rows].contiguous(),
                                        ctx.bits[r], r * sl)
            dqs.append(dq)
            p = _scatter_partials(dk, dv, n, dk.shape[1] // sl, sl)
            parts = p if parts is None else parts.add_(p)
        b, _, h, d = k.shape
        dk, dv = (parts[:, i].transpose(0, 1).reshape(b, n * sl, h, d)
                  for i in range(2))
        return (torch.cat(dqs, dim=1), dk.to(k.dtype), dv.to(v.dtype), None,
                None, None, None)


def gather_flash_attention_local(q, k, v, n, causal=False,
                                 key_padding_mask=None, dropout_rate=0.0,
                                 seed=None):
    """The dense gather core of ``n`` ``seq`` shards run in one process on
    the WHOLE ``[b, s, h, d]`` q, k, v (cut into ``n`` chunks along s):
    the ranks' per-shard code with the gather and reduce-scatter done as
    indexing and a sum, so its out and gradients are the ranks'.
    ``key_padding_mask`` is the whole additive ``[b, s]`` mask; under
    dropout each shard draws its rows of one call's bits from ``seed``.
    CUDA tensors launch B1, B4 and B3 or B2a+B2b; CPU tensors run their
    plain versions."""
    if q.shape[1] % n:
        raise ValueError(f"seq {q.shape[1]} does not split into {n} "
                         f"chunks")
    shards = [_DenseShard(causal, float(dropout_rate), 0, None)] * n
    return _GatherLocal.apply(q, k, v, visible_keys(key_padding_mask), seed,
                              shards, n)


def gather_block_sparse_attention_local(q, k, v, layout, n, causal=False,
                                        q_agg="auto"):
    """The block-sparse gather core of ``n`` ``seq`` shards in one
    process on the whole ``[b, s, h, d]`` q, k, v and the whole
    sequence's ``layout``: shard r runs its block rows (:func:`seq_rows`)
    at :func:`seq_sparse_factor`'s G against the whole K/V.  Returns the
    out and, through autograd, the ranks' gradients."""
    if q.shape[1] % n:
        raise ValueError(f"seq {q.shape[1]} does not split into {n} "
                         f"chunks")
    G = seq_sparse_factor(layout, q.shape[1], n, q_agg)
    shards = [_SparseShard(seq_rows(layout, n, r), G, bool(causal))
              for r in range(n)]
    return _GatherLocal.apply(q, k, v, None, None, shards, n)
