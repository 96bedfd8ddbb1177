"""Ring attention: exact attention over sequence-sharded Q, K and V
(port of ``deepspeed_tpu/ops/transformer/ring_attention.py``).

The sequence is cut over the mesh's ``seq`` axis: rank ``r`` of ``N``
holds positions ``[r·s/N, (r+1)·s/N)`` of q, k, v (``[b, s/N, h, d]``,
the local chunks, where the JAX function takes the global arrays and
``shard_map`` cuts them).  Each rank keeps its Q chunk; the K/V chunks,
and the key-padding chunk with them, rotate around the ring (rank r
sends to r+1), so at step ``t`` rank ``me`` holds chunk ``src = (me −
t) mod N``, and the softmax over all of them is merged exactly.

On every device it runs :class:`RingFlashAttention`, which launches
the hand-written flash kernels on every (local Q, held K/V) pair: B1
(:func:`~.flash_attention.flash_attention_fwd`) forward, with
``causal=True`` on the diagonal pair (``src == me``), ``causal=False``
below it (``src < me``) and no launch above it (``src > me``, a pair the
JAX body masks whole, which adds exactly 0); the pairs' ``(out, lse)``
merged by lse in fp32.  Backward computes Δ once from the merged output
and runs B2a (dq) and B2b (dk, dv) on each pair with the merged lse and
Δ; the fp32 dk/dv accumulators travel around the ring with their chunk
and arrive back at its owner.  The next chunk's send and receive are
posted before the current pair's kernels launch
(:func:`~deepspeed_tpu_torch.comm.send_recv` with ``async_op``), so the
wire overlaps the compute.  On CUDA tensors the wrappers launch their
kernels or raise; on CPU tensors they run their plain versions, so the
CPU computes what the card does.

At one ``seq`` rank it runs :class:`~.flash_attention.FlashAttention`
(B1 and B3 or B2a+B2b on the card, their plain versions on the CPU).
B1, B2a and B2b fix the scale at 1/√d, so a custom ``scale`` is applied
by pre-scaling q by ``scale·√d``, as the JAX fallback does.  The
additive key-padding mask is read as a mask: 0 keeps a key, a bias at or
below ``MASKED_BELOW`` drops it (a mask made by
:func:`~.attention.key_padding_to_additive` is one of the two).  A row
whose every key is padded comes out 0, as B1 gives it, where the JAX
body averages its −1e9 scores into the mean of the values.  Attention
dropout is the caller's, on the output (the JAX layer's): the ring runs
no B4.

:func:`ring_flash_attention_local` runs the same per-rank code for all
``N`` shards in one process, the rotation done as indexing (its
result is bitwise the ranks'); the tests and ``chip_smoke.py`` use it,
since NCCL takes one rank a card.  Nothing on the training path calls
it.
"""

import math

import torch

from ... import comm
from ...parallel.mesh import SEQ_AXIS, get_current_mesh
from .flash_attention import (FlashAttention, _delta,
                              flash_attention_bwd_dkv,
                              flash_attention_bwd_dq, flash_attention_fwd)

# an additive key-padding bias at or below this masks the key
# (key_padding_to_additive gives 0 or -1e9)
MASKED_BELOW = -0.5e9


def ring_attention(q, k, v, mesh=None, axis_name=SEQ_AXIS, causal=False,
                   key_padding_mask=None, scale=None):
    """Exact attention over the sequence cut on ``axis_name``.

    Args:
        q, k, v: this rank's ``[batch, seq/N, heads, head_dim]`` chunks.
        mesh: the mesh (default: the current one, which an engine sets).
        causal: autoregressive masking by global positions.
        key_padding_mask: additive ``[batch, seq/N]`` chunk (0 at visible
            keys, −1e9 at padded ones); it rotates with its K/V chunk.
        scale: the score scale (default 1/√head_dim).
    """
    mesh = mesh if mesh is not None else get_current_mesh()
    n = 1 if mesh is None else mesh.size(axis_name)
    d = q.shape[-1]
    default = 1.0 / math.sqrt(d)
    scale = default if scale is None else float(scale)
    if scale != default:
        q = q * (scale * math.sqrt(d))
    kv_mask = visible_keys(key_padding_mask)
    if n == 1:
        return FlashAttention.apply(q, k, v, kv_mask, None, causal, 0.0, 0,
                                    None)
    return RingFlashAttention.apply(q, k, v, kv_mask, causal, mesh,
                                    axis_name)


def visible_keys(key_padding_mask):
    """The flash kernels' key mask (fp32, 1 at visible keys) of an
    additive key-padding mask, or None."""
    if key_padding_mask is None:
        return None
    return (key_padding_mask.float() > MASKED_BELOW).float()


# ------------------------------------------------------------ kernel path
def _pack(k, v, kv_mask):
    """One contiguous buffer of a K/V chunk and its key mask (stored in
    k's dtype: 0 and 1 are exact in every one), the message a ring step
    sends."""
    n = k.numel()
    extra = 0 if kv_mask is None else kv_mask.numel()
    buf = torch.empty(2 * n + extra, dtype=k.dtype, device=k.device)
    buf[:n].view(k.shape).copy_(k)
    buf[n:2 * n].view(k.shape).copy_(v)
    if kv_mask is not None:
        buf[2 * n:].view(kv_mask.shape).copy_(kv_mask)
    return buf


def _unpack(buf, shape, masked):
    """``(k, v, kv_mask or None)`` views of a :func:`_pack` buffer."""
    n = math.prod(shape)
    k = buf[:n].view(shape)
    v = buf[n:2 * n].view(shape)
    return k, v, (buf[2 * n:].view(shape[0], shape[1]) if masked else None)


class _Shard:
    """One ``seq`` rank's side of the ring, the same code on the ranks
    and in the one-process schedule: its Q chunk, and over the pairs it
    runs, the merged ``(out, lse)`` (forward) or its dq (backward)."""

    def __init__(self, q, me, n, causal):
        self.q, self.me, self.n, self.causal = q, me, n, causal
        self.o = self.lse = self.dq = None

    def pair(self, t):
        """``(src, causal)`` of step ``t``'s pair, or None where it
        launches nothing (a chunk wholly above the diagonal)."""
        src = (self.me - t) % self.n
        if self.causal and src > self.me:
            return None
        return src, self.causal and src == self.me

    def forward_pair(self, t, k, v, kv_mask):
        run = self.pair(t)
        if run is None:
            return
        out, lse = flash_attention_fwd(self.q, k, v, kv_mask, run[1])
        if self.o is None:
            self.o, self.lse = out.float(), lse
            return
        # out = Σ_i exp(lse_i − lse)·out_i, lse = logsumexp_i(lse_i), in
        # fp32; a chunk with every key masked has lse MAX_FLOOR: weight 0
        b, s, h, _ = out.shape
        new = torch.logaddexp(self.lse, lse)

        def weight(x):   # [b·h, s] -> [b, s, h, 1]
            return torch.exp(x - new).view(b, h, s).transpose(1, 2)[..., None]

        self.o = self.o * weight(self.lse) + out.float() * weight(lse)
        self.lse = new

    def output(self):
        """The merged ``(out in q's dtype, lse [b·h, s] fp32)``."""
        return self.o.to(self.q.dtype), self.lse

    def backward_begin(self, out, lse, dout):
        self.out, self.lse, self.dout = out, lse, dout
        self.delta = _delta(out, dout)

    def backward_pair(self, t, k, v, kv_mask):
        """This pair's ``(dk, dv)`` of the held chunk (its dq share goes
        into the fp32 dq), or None where it launches nothing."""
        run = self.pair(t)
        if run is None:
            return None
        args = (self.q, k, v, self.out, self.lse, self.dout, kv_mask, run[1])
        dq = flash_attention_bwd_dq(*args, delta=self.delta).float()
        self.dq = dq if self.dq is None else self.dq.add_(dq)
        return flash_attention_bwd_dkv(*args, delta=self.delta)


def _add_pair(acc, pair):
    if pair is not None:
        acc[0].add_(pair[0])
        acc[1].add_(pair[1])


class _Ring:
    """The rotation over the ranks of ``axis_name``: :meth:`shift`
    posts the send of a buffer to the next rank and the receive of the
    previous rank's, and returns the receive buffer and the handle."""

    def __init__(self, mesh, axis_name):
        self.mesh, self.axis_name = mesh, axis_name
        self.n, self.me = mesh.size(axis_name), mesh.index(axis_name)

    def shift(self, buf):
        nxt = torch.empty_like(buf)
        handle = comm.send_recv(sends=[(buf, (self.me + 1) % self.n)],
                                recvs=[(nxt, (self.me - 1) % self.n)],
                                axis_name=self.axis_name, mesh=self.mesh,
                                async_op=True)
        return nxt, handle


class RingFlashAttention(torch.autograd.Function):
    """``RingFlashAttention.apply(q, k, v, kv_mask, causal, mesh,
    axis_name)`` -> this rank's out ``[b, s/N, h, d]``: the kernel path
    of :func:`ring_attention` on one rank (see the module docstring);
    ``kv_mask`` is the fp32 key mask of the rank's chunk (1 visible)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, mesh, axis_name):
        ring = _Ring(mesh, axis_name)
        shard = _Shard(q, ring.me, ring.n, causal)
        held = _pack(k, v, kv_mask)
        for t in range(ring.n):
            nxt, handle = ring.shift(held) if t < ring.n - 1 else (None,
                                                                  None)
            shard.forward_pair(t, *_unpack(held, k.shape,
                                           kv_mask is not None))
            if handle is not None:
                handle.wait()
                held = nxt
        out, lse = shard.output()
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.ring = causal, ring
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        ring = ctx.ring
        shard = _Shard(q, ring.me, ring.n, ctx.causal)
        shard.backward_begin(out, lse, dout.contiguous())
        masked = kv_mask is not None
        held = _pack(k, v, kv_mask)
        # the fp32 dk, dv of the held chunk, which travel with it
        acc = torch.zeros((2, *k.shape), dtype=torch.float32,
                          device=k.device)
        acc_handle = None
        for t in range(ring.n):
            nxt, kv_handle = ring.shift(held) if t < ring.n - 1 else (None,
                                                                     None)
            pair = shard.backward_pair(t, *_unpack(held, k.shape, masked))
            if acc_handle is not None:
                acc_handle.wait()
                acc = acc_in
            _add_pair(acc, pair)
            # after the last step the owner's own accumulator comes back
            acc_in, acc_handle = ring.shift(acc)
            if kv_handle is not None:
                kv_handle.wait()
                held = nxt
        acc_handle.wait()
        return (shard.dq.to(q.dtype), acc_in[0].to(k.dtype),
                acc_in[1].to(v.dtype), None, None, None, None)


class _RingFlashLocal(torch.autograd.Function):
    """The kernel path's ring for all ``n`` shards in one process."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, n):
        qs, ks, vs = (x.chunk(n, dim=1) for x in (q, k, v))
        ms = kv_mask.chunk(n, dim=1) if kv_mask is not None else [None] * n
        held = [_pack(ks[r], vs[r], ms[r]) for r in range(n)]
        shards = [_Shard(qs[r], r, n, causal) for r in range(n)]
        for t in range(n):
            for me, shard in enumerate(shards):
                shard.forward_pair(t, *_unpack(held[(me - t) % n],
                                               ks[0].shape,
                                               kv_mask is not None))
        outs, lses = zip(*(shard.output() for shard in shards))
        out = torch.cat(outs, dim=1)
        ctx.save_for_backward(q, k, v, kv_mask, out, *lses)
        ctx.causal, ctx.n = causal, n
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, *lses = ctx.saved_tensors
        n = ctx.n
        qs, ks, vs, outs, douts = (x.chunk(n, dim=1) for x in
                                   (q, k, v, out, dout.contiguous()))
        ms = kv_mask.chunk(n, dim=1) if kv_mask is not None else [None] * n
        held = [_pack(ks[r], vs[r], ms[r]) for r in range(n)]
        accs = [torch.zeros((2, *ks[0].shape), dtype=torch.float32,
                            device=k.device) for _ in range(n)]
        shards = []
        for r in range(n):
            shard = _Shard(qs[r], r, n, ctx.causal)
            shard.backward_begin(outs[r], lses[r], douts[r].contiguous())
            shards.append(shard)
        for t in range(n):
            for me, shard in enumerate(shards):
                src = (me - t) % n
                _add_pair(accs[src], shard.backward_pair(
                    t, *_unpack(held[src], ks[0].shape,
                                kv_mask is not None)))
        dq = torch.cat([s.dq.to(q.dtype) for s in shards], dim=1)
        dk = torch.cat([a[0].to(k.dtype) for a in accs], dim=1)
        dv = torch.cat([a[1].to(v.dtype) for a in accs], dim=1)
        return dq, dk, dv, None, None, None


def ring_flash_attention_local(q, k, v, n, causal=False,
                               key_padding_mask=None):
    """The kernel path's ring of ``n`` ``seq`` shards run in one process
    on the WHOLE ``[b, s, h, d]`` q, k, v (cut into ``n`` chunks along
    s): the ranks' per-shard code (:class:`_Shard`) with the rotation
    done as indexing, so its out and its gradients are bitwise what ``n``
    ranks of :class:`RingFlashAttention` give.  ``key_padding_mask`` is
    the whole additive ``[b, s]`` mask.  CUDA tensors launch B1, B2a and
    B2b; CPU tensors run their plain versions."""
    if q.shape[1] % n:
        raise ValueError(f"seq {q.shape[1]} does not split into {n} "
                         f"chunks")
    return _RingFlashLocal.apply(q, k, v, visible_keys(key_padding_mask),
                                 causal, n)
