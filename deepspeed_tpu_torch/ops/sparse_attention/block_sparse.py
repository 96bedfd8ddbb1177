"""Block-sparse attention by gather: blockwise softmax(QKᵀ)V over the
active blocks of a layout, in plain PyTorch.

Port of ``deepspeed_tpu/ops/sparse_attention/block_sparse.py``.  For each
(head, query block) the active key-block indices are gathered, padded to
the layout's largest row count, and attention runs as batched
``[block, block]`` products over those blocks only, so compute and memory
scale with the number of active blocks.  Scores are fp32; autograd
differentiates it.  This is the general path (key-padding mask,
``attn_mask``, relative position bias, any scale) and the CPU path; the
Hopper kernels of ``flash_block_sparse.py`` take the unmasked case on the
card.
"""

import math

import numpy as np
import torch

NEG_INF = -1e9


def layout_gather_indices(layout):
    """Static per-(head, q-block) active key-block indices.

    Returns ``(indices, valid)`` with shapes ``[h, nb, kmax]``: ``indices``
    padded with 0, ``valid`` marking real entries (numpy, host-side).  A
    sequence-parallel rank's ``[h, nb/N, nb]`` rows of a layout give their
    rows' entries."""
    layout = np.asarray(layout)
    h, nb, _ = layout.shape
    counts = layout.sum(-1)
    kmax = max(1, int(counts.max()))
    indices = np.zeros((h, nb, kmax), np.int32)
    valid = np.zeros((h, nb, kmax), bool)
    for hi in range(h):
        for qi in range(nb):
            cols = np.nonzero(layout[hi, qi])[0]
            indices[hi, qi, :len(cols)] = cols
            valid[hi, qi, :len(cols)] = True
    return indices, valid


def block_sparse_attention(q, k, v, layout, causal=False,
                           key_padding_mask=None, attn_mask=None,
                           rpe=None, scale=None, q_offset=0):
    """softmax((QKᵀ)·scale + masks)V restricted to a block layout.

    Args:
        q, k, v: ``[batch, seq, heads, head_dim]``.
        layout: ``[H, nb, nb]`` 0/1 (H == heads or 1, shared).
        causal: additionally mask within-block upper triangles
            ('unidirectional' layouts).
        key_padding_mask: additive ``[batch, seq]``; masked keys must use a
            large but FINITE negative (``NEG_INF = -1e9``): a true ``-inf``
            turns the softmax into NaN before the fully-masked-row guard
            can zero it.
        attn_mask: additive ``[seq, seq]``.
        rpe: additive relative-position bias ``[heads, seq, seq]``.
        scale: defaults to 1/sqrt(head_dim).
        q_offset: a sequence-parallel rank's chunk: q holds rows
            ``q_offset ..`` of the sequence, ``layout`` its ``[H, nb/N,
            nb]`` block rows of the whole sequence's layout, k, v and the
            key-padding mask the whole (gathered) sequence; ``attn_mask``
            and ``rpe`` stay the whole sequence's.

    Rows with no visible key give zero output, and the row max is taken
    out of the gradient, as in the JAX function."""
    b, s, h, d = q.shape
    layout = np.asarray(layout)
    if layout.shape[0] == 1 and h > 1:
        layout = np.broadcast_to(layout, (h,) + layout.shape[1:])
    if layout.shape[0] != h:
        raise ValueError(f"layout heads {layout.shape[0]} != {h}")
    nb, nbk = layout.shape[1:]
    if s % nb != 0:
        raise ValueError(f"seq {s} not divisible into {nb} blocks")
    blk = s // nb
    if k.shape[1] != nbk * blk or q_offset % blk:
        raise ValueError(f"a layout of {nb} x {nbk} blocks of {blk} takes "
                         f"{nbk * blk} keys and a block-aligned q_offset, "
                         f"got {k.shape[1]} and {q_offset}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device

    indices, valid = layout_gather_indices(layout)  # [h, nb, kmax]
    kmax = indices.shape[-1]
    idx = torch.from_numpy(indices.astype(np.int64)).to(dev)
    head = torch.arange(h, device=dev)[:, None, None]

    # [b, n·blk, h, d] -> [b, h, n, blk, d]
    def to_blocks(x):
        return x.reshape(b, -1, blk, h, d).permute(0, 3, 1, 2, 4)

    qb, kb, vb = to_blocks(q), to_blocks(k), to_blocks(v)
    # active key/value blocks per (head, q-block): [b, h, nb, kmax, blk, d]
    kg = kb[:, head, idx]
    vg = vb[:, head, idx]

    # scores over active blocks only: [b, h, nb, blk_q, kmax, blk_k]
    scores = torch.einsum("bhnqd,bhnkcd->bhnqkc", qb.float(),
                          kg.float()) * scale

    # element positions for masking
    qpos = (q_offset + np.arange(nb)[:, None] * blk
            + np.arange(blk)[None, :])                       # [nb, blk]
    kpos = indices[..., None].astype(np.int64) * blk + np.arange(blk)

    visible = np.broadcast_to(valid[..., None], kpos.shape)  # [h,nb,kmax,blk]
    add_mask = torch.from_numpy(
        np.where(visible, 0.0, NEG_INF).astype(np.float32)).to(dev)
    add_mask = add_mask[None, :, :, None]  # [1, h, nb, 1, kmax, blk]
    if causal:
        cm = kpos[:, :, None] <= qpos[None, :, :, None, None]
        add_mask = add_mask + torch.from_numpy(
            np.where(cm, 0.0, NEG_INF).astype(np.float32)).to(dev)[None]
    scores = scores + add_mask

    kpos_t = torch.from_numpy(kpos).to(dev)           # [h, nb, kmax, blk]
    qpos_t = torch.from_numpy(qpos).to(dev)           # [nb, blk]
    if key_padding_mask is not None:
        kpm = key_padding_mask.float()                # [b, s]
        scores = scores + kpm[:, kpos_t][:, :, :, None]
    if attn_mask is not None:
        am = attn_mask.float()                        # [s, s]
        scores = scores + am[qpos_t[:, :, None, None], kpos_t[:, :, None]]
    if rpe is not None:
        rp = rpe.float()                              # [h, s, s]
        hh = torch.arange(h, device=dev)[:, None, None, None, None]
        scores = scores + rp[hh, qpos_t[None, :, :, None, None],
                             kpos_t[:, :, None]]

    # softmax over all active key elements (kmax*blk), fp32.  Rows with no
    # visible key (every entry at about NEG_INF: a fully masked query, as
    # a padding row) give zero output; the detection needs finite masks.
    flat = scores.reshape(b, h, nb, blk, kmax * blk)
    m = flat.amax(dim=-1, keepdim=True)
    all_masked = m <= NEG_INF * 0.5
    e = torch.exp(flat - torch.where(all_masked, 0.0, m).detach())
    e = torch.where(all_masked, 0.0, e)
    denom = e.sum(dim=-1, keepdim=True)
    probs = (e / denom.clamp_min(1e-20)).reshape(scores.shape)

    ctx = torch.einsum("bhnqkc,bhnkcd->bhnqd", probs.to(v.dtype), vg)
    return ctx.permute(0, 2, 3, 1, 4).reshape(b, s, h, d)
