"""Block-sparse flash attention: the Hopper kernels' wrappers, their plain
versions, the look-up-table builders and the autograd functions.

Port of ``deepspeed_tpu/ops/sparse_attention/flash_block_sparse.py``.
Kernels:

- B5a: the forward over the ACTIVE ``[blk, blk]`` tiles of a ``[H, nb,
  nb]`` layout (``H`` is 1 or the head count), out and the fp32
  logsumexp; replaces the TPU's work-list ``_fwd_kernel``.  fp32 runs
  the scalar kernel of ``csrc/sparse_attention/flash_block_sparse.cu``;
  bf16 and fp16 run B6a's tensor-core kernel at G = 1;
- B5b: dq, dk and dv over the same tiles, as a dq kernel in row-major
  order and a dk/dv kernel in key-major order over the transposed
  look-up table, launched together by one wrapper; replaces the TPU's
  ``_bwd_fused_kernel``, whose full-sequence dk/dv accumulators no Hopper
  block can hold.  fp32 runs the scalar kernels of the same source; bf16
  and fp16 run B6b's and B6c's tensor-core kernels at G = 1, where a
  super-tile
  is one layout block and the super-tile lse rule is B5's;
- B6a, B6b, B6c (``csrc/sparse_attention/flash_block_sparse_agg.cu``):
  the forward, the dq kernel and the dk/dv kernel over ``G×G``
  super-tiles of ``[G·blk, G·blk]`` with a ``G·G``-bit mask each
  (:func:`build_super_luts`); replace the TPU's ``_fwd_kernel_agg``,
  ``_bwd_dq_kernel_agg`` and ``_bwd_dkv_kernel_agg``, and count their
  launches separately, as the TPU backward is two calls.  In bf16 and
  fp16 all three run on the tensor cores (one template on the 16-bit
  type, as B1-B3) and launch their blocks in
  :func:`build_launch_order`'s order, the most tiles first (B6a in
  B6b's); fp32 keeps scalar kernels for the parity checks.

``q_agg`` resolves to the aggregation factor G exactly as in the JAX
package (:func:`_pick_q_agg`: "auto" takes super-tiles for layout blocks
of up to 128 rows, G = 4 at 128).  ``G == 1`` runs B5 and ``G > 1`` runs
B6, as the JAX package runs its work-list or its super-tile kernels; on
the card neither wrapper stands in for the other (the bf16 B5a and B5b
share B6's kernels, not their wrappers or counters).  The two
compute the same out and gradients; they differ only in the lse of a row
that sees no pair, which B6 gives as the TPU's super-tile kernels do
(MAX_FLOOR in a super-row with an active tile, NEG_INF in one without).

Each wrapper launches its kernel for CUDA tensors or raises, counts the
launch in ``.launches`` (an fp16 one again in ``.fp16.launches``), and
runs the plain version (:func:`flash_block_sparse_reference` and
:func:`flash_block_sparse_bwd_reference`, or their ``_agg`` forms, B6b's
and B6c's :func:`flash_block_sparse_agg_bwd_dq_reference` and
:func:`flash_block_sparse_agg_bwd_dkv_reference`) for CPU tensors; with
a flops profiler counting, a launch also adds its plain version's count
on the same inputs
(:func:`~deepspeed_tpu_torch.profiling.flops_profiler.kernel_launch`).  Layout is the JAX package's: q, k, v ``[b, s, h, d]``, read
through their strides, so views of a fused QKV projection go in as they
are.  lse is fp32 ``[b·h, s]`` (the TPU kernel's ``[b·h, 1, s]`` without
the singleton axis).  No dropout and no key mask inside, as on the TPU:
the gather path ``block_sparse.py`` is the general one.

The host tables (:func:`build_block_luts`, :func:`build_super_luts`) are
numpy and equal the JAX package's entry for entry; :func:`device_luts`
copies them to the device once per (layout, device), the super-tile
tables once per G as well, and the launch orders once per (G, block
rows, causal).  The JAX package's flattened work list feeds a
schedule this package does not have, and is not carried.
"""

import ctypes
import logging
import math
import types
import weakref

import numpy as np
import torch

from .. import op_builder
from ...profiling.flops_profiler.profiler import kernel_launch
from ..transformer.flash_attention import HEAD_DIMS, MAX_FLOOR, NEG_INF
from ..transformer.flash_attention import _check_cuda as _check_dense_cuda
from ..transformer.flash_attention import mma_aligned

logger = logging.getLogger(__name__)

# The types the B5 and B6 kernels take, and their codes in the C entries:
# fp32 the scalar kernels, bf16 and fp16 the tensor-core ones.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SHORT = {torch.bfloat16: "bf16", torch.float16: "fp16"}


def _check_cuda(q, k, v, kv_mask, extra=()):
    """The dense kernels' limits, and the sparse kernels' own types."""
    _check_dense_cuda(q, k, v, kv_mask, extra)
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the block-sparse flash kernels take float32, "
                         f"bfloat16 or float16, not {q.dtype}")


# -------------------------------------------------------------- host tables
def build_block_luts(layout):
    """Host-side look-up tables from a ``[H, nb, nb]`` 0/1 layout (or a
    sequence-parallel rank's ``[H, nb/N, nb]`` rows of one).

    Returns ``(lut, cnt, tlut, tcnt)``:
      - ``lut[h, qb, t]``: t-th active key block of query block qb
        (``cnt[h, qb]`` valid entries, zero-padded);
      - ``tlut[h, kb, t]``: t-th query block attending key block kb
        (``tcnt[h, kb]`` valid entries): the transposed layout, for dk/dv.
    """
    layout = np.asarray(layout) != 0
    h, nb, nbk = layout.shape
    kmax = max(1, int(layout.sum(-1).max()))
    qmax = max(1, int(layout.sum(-2).max()))
    lut = np.zeros((h, nb, kmax), np.int32)
    cnt = np.zeros((h, nb), np.int32)
    tlut = np.zeros((h, nbk, qmax), np.int32)
    tcnt = np.zeros((h, nbk), np.int32)
    for hi in range(h):
        for qb in range(nb):
            cols = np.nonzero(layout[hi, qb])[0]
            lut[hi, qb, :len(cols)] = cols
            cnt[hi, qb] = len(cols)
        for kb in range(nbk):
            rows = np.nonzero(layout[hi, :, kb])[0]
            tlut[hi, kb, :len(rows)] = rows
            tcnt[hi, kb] = len(rows)
    return lut, cnt, tlut, tcnt


def build_super_luts(layout, G):
    """Host-side tables of the ``G×G`` super-tiles of a ``[H, nb, nb]``
    layout: a super-tile covers a ``G×G`` patch of layout blocks, and its
    mask has bit ``row_g·G + col_g`` set where sub-block (row_g, col_g)
    is active.

    Returns ``(slut, scnt, smask, stlut, stcnt, stmask)``, int32:
      - ``slut[h, sq, t]``: t-th active super key column of super q-row
        ``sq`` (``scnt[h, sq]`` valid entries, zero-padded);
      - ``smask[h, sq, t]``: that super-tile's ``G·G`` bits;
      - ``stlut/stcnt/stmask``: the transpose, the active super q-rows of
        each super key column (for dk/dv), with the same bit convention.
    """
    layout = np.asarray(layout) != 0
    h, nb, nbk = layout.shape
    assert nb % G == 0 and nbk % G == 0 and G * G <= 32
    ns, nsk = nb // G, nbk // G
    patch = layout.reshape(h, ns, G, nsk, G)         # [h, sq, rg, sk, cg]
    active = patch.any(axis=(2, 4))                  # [h, ns, nsk]
    bitval = (1 << (np.arange(G)[:, None] * G
                    + np.arange(G)[None, :])).astype(np.int64)
    bits = (patch.transpose(0, 1, 3, 2, 4) * bitval).sum((-1, -2))
    tmax = max(1, int(active.sum(-1).max()))
    qmax = max(1, int(active.sum(-2).max()))
    slut = np.zeros((h, ns, tmax), np.int32)
    scnt = np.zeros((h, ns), np.int32)
    smask = np.zeros((h, ns, tmax), np.int32)
    stlut = np.zeros((h, nsk, qmax), np.int32)
    stcnt = np.zeros((h, nsk), np.int32)
    stmask = np.zeros((h, nsk, qmax), np.int32)
    for hi in range(h):
        for sq in range(ns):
            cols = np.nonzero(active[hi, sq])[0]
            slut[hi, sq, :len(cols)] = cols
            scnt[hi, sq] = len(cols)
            smask[hi, sq, :len(cols)] = bits[hi, sq, cols]
        for sk in range(nsk):
            rows = np.nonzero(active[hi, :, sk])[0]
            stlut[hi, sk, :len(rows)] = rows
            stcnt[hi, sk] = len(rows)
            stmask[hi, sk, :len(rows)] = bits[hi, rows, sk]
    return slut, scnt, smask, stlut, stcnt, stmask


MMA_TILE = 64   # rows (or keys) of a part and of a streamed tile, bf16 B6b/B6c


def super_tile_visits(layout, G, blk, causal, q_offset=0):
    """The 64-wide tiles the bf16 B6b and B6c visit, as a bool array
    ``[H, ns, ns, parts, parts]``: entry ``[h, sq, sk, p, j]`` is whether
    rows ``64p .. 64p+63`` of super q-row ``sq`` and keys ``64j ..
    64j+63`` of super key column ``sk`` (each cut at the super-tile's
    ``n = G·blk``) hold a visible pair, causal included.  B6b's block
    (sq, p) walks the tiles j of its active super-tiles that this marks,
    B6c's block (sk, j) the tiles p; a tile marked False is skipped, and
    a super-tile with no active sub-block has none marked.  A
    sequence-parallel rank's rows ``[H, nb/N, nb]`` of a layout count
    their causal pairs from their global row ``q_offset``."""
    active = np.asarray(layout) != 0
    H, nb, nbk = active.shape
    _check_factor(nb, G)
    _check_factor(nbk, G)
    ns, nsk, n = nb // G, nbk // G, G * blk
    parts = -(-n // MMA_TILE)
    # [H, sq, sk, rg, cg]: sub-block (rg, cg) of super-tile (sq, sk)
    bits = active.reshape(H, ns, G, nsk, G).transpose(0, 1, 3, 2, 4)
    lo = MMA_TILE * np.arange(parts)
    hi = np.minimum(lo + MMA_TILE, n) - 1
    g_lo = blk * np.arange(G)
    # [part, group]: the first and last row of the part inside the group
    first = np.maximum(lo[:, None], g_lo[None, :])
    last = np.minimum(hi[:, None], g_lo[None, :] + blk - 1)
    overlap = first <= last
    # [H, sq, sk, p, j, rg, cg]
    vis = (bits[:, :, :, None, None, :, :]
           & overlap[:, None, :, None] & overlap[None, :, None, :])
    if causal:
        # the part's last row in group rg at or past the tile's first key
        # in group cg: q_offset + (sq − sk)·n + last[p, rg] − first[j, cg]
        # >= 0
        step = q_offset + (np.arange(ns)[:, None]
                           - np.arange(nsk)[None, :]) * n
        vis &= (step[:, :, None, None, None, None]
                + last[:, None, :, None] - first[None, :, None, :]) >= 0
    return vis.any(axis=(-1, -2))


def build_launch_order(layout, G, blk, causal, q_offset=0):
    """The launch orders of the bf16 B6b and B6c: ``(dq_order,
    dkv_order)``, int32 permutations of the ``H·ns·parts`` units ``lh·
    ns·parts + tile·parts + part`` (a 64-row part of a super q-row for
    B6b, a 64-key part of a super key column for B6c), sorted by the
    number of 64-wide tiles the unit's block visits
    (:func:`super_tile_visits`), the most first, ties by unit.  The card
    starts blocks in grid order, so the longest start first and the
    short ones fill in behind them."""
    visits = super_tile_visits(layout, G, blk, causal, q_offset)
    dq_tiles = visits.sum(axis=(2, 4))     # [H, sq, p]
    dkv_tiles = visits.sum(axis=(1, 3))    # [H, sk, j]
    return tuple(np.argsort(-tiles.ravel(), kind="stable").astype(np.int32)
                 for tiles in (dq_tiles, dkv_tiles))


def _pick_q_agg(blk, nb, q_agg):
    """The JAX package's aggregation factor G for ``q_agg``: "never" is
    1; "auto" is 1 for blocks above 128 rows and grows super-tiles toward
    512 rows below that; an explicit factor is taken at any block size.
    G is clamped to the layout (``nb % G == 0``) and the 32-bit tile mask
    (``G <= 4``), with a warning when that changes an explicit factor."""
    if q_agg == "never":
        return 1
    if q_agg in ("auto", None):
        if blk > 128:
            return 1
        G = max(512 // blk, 1)
    else:
        G = int(q_agg)
    requested = G
    G = min(G, nb, 4)
    while G > 1 and nb % G != 0:
        G -= 1
    G = max(G, 1)
    if q_agg not in ("auto", None, "never") and G != requested:
        logger.warning(
            "flash_block_sparse_attention: explicit q_agg=%s clamped to "
            "G=%d (bounds: nb=%d divisibility, mask budget G<=4)",
            q_agg, G, nb)
    return G


# ------------------------------------------------------------ device tables
class _DeviceLuts:
    """One layout on one device: ``build_block_luts``' four tables for
    B5, ``build_super_luts``' six for B6 at each G asked for
    (:meth:`super_tables`), the bf16 B6b/B6c launch orders at each (G,
    block rows, causal) asked for (:meth:`launch_order`), and the
    ``[H, nb, nb]`` bool layout itself for the plain versions."""

    def __init__(self, layout, device):
        arrays = build_block_luts(layout)
        self.lut, self.cnt, self.tlut, self.tcnt = (
            torch.from_numpy(a).to(device) for a in arrays)
        self.active = torch.from_numpy(np.asarray(layout) != 0).to(device)
        self.layout_heads, self.nb, self.kmax = arrays[0].shape
        self.nbk = arrays[2].shape[1]
        self.qmax = arrays[2].shape[-1]
        self._layout = np.asarray(layout) != 0   # a copy: the cache holds
        self._device = device                    # no reference to the key
        self._super = {}
        self._orders = {}

    def super_tables(self, G):
        """The super-tile tables at factor ``G`` on this device, built
        and copied at the first call for that G."""
        tables = self._super.get(G)
        if tables is None:
            arrays = build_super_luts(self._layout, G)
            slut, scnt, smask, stlut, stcnt, stmask = (
                torch.from_numpy(a).to(self._device) for a in arrays)
            tables = self._super[G] = types.SimpleNamespace(
                slut=slut, scnt=scnt, smask=smask, stlut=stlut, stcnt=stcnt,
                stmask=stmask, ns=arrays[0].shape[1],
                tmax=arrays[0].shape[2], qmax=arrays[3].shape[2])
        return tables

    def launch_order(self, G, blk, causal, q_offset=0):
        """``(dq_order, dkv_order)`` of :func:`build_launch_order` on this
        device, built and copied at the first call for (G, blk, causal,
        q_offset): the tile counts depend on the block rows and the rows'
        global place as well as the layout."""
        key = (G, blk, bool(causal), int(q_offset) if causal else 0)
        orders = self._orders.get(key)
        if orders is None:
            orders = self._orders[key] = tuple(
                torch.from_numpy(a).to(self._device)
                for a in build_launch_order(self._layout, G, blk, causal,
                                            key[3]))
        return orders


# id(layout) -> (weak reference to the layout, {device: _DeviceLuts})
_lut_cache = {}


def device_luts(layout, device):
    """``layout``'s tables on ``device``, built and copied once per
    (layout array, device) and kept while the array lives, so that a
    training step copies nothing to the card and never waits for it.
    The cache goes by the array's identity: a layout is treated as
    immutable, and a caller that makes a new array per call pays the
    build and the copy per call."""
    device = torch.device(device)
    key = id(layout)
    entry = _lut_cache.get(key)
    if entry is None or entry[0]() is not layout:
        try:
            ref = weakref.ref(layout, lambda _, key=key:
                              _lut_cache.pop(key, None))
        except TypeError:  # not weak-referenceable (a list): no caching
            return _DeviceLuts(layout, device)
        entry = _lut_cache[key] = (ref, {})
    luts = entry[1].get(device)
    if luts is None:
        luts = entry[1][device] = _DeviceLuts(layout, device)
    return luts


# ----------------------------------------------------------- plain versions
def expand_layout(layout, s, causal, device, G=1, q_offset=0):
    """``(visible [H, s, kv_len], row_active [H, s])`` bool tensors: the
    element pairs inside active tiles (under the causal mask), and the
    query rows whose softmax state a kernel opens: for B5 (``G`` 1) the
    rows whose layout block has an active tile, for B6 the rows whose
    super-row of ``G`` layout blocks has one.  ``s`` is the query rows
    (``nb·blk`` of an ``[H, nb, nbk]`` layout, kv_len = ``nbk·blk``); a
    sequence-parallel rank's rows of a layout are the global rows from
    ``q_offset``, which the causal mask counts.  The layout comes from
    :func:`device_luts`, so a repeated call copies nothing to the
    device."""
    active = device_luts(layout, device).active
    H, nb, nbk = active.shape
    blk = s // nb
    visible = active.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
    if causal:
        rows = torch.arange(q_offset, q_offset + s, device=device)
        cols = torch.arange(nbk * blk, device=device)
        visible = visible & (rows[:, None] >= cols[None, :])
    row_active = active.reshape(H, nb // G, G * nbk).any(-1) \
        .repeat_interleave(G * blk, 1)
    return visible, row_active


def _masked_scores(q, k, visible):
    """Scaled fp32 ``[b, h, s, kv_len]`` scores, NEG_INF outside
    ``visible``."""
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    return torch.where(visible[None], sc, NEG_INF)


def _reference(q, k, v, layout, causal, G, q_offset=0):
    b, s, h, _ = q.shape
    visible, row_active = expand_layout(layout, s, causal, q.device, G,
                                        q_offset)
    sc = _masked_scores(q, k, visible)
    m = sc.amax(dim=-1, keepdim=True).clamp_min(MAX_FLOOR)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l_safe.permute(0, 2, 1, 3)
    lse = torch.where(row_active[None], (m + torch.log(l_safe))[..., 0],
                      NEG_INF)
    return out.to(q.dtype), lse.expand(b, h, s).reshape(b * h, s)


def flash_block_sparse_reference(q, k, v, layout, causal=False, q_offset=0):
    """Dense plain-PyTorch version of B5a with its exact rules: scores in
    fp32, NEG_INF outside the active tiles and above the diagonal under
    ``causal``, the row max floored at MAX_FLOOR (so a tile the causal
    mask empties adds exp(NEG_INF − m) = 0), l == 0 dividing by 1, P
    cast to the storage dtype before the fp32-accumulated P·V.  A query
    block with no active tile gives out = 0 and lse = NEG_INF (the
    kernel's untouched running max).  O(s²) memory.  A
    sequence-parallel rank's rows ``[H, nb/N, nb]`` of a layout take its
    chunk of q against the gathered k and v, its rows counted from the
    global row ``q_offset``.  Returns ``(out [b, s, h, d], lse [b·h,
    s])``."""
    return _reference(q, k, v, layout, causal, 1, q_offset)


def flash_block_sparse_agg_reference(q, k, v, layout, G, causal=False,
                                     q_offset=0):
    """Dense plain-PyTorch version of B6a, what the TPU's
    ``_fbs_attention_agg`` computes at aggregation factor ``G``: B5a's
    rules, except for the lse of a row that sees no pair.  The TPU's
    super-tile kernel floors the running max of every row of a super-row
    that has an active super-tile, so such a row has lse = MAX_FLOOR
    even where its own layout block has no active tile; only the rows of
    a super-row with none keep NEG_INF.  Out is 0 for both.  ``q_offset``
    as for :func:`flash_block_sparse_reference`."""
    return _reference(q, k, v, layout, causal, G, q_offset)


def _sparse_bwd_scores(q, k, v, out, lse, dout, layout, causal, q_offset):
    """B5b's shared terms: P (0 outside the visible pairs) and dS in the
    storage dtype, as fp32 ``[b, h, s, kv_len]``."""
    b, s, h, d = q.shape
    visible, _ = expand_layout(layout, s, causal, q.device, 1, q_offset)
    # outside the active tiles P is 0 whatever lse holds (a row with no
    # active tile has lse = NEG_INF, and NEG_INF − NEG_INF is 0)
    p = torch.where(visible[None],
                    torch.exp(_masked_scores(q, k, visible)
                              - lse.view(b, h, s, 1)), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = (p * (dp - delta)).to(q.dtype).float()
    return p, ds


def _sparse_dq(q, k, ds):
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
            * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)


def _sparse_dkv(q, k, v, dout, p, ds):
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_block_sparse_bwd_reference(q, k, v, out, lse, dout, layout,
                                     causal=False, q_offset=0):
    """Dense plain-PyTorch version of B5b: P = exp(S − lse) over the
    visible pairs of active tiles, dP = dO·Vᵀ, Δ = rowsum(dO∘O), dS =
    P∘(dP − Δ) in the storage dtype, dq = dS·K/√d, dk = dSᵀ·Q/√d, dv =
    Pᵀ·dO with P in the storage dtype; ``q_offset`` as for
    :func:`flash_block_sparse_reference` (dk and dv are then the chunk's
    partials).  Returns ``(dq, dk, dv)`` in the input dtype."""
    p, ds = _sparse_bwd_scores(q, k, v, out, lse, dout, layout, causal,
                               q_offset)
    return (_sparse_dq(q, k, ds),) + _sparse_dkv(q, k, v, dout, p, ds)


def flash_block_sparse_agg_bwd_reference(q, k, v, out, lse, dout, layout,
                                         G, causal=False, q_offset=0):
    """Dense plain-PyTorch version of B6b (dq) and B6c (dk, dv), what
    the TPU's ``_fbs_bwd_agg`` computes: B5b's arithmetic, since P is 0
    outside the visible pairs whatever lse a pairless row holds, so the
    factor ``G`` changes no gradient.  Returns ``(dq, dk, dv)``."""
    _check_factor(np.asarray(layout).shape[1], G)
    return flash_block_sparse_bwd_reference(q, k, v, out, lse, dout, layout,
                                            causal, q_offset)


def flash_block_sparse_agg_bwd_dq_reference(q, k, v, out, lse, dout, layout,
                                            G, causal=False, q_offset=0):
    """Plain version of B6b: dq of
    :func:`flash_block_sparse_agg_bwd_reference`, bitwise, from its own
    score pass (as B6b recomputes P and dP)."""
    _check_factor(np.asarray(layout).shape[1], G)
    _, ds = _sparse_bwd_scores(q, k, v, out, lse, dout, layout, causal,
                               q_offset)
    return _sparse_dq(q, k, ds)


def flash_block_sparse_agg_bwd_dkv_reference(q, k, v, out, lse, dout,
                                             layout, G, causal=False,
                                             q_offset=0):
    """Plain version of B6c: ``(dk, dv)`` of
    :func:`flash_block_sparse_agg_bwd_reference`, bitwise, from its own
    score pass."""
    _check_factor(np.asarray(layout).shape[1], G)
    p, ds = _sparse_bwd_scores(q, k, v, out, lse, dout, layout, causal,
                               q_offset)
    return _sparse_dkv(q, k, v, dout, p, ds)


# ----------------------------------------------------------------- kernels
def _kernels():
    lib = op_builder.load("flash_block_sparse")
    fwd, bwd = lib.ds_flash_block_sparse_fwd, lib.ds_flash_block_sparse_bwd
    if fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_int64)
        # ... strides, scale, causal, kv_len, q_off, stream
        fwd.argtypes = ([i32, i32] + [ptr] * 7 + [i32] * 6
                        + [strides, ctypes.c_float, i32, i32, i32, ptr])
        bwd.argtypes = ([i32, i32] + [ptr] * 13 + [i32] * 7
                        + [strides, ctypes.c_float, i32, i32, i32, ptr])
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


_P, _I = ctypes.c_void_p, ctypes.c_int
# ds_fbs_agg_fwd / _bwd_dq / _bwd_dkv: dtype, head_dim, their pointers,
# batch, heads, s, ns, layout heads, G, width, strides, scale, causal,
# (B6c: kv_len,) q_off, stream
_AGG_TAIL = [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, _I]
AGG_ARGTYPES = tuple([_I, _I] + [_P] * n + [_I] * 7 + _AGG_TAIL + extra
                     for n, extra in ((9, [_I, _P]), (11, [_I, _P]),
                                      (12, [_I, _I, _P])))


def _agg_kernels(dtype):
    """The super-tile kernels' entries for ``dtype``: fp16's are built as
    a library of their own from the same source (``op_builder.DEFINES``)."""
    lib = op_builder.load("flash_block_sparse_agg_fp16"
                          if dtype == torch.float16
                          else "flash_block_sparse_agg")
    fwd, dq, dkv = (lib.ds_fbs_agg_fwd, lib.ds_fbs_agg_bwd_dq,
                    lib.ds_fbs_agg_bwd_dkv)
    if fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes, dq.argtypes, dkv.argtypes = AGG_ARGTYPES
        fwd.restype = dq.restype = dkv.restype = ctypes.c_int
    return fwd, dq, dkv


def _check(q, k, v, layout, q_offset=0):
    """Shapes and the layout, for any device; returns the layout as a
    numpy array (the caller's own array when it already is one).  Self
    attention takes an ``[H, nb, nb]`` layout and q, k, v of one length;
    a sequence-parallel rank's chunk takes its ``[H, nb/N, nb]`` rows of
    one, its q rows against the gathered k and v, from the global row
    ``q_offset`` (a multiple of the block)."""
    if q.dim() != 4:
        raise ValueError("block-sparse flash attention takes [b, s, h, d] "
                         "q, k, v")
    b, s, h, d = q.shape
    kv_len = k.shape[1] if k.dim() == 4 else -1
    if k.shape != (b, kv_len, h, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be [b, kv_len, h, d] matching q "
                         f"{tuple(q.shape)} (self-attention, or a chunk's "
                         f"rows against the gathered keys); got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not isinstance(layout, np.ndarray):
        layout = np.asarray(layout)
    if layout.ndim != 3:
        raise ValueError(f"layout must be [H, nb, nb], got {layout.shape}")
    nb, nbk = layout.shape[1:]
    if s % nb != 0:
        raise ValueError(f"seq {s} not divisible into {nb} blocks")
    blk = s // nb
    if nbk * blk != kv_len or q_offset < 0 or q_offset % blk \
            or (nbk == nb and q_offset):
        raise ValueError(f"a layout of {nb} x {nbk} blocks of {blk} takes "
                         f"{nbk * blk} keys (self-attention at {nb} x {nb}) "
                         f"and a block-aligned q_offset; got {kv_len} keys, "
                         f"q_offset {q_offset}")
    if layout.shape[0] not in (1, h):
        raise ValueError(f"layout heads {layout.shape[0]} incompatible "
                         f"with {h} heads")
    return layout


def _check_factor(nb, G):
    """The super-tile factors the TPU's tables take: G divides the
    layout's nb blocks and a tile's G·G bits fit 32."""
    if not (isinstance(G, int) and G >= 1 and nb % G == 0 and G * G <= 32):
        raise ValueError(f"aggregation factor G={G!r} must be an int >= 1 "
                         f"dividing the layout's {nb} blocks, with G*G <= 32")


def _check_bwd(q, out, lse, dout):
    """The backward's own inputs; returns ``(dout, lse)`` in the forms
    the kernels read (dO in q's dtype, last dim contiguous on the card;
    lse contiguous)."""
    b, s, h, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dO must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if tuple(lse.shape) != (b * h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [b·h, s]={(b * h, s)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if dout.dtype != q.dtype:
        dout = dout.to(q.dtype)
    if q.device.type != "cpu":
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        lse = lse.contiguous()
    return dout, lse


def _delta(out, dout):
    """Δ = rowsum(dO∘O) as fp32 ``[b·h, s]``, computed outside the
    kernels as the JAX package computes it outside Pallas."""
    b, s, h, _ = out.shape
    return (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .reshape(b * h, s).contiguous()


def _launched(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _count_launch(wrapper, dtype):
    """One more launch of ``wrapper``'s kernel, an fp16 one counted again
    under ``wrapper.fp16``; called only after the launch succeeded."""
    wrapper.launches += 1
    if dtype == torch.float16:
        wrapper.fp16.launches += 1


def kernel_takes(q):
    """Whether the B5 and B6 kernels take tensors like ``q`` ``[b, s, h,
    d]``: on the card, fp32, bf16 or fp16, head_dim 64 or 128."""
    return (q.is_cuda and q.dtype in _DTYPE_CODES
            and q.shape[-1] in HEAD_DIMS)


def flash_block_sparse_fwd(q, k, v, layout, causal=False, q_offset=0):
    """Block-sparse flash forward (B5a); returns ``(out, lse)``.

    CPU tensors take :func:`flash_block_sparse_reference`.  CUDA tensors
    launch a Hopper kernel (head_dim 64 or 128) or raise: bf16 and fp16
    the tensor-core super-tile forward at G = 1 (a super-tile is one layout
    block, whose lse rule is B5's) in :func:`build_launch_order`'s dq
    order, with a ValueError naming B5a on views ``mma_aligned`` refuses;
    fp32 the scalar kernel of ``flash_block_sparse.cu``.  A
    sequence-parallel rank's chunk passes its rows of the layout, its q
    against the gathered k and v, and its first global row ``q_offset``.
    Every launch adds one to ``flash_block_sparse_fwd.launches`` and
    moves no B6 counter."""
    layout = _check(q, k, v, layout, q_offset)
    if q.device.type == "cpu":
        return flash_block_sparse_reference(q, k, v, layout, causal,
                                            q_offset)
    _check_cuda(q, k, v, None)
    if q.dtype != torch.float32:
        _mma_views("B5a", q, k, v)
        out, lse = _agg_fwd(q, k, v, layout, 1, causal,
                            "flash_block_sparse_fwd", q_offset)
        _count_launch(flash_block_sparse_fwd, q.dtype)
        kernel_launch("B5a", flash_block_sparse_reference, q, k, v, layout,
                      causal, q_offset)
        return out, lse
    b, s, h, d = q.shape
    luts = device_luts(layout, q.device)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    fwd, _ = _kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fwd(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 luts.lut.data_ptr(), luts.cnt.data_ptr(), b, h, s, luts.nb,
                 luts.layout_heads, luts.kmax, strides, 1.0 / math.sqrt(d),
                 int(bool(causal)), k.shape[1], int(q_offset), stream)
    _launched(rc, "flash_block_sparse_fwd")
    _count_launch(flash_block_sparse_fwd, q.dtype)
    kernel_launch("B5a", flash_block_sparse_reference, q, k, v, layout,
                  causal, q_offset)
    return out, lse


def flash_block_sparse_bwd(q, k, v, out, lse, dout, layout, causal=False,
                           q_offset=0):
    """Block-sparse flash backward (B5b): ``(dq, dk, dv)`` from the
    forward's out and lse.

    CPU tensors take :func:`flash_block_sparse_bwd_reference`.  CUDA
    tensors launch a dq kernel and a dk/dv kernel (one launch of B5b:
    ``flash_block_sparse_bwd.launches`` goes up by one, and no B6 counter
    moves) or raise.  bf16 and fp16 run on the tensor cores through the
    super-tile kernels at G = 1 (a super-tile is one layout block, whose
    lse rule is B5's), in :func:`build_launch_order`'s order, with a
    ValueError naming B5b on views ``mma_aligned`` refuses; fp32 runs the
    scalar kernels of ``flash_block_sparse.cu``.  ``q_offset`` as for
    :func:`flash_block_sparse_fwd` (dk and dv ``[b, kv_len, h, d]`` are
    then the chunk's partials).  No atomics: two runs give bitwise-equal
    gradients."""
    layout = _check(q, k, v, layout, q_offset)
    dout, lse = _check_bwd(q, out, lse, dout)
    if q.device.type == "cpu":
        return flash_block_sparse_bwd_reference(q, k, v, out, lse, dout,
                                                layout, causal, q_offset)
    _check_cuda(q, k, v, None, extra=(dout, out))
    if q.dtype != torch.float32:
        _mma_views("B5b", q, k, v, dout)
        delta = _delta(out, dout)
        name = "flash_block_sparse_bwd"
        dq = _agg_dq(q, k, v, lse, dout, delta, layout, 1, causal, name,
                     q_offset)
        dk, dv = _agg_dkv(q, k, v, lse, dout, delta, layout, 1, causal,
                          name, q_offset)
        _count_launch(flash_block_sparse_bwd, q.dtype)
        kernel_launch("B5b", flash_block_sparse_bwd_reference, q, k, v, out,
                      lse, dout, layout, causal, q_offset)
        return dq, dk, dv
    b, s, h, d = q.shape
    luts = device_luts(layout, q.device)
    delta = _delta(out, dout)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], *dq.stride()[:3], *dk.stride()[:3])
    _, bwd = _kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = bwd(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), luts.lut.data_ptr(), luts.cnt.data_ptr(),
                 luts.tlut.data_ptr(), luts.tcnt.data_ptr(), b, h, s,
                 luts.nb, luts.layout_heads, luts.kmax, luts.qmax, strides,
                 1.0 / math.sqrt(d), int(bool(causal)), k.shape[1],
                 int(q_offset), stream)
    _launched(rc, "flash_block_sparse_bwd")
    _count_launch(flash_block_sparse_bwd, q.dtype)
    kernel_launch("B5b", flash_block_sparse_bwd_reference, q, k, v, out, lse,
                  dout, layout, causal, q_offset)
    return dq, dk, dv


class FlashBlockSparse(torch.autograd.Function):
    """``FlashBlockSparse.apply(q, k, v, layout, causal)`` -> out
    ``[b, s, h, d]``.  The forward runs B5a and saves q, k, v, out and
    lse; the backward runs B5b.  The layout (a numpy array) gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, layout, causal=False):
        out, lse = flash_block_sparse_fwd(q, k, v, layout, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.layout = layout
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_block_sparse_bwd(q, k, v, out, lse, dout,
                                            ctx.layout, ctx.causal)
        return dq, dk, dv, None, None


# ------------------------------------------------------ super-tile kernels
def _agg_setup(q, k, v, layout, G, q_offset=0):
    """The checks every super-tile wrapper makes; returns the layout as
    a numpy array."""
    layout = _check(q, k, v, layout, q_offset)
    _check_factor(layout.shape[1], G)
    _check_factor(layout.shape[2], G)
    if q_offset % (G * (q.shape[1] // layout.shape[1])):
        raise ValueError(f"q_offset {q_offset} is not on a super-row of "
                         f"{G} blocks")
    return layout


def _agg_common(q, tables, G):
    """The arguments the three super-tile kernels share after their
    tensors: batch, heads, s, super-rows, layout heads, G."""
    b, s, h, _ = q.shape
    return b, h, s, tables.ns, tables.slut.shape[0], G


def _mma_views(name, q, k, v, dout=None):
    """The 16-bit tensor-core kernels (B5a, B5b, B6a, B6b, B6c) copy q, k, v
    (and dO) in 16-byte ``cp.async`` chunks: a ValueError naming the
    kernel where ``mma_aligned`` refuses the views (nothing is copied or
    sent elsewhere)."""
    tensors = (q, k, v) if dout is None else (q, k, v, dout)
    if q.dtype != torch.float32 and not mma_aligned(*tensors):
        names = "q, k and v" if dout is None else "q, k, v and dO"
        raise ValueError(
            f"the {_SHORT[q.dtype]} {name} kernel needs {names} 16-byte "
            f"aligned with batch, seq and head strides that are multiples "
            f"of 8 elements; got strides {[t.stride() for t in tensors]}")


def _agg_order(layout, q, G, causal, q_offset=0):
    """The launch orders for ``q``'s block rows on ``q``'s device
    (``layout`` as :func:`_agg_setup` returns it)."""
    return device_luts(layout, q.device).launch_order(
        G, q.shape[1] // layout.shape[1], causal, q_offset)


def _agg_fwd(q, k, v, layout, G, causal, name, q_offset=0):
    """Launches the super-tile forward kernel at factor ``G`` (B6a's, and
    the bf16 B5a's at G = 1) on checked CUDA tensors, in B6b's launch
    order (the two visit the same tiles); returns ``(out, lse)``.  Counts
    nothing: the caller's wrapper does."""
    b, s, h, d = q.shape
    st = device_luts(layout, q.device).super_tables(G)
    order = _agg_order(layout, q, G, causal, q_offset)[0]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    fwd, _, _ = _agg_kernels(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fwd(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 st.slut.data_ptr(), st.scnt.data_ptr(), st.smask.data_ptr(),
                 order.data_ptr(), *_agg_common(q, st, G), st.tmax,
                 strides, 1.0 / math.sqrt(d), int(bool(causal)),
                 int(q_offset), stream)
    _launched(rc, name)
    return out, lse


def flash_block_sparse_agg_fwd(q, k, v, layout, G, causal=False,
                               q_offset=0):
    """Super-tile flash forward (B6a) at aggregation factor ``G``;
    returns ``(out, lse)``.

    CPU tensors take :func:`flash_block_sparse_agg_reference`.  CUDA
    tensors launch the Hopper kernel (head_dim 64 or 128) or raise: bf16
    and fp16 the tensor-core kernel in B6b's launch order
    (:func:`build_launch_order`; the two visit the same tiles), with a ValueError naming B6a on views
    ``mma_aligned`` refuses; fp32 the scalar one.  ``q_offset`` as for
    :func:`flash_block_sparse_fwd`, on a super-row.  Every launch adds
    one to ``flash_block_sparse_agg_fwd.launches``."""
    layout = _agg_setup(q, k, v, layout, G, q_offset)
    if q.device.type == "cpu":
        return flash_block_sparse_agg_reference(q, k, v, layout, G, causal,
                                                q_offset)
    _check_cuda(q, k, v, None)
    _mma_views("B6a", q, k, v)
    out, lse = _agg_fwd(q, k, v, layout, G, causal,
                        "flash_block_sparse_agg_fwd", q_offset)
    _count_launch(flash_block_sparse_agg_fwd, q.dtype)
    kernel_launch("B6a", flash_block_sparse_agg_reference, q, k, v, layout,
                  G, causal, q_offset)
    return out, lse


def _agg_bwd_strides(q, k, v, dout, grad):
    return (ctypes.c_int64 * 15)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], *grad.stride()[:3])


def _agg_dq(q, k, v, lse, dout, delta, layout, G, causal, name, q_offset=0):
    """Launches the super-tile dq kernel at factor ``G`` (B6b's, and the
    bf16 B5b's at G = 1) on checked CUDA tensors; returns dq.  Counts
    nothing: the caller's wrapper does."""
    d = q.shape[-1]
    st = device_luts(layout, q.device).super_tables(G)
    order = _agg_order(layout, q, G, causal, q_offset)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _, fn, _ = _agg_kernels(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), st.slut.data_ptr(),
                st.scnt.data_ptr(), st.smask.data_ptr(), order.data_ptr(),
                *_agg_common(q, st, G), st.tmax,
                _agg_bwd_strides(q, k, v, dout, dq), 1.0 / math.sqrt(d),
                int(bool(causal)), int(q_offset), stream)
    _launched(rc, name)
    return dq


def _agg_dkv(q, k, v, lse, dout, delta, layout, G, causal, name,
             q_offset=0):
    """Launches the super-tile dk/dv kernel at factor ``G`` (B6c's, and
    the bf16 B5b's at G = 1) over the transposed tables; returns
    ``(dk, dv)``, each ``[b, kv_len, h, d]``.  Counts nothing."""
    d = q.shape[-1]
    st = device_luts(layout, q.device).super_tables(G)
    order = _agg_order(layout, q, G, causal, q_offset)[1]
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    _, _, fn = _agg_kernels(q.dtype)
    b, s, h, _ = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                st.stlut.data_ptr(), st.stcnt.data_ptr(),
                st.stmask.data_ptr(), order.data_ptr(), b, h, s,
                st.stcnt.shape[1], st.slut.shape[0], G, st.qmax,
                _agg_bwd_strides(q, k, v, dout, dk), 1.0 / math.sqrt(d),
                int(bool(causal)), k.shape[1], int(q_offset), stream)
    _launched(rc, name)
    return dk, dv


def flash_block_sparse_agg_bwd_dq(q, k, v, out, lse, dout, layout, G,
                                  causal=False, delta=None, q_offset=0):
    """Super-tile dq (B6b) from the forward's out and lse; ``delta``,
    Δ as fp32 ``[b·h, s]``, is computed when not given.

    CPU tensors take :func:`flash_block_sparse_agg_bwd_reference`.  CUDA
    tensors launch the Hopper kernel or raise: bf16 and fp16 the
    tensor-core kernel in :func:`build_launch_order`'s order (and a
    ValueError naming B6b on views ``mma_aligned`` refuses), fp32 the
    scalar one.  ``q_offset`` as for :func:`flash_block_sparse_agg_fwd`.
    Every launch adds one to ``flash_block_sparse_agg_bwd_dq.launches``."""
    layout = _agg_setup(q, k, v, layout, G, q_offset)
    dout, lse = _check_bwd(q, out, lse, dout)
    if q.device.type == "cpu":
        return flash_block_sparse_agg_bwd_dq_reference(
            q, k, v, out, lse, dout, layout, G, causal, q_offset)
    _check_cuda(q, k, v, None, extra=(dout, out))
    _mma_views("B6b", q, k, v, dout)
    delta = _delta(out, dout) if delta is None else delta
    dq = _agg_dq(q, k, v, lse, dout, delta, layout, G, causal,
                 "flash_block_sparse_agg_bwd_dq", q_offset)
    _count_launch(flash_block_sparse_agg_bwd_dq, q.dtype)
    kernel_launch("B6b", flash_block_sparse_agg_bwd_dq_reference, q, k, v,
                  out, lse, dout, layout, G, causal, q_offset)
    return dq


def flash_block_sparse_agg_bwd_dkv(q, k, v, out, lse, dout, layout, G,
                                   causal=False, delta=None, q_offset=0):
    """Super-tile dk and dv (B6c) over the transposed super-tile table;
    returns ``(dk, dv)``.  As :func:`flash_block_sparse_agg_bwd_dq` (the
    ValueError names B6c), with ``flash_block_sparse_agg_bwd_dkv.launches``."""
    layout = _agg_setup(q, k, v, layout, G, q_offset)
    dout, lse = _check_bwd(q, out, lse, dout)
    if q.device.type == "cpu":
        return flash_block_sparse_agg_bwd_dkv_reference(
            q, k, v, out, lse, dout, layout, G, causal, q_offset)
    _check_cuda(q, k, v, None, extra=(dout, out))
    _mma_views("B6c", q, k, v, dout)
    delta = _delta(out, dout) if delta is None else delta
    dk, dv = _agg_dkv(q, k, v, lse, dout, delta, layout, G, causal,
                      "flash_block_sparse_agg_bwd_dkv", q_offset)
    _count_launch(flash_block_sparse_agg_bwd_dkv, q.dtype)
    kernel_launch("B6c", flash_block_sparse_agg_bwd_dkv_reference, q, k, v,
                  out, lse, dout, layout, G, causal, q_offset)
    return dk, dv


for _wrapper in (flash_block_sparse_fwd, flash_block_sparse_bwd,
                 flash_block_sparse_agg_fwd, flash_block_sparse_agg_bwd_dq,
                 flash_block_sparse_agg_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.fp16 = types.SimpleNamespace(launches=0)


def flash_block_sparse_agg_bwd(q, k, v, out, lse, dout, layout, G,
                               causal=False, q_offset=0):
    """``(dq, dk, dv)`` by B6b then B6c, with Δ computed once for both;
    the plain version once for CPU tensors."""
    layout = _agg_setup(q, k, v, layout, G, q_offset)
    dout, lse = _check_bwd(q, out, lse, dout)
    if q.device.type == "cpu":
        return flash_block_sparse_agg_bwd_reference(q, k, v, out, lse, dout,
                                                    layout, G, causal,
                                                    q_offset)
    delta = _delta(out, dout)
    dq = flash_block_sparse_agg_bwd_dq(q, k, v, out, lse, dout, layout, G,
                                       causal, delta, q_offset)
    return (dq,) + flash_block_sparse_agg_bwd_dkv(q, k, v, out, lse, dout,
                                                  layout, G, causal, delta,
                                                  q_offset)


class FlashBlockSparseAgg(torch.autograd.Function):
    """``FlashBlockSparseAgg.apply(q, k, v, layout, G, causal)`` -> out
    ``[b, s, h, d]``: B6a forward, B6b and B6c backward.  The layout and
    G get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, layout, G, causal=False):
        out, lse = flash_block_sparse_agg_fwd(q, k, v, layout, G, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.layout, ctx.G, ctx.causal = layout, G, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_block_sparse_agg_bwd(q, k, v, out, lse, dout,
                                                ctx.layout, ctx.G,
                                                ctx.causal)
        return dq, dk, dv, None, None, None


def sparse_factor(layout, s, q_agg="auto"):
    """The aggregation factor G of a ``[H, nb, nb]`` layout over a
    length-``s`` sequence, as :func:`flash_block_sparse_attention`
    resolves ``q_agg`` (the JAX package's rule)."""
    nb = np.asarray(layout).shape[1]
    return _pick_q_agg(s // nb, nb, q_agg)


def flash_block_sparse_attention(q, k, v, layout, causal=False,
                                 q_agg="auto"):
    """Block-sparse flash attention on ``[b, s, h, d]`` inputs,
    differentiable.

    ``layout`` is the ``[H, nb, nb]`` 0/1 block layout (H == heads, or 1
    for a shared layout) of ``sparsity_config.make_layout``; pass the same
    array every call and its device tables are built once.  ``q_agg``
    ("auto", "never" or an explicit factor) resolves to G as in the JAX
    package.  ``G == 1`` runs the B5 kernels on bare ``[blk, blk]``
    tiles, ``G > 1`` the B6 kernels on G×G super-tiles; on the card a
    call launches the kernels it resolves to or raises."""
    layout = _check(q, k, v, layout)
    G = sparse_factor(layout, q.shape[1], q_agg)
    if G > 1:
        return FlashBlockSparseAgg.apply(q, k, v, layout, G, bool(causal))
    return FlashBlockSparse.apply(q, k, v, layout, bool(causal))
