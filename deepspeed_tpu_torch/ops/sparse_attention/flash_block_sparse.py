"""Block-sparse flash attention: the Hopper kernels' wrappers, their plain
versions, the look-up-table builders and the autograd function.

Port of ``deepspeed_tpu/ops/sparse_attention/flash_block_sparse.py``.
Kernels (``csrc/sparse_attention/flash_block_sparse.cu``):

- B5a: the forward over the ACTIVE ``[blk, blk]`` tiles of a
  ``[H, nb, nb]`` layout (``H`` is 1 or the head count), out and the fp32
  logsumexp; replaces the TPU's work-list ``_fwd_kernel``;
- B5b: dq, dk and dv over the same tiles, as a dq kernel in row-major
  order and a dk/dv kernel in key-major order over the transposed
  look-up table, launched together by one wrapper; replaces the TPU's
  ``_bwd_fused_kernel``, whose full-sequence dk/dv accumulators no Hopper
  block can hold.

The TPU's G×G super-tile kernels (B6: ``_fwd_kernel_agg``,
``_bwd_dq_kernel_agg``, ``_bwd_dkv_kernel_agg``) are not ported yet.
``q_agg`` resolves to the aggregation factor G exactly as in the JAX
package (:func:`_pick_q_agg`: "auto" takes super-tiles for layout blocks
of up to 128 rows), and a call that resolves to ``G > 1`` raises, naming
them: B5 runs only where the JAX package runs its work-list kernels,
that is for blocks above 128 rows, for ``q_agg="never"``, and where the
layout admits no factor above 1.

Each wrapper launches its kernel for CUDA tensors or raises, and runs the
plain version (:func:`flash_block_sparse_reference`,
:func:`flash_block_sparse_bwd_reference`) for CPU tensors.  Layout is the
JAX package's: q, k, v ``[b, s, h, d]``, read through their strides, so
views of a fused QKV projection go in as they are.  lse is fp32
``[b·h, s]`` (the TPU kernel's ``[b·h, 1, s]`` without the singleton
axis).  No dropout and no key mask inside, as on the TPU: the gather path
``block_sparse.py`` is the general one.

The host tables (:func:`build_block_luts`) are numpy and equal the JAX
package's entry for entry; the kernels read its four arrays, copied to
the device once per (layout, device) by :func:`device_luts`.  The JAX
package's flattened work list and super-tile tables feed schedules that
this package does not have, and are not carried.
"""

import ctypes
import logging
import math
import weakref

import numpy as np
import torch

from .. import op_builder
from ..transformer.flash_attention import (_DTYPE_CODES, HEAD_DIMS,
                                           MAX_FLOOR, NEG_INF, _check_cuda)

logger = logging.getLogger(__name__)


# -------------------------------------------------------------- host tables
def build_block_luts(layout):
    """Host-side look-up tables from a ``[H, nb, nb]`` 0/1 layout.

    Returns ``(lut, cnt, tlut, tcnt)``:
      - ``lut[h, qb, t]``: t-th active key block of query block qb
        (``cnt[h, qb]`` valid entries, zero-padded);
      - ``tlut[h, kb, t]``: t-th query block attending key block kb
        (``tcnt[h, kb]`` valid entries): the transposed layout, for dk/dv.
    """
    layout = np.asarray(layout) != 0
    h, nb, nb2 = layout.shape
    assert nb == nb2, f"layout must be square, got {layout.shape}"
    kmax = max(1, int(layout.sum(-1).max()))
    qmax = max(1, int(layout.sum(-2).max()))
    lut = np.zeros((h, nb, kmax), np.int32)
    cnt = np.zeros((h, nb), np.int32)
    tlut = np.zeros((h, nb, qmax), np.int32)
    tcnt = np.zeros((h, nb), np.int32)
    for hi in range(h):
        for qb in range(nb):
            cols = np.nonzero(layout[hi, qb])[0]
            lut[hi, qb, :len(cols)] = cols
            cnt[hi, qb] = len(cols)
        for kb in range(nb):
            rows = np.nonzero(layout[hi, :, kb])[0]
            tlut[hi, kb, :len(rows)] = rows
            tcnt[hi, kb] = len(rows)
    return lut, cnt, tlut, tcnt


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
    the kernels, and the ``[H, nb, nb]`` bool layout itself for the plain
    versions."""

    def __init__(self, layout, device):
        arrays = build_block_luts(layout)
        self.lut, self.cnt, self.tlut, self.tcnt = (
            torch.from_numpy(a).to(device) for a in arrays)
        self.active = torch.from_numpy(np.asarray(layout) != 0).to(device)
        self.layout_heads, self.nb, self.kmax = arrays[0].shape
        self.qmax = arrays[2].shape[-1]


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
def expand_layout(layout, s, causal, device):
    """``(visible [H, s, s], row_active [H, s])`` bool tensors: the
    element pairs inside active tiles (under the causal mask), and the
    query rows whose layout block has any active tile.  The layout
    comes from :func:`device_luts`, so a repeated call copies nothing to
    the device."""
    active = device_luts(layout, device).active
    nb = active.shape[1]
    blk = s // nb
    visible = active.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
    if causal:
        pos = torch.arange(s, device=device)
        visible = visible & (pos[:, None] >= pos[None, :])
    row_active = active.any(-1).repeat_interleave(blk, 1)
    return visible, row_active


def _masked_scores(q, k, visible):
    """Scaled fp32 ``[b, h, s, s]`` scores, NEG_INF outside ``visible``."""
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    return torch.where(visible[None], sc, NEG_INF)


def flash_block_sparse_reference(q, k, v, layout, causal=False):
    """Dense plain-PyTorch version of B5a with its exact rules: scores in
    fp32, NEG_INF outside the active tiles and above the diagonal under
    ``causal``, the row max floored at MAX_FLOOR (so a tile the causal
    mask empties adds exp(NEG_INF − m) = 0), l == 0 dividing by 1, P
    cast to the storage dtype before the fp32-accumulated P·V.  A query
    block with no active tile gives out = 0 and lse = NEG_INF (the
    kernel's untouched running max).  O(s²) memory.  Returns
    ``(out [b, s, h, d], lse [b·h, s])``."""
    b, s, h, _ = q.shape
    visible, row_active = expand_layout(layout, s, causal, q.device)
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


def flash_block_sparse_bwd_reference(q, k, v, out, lse, dout, layout,
                                     causal=False):
    """Dense plain-PyTorch version of B5b: P = exp(S − lse) over the
    visible pairs of active tiles, dP = dO·Vᵀ, Δ = rowsum(dO∘O), dS =
    P∘(dP − Δ) in the storage dtype, dq = dS·K/√d, dk = dSᵀ·Q/√d, dv =
    Pᵀ·dO with P in the storage dtype.  Returns ``(dq, dk, dv)`` in the
    input dtype."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    visible, _ = expand_layout(layout, s, causal, q.device)
    # outside the active tiles P is 0 whatever lse holds (a row with no
    # active tile has lse = NEG_INF, and NEG_INF − NEG_INF is 0)
    p = torch.where(visible[None],
                    torch.exp(_masked_scores(q, k, visible)
                              - lse.view(b, h, s, 1)), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- kernels
def _kernels():
    lib = op_builder.load("flash_block_sparse")
    fwd, bwd = lib.ds_flash_block_sparse_fwd, lib.ds_flash_block_sparse_bwd
    if fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_int64)
        fwd.argtypes = ([i32, i32] + [ptr] * 7 + [i32] * 6
                        + [strides, ctypes.c_float, i32, ptr])
        bwd.argtypes = ([i32, i32] + [ptr] * 13 + [i32] * 7
                        + [strides, ctypes.c_float, i32, ptr])
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(q, k, v, layout):
    """Shapes and the layout, for any device; returns the layout as a
    numpy array (the caller's own array when it already is one)."""
    if q.dim() != 4:
        raise ValueError("block-sparse flash attention takes [b, s, h, d] "
                         "q, k, v")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"k and v must match q {tuple(q.shape)} (self-"
                         f"attention); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not isinstance(layout, np.ndarray):
        layout = np.asarray(layout)
    _, s, h, _ = q.shape
    if layout.ndim != 3 or layout.shape[1] != layout.shape[2]:
        raise ValueError(f"layout must be [H, nb, nb], got {layout.shape}")
    nb = layout.shape[1]
    if s % nb != 0:
        raise ValueError(f"seq {s} not divisible into {nb} blocks")
    if layout.shape[0] not in (1, h):
        raise ValueError(f"layout heads {layout.shape[0]} incompatible "
                         f"with {h} heads")
    return layout


def kernel_takes(q):
    """Whether the B5 kernels take tensors like ``q`` ``[b, s, h, d]``:
    on the card, fp32 or bf16, head_dim 64 or 128."""
    return (q.is_cuda and q.dtype in _DTYPE_CODES
            and q.shape[-1] in HEAD_DIMS)


def flash_block_sparse_fwd(q, k, v, layout, causal=False):
    """Block-sparse flash forward (B5a); returns ``(out, lse)``.

    CPU tensors take :func:`flash_block_sparse_reference`.  CUDA tensors
    launch the Hopper kernel (bf16 or fp32, head_dim 64 or 128) or raise.
    Every launch adds one to ``flash_block_sparse_fwd.launches``."""
    layout = _check(q, k, v, layout)
    if q.device.type == "cpu":
        return flash_block_sparse_reference(q, k, v, layout, causal)
    _check_cuda(q, k, v, None)
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
                 int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_block_sparse_fwd kernel launch failed: "
                           f"CUDA error {rc}")
    flash_block_sparse_fwd.launches += 1
    return out, lse


flash_block_sparse_fwd.launches = 0


def flash_block_sparse_bwd(q, k, v, out, lse, dout, layout, causal=False):
    """Block-sparse flash backward (B5b): ``(dq, dk, dv)`` from the
    forward's out and lse.

    CPU tensors take :func:`flash_block_sparse_bwd_reference`.  CUDA
    tensors launch the dq kernel and the dk/dv kernel (one launch of B5b:
    ``flash_block_sparse_bwd.launches`` goes up by one) or raise.  No
    atomics: two runs give bitwise-equal gradients."""
    layout = _check(q, k, v, layout)
    b, s, h, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dO must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)} and {tuple(dout.shape)}")
    if tuple(lse.shape) != (b * h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 [b·h, s]={(b * h, s)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if dout.dtype != q.dtype:
        dout = dout.to(q.dtype)
    if q.device.type == "cpu":
        return flash_block_sparse_bwd_reference(q, k, v, out, lse, dout,
                                                layout, causal)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    _check_cuda(q, k, v, None, extra=(dout, out))
    lse = lse.contiguous()
    luts = device_luts(layout, q.device)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .reshape(b * h, s).contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
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
                 1.0 / math.sqrt(d), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_block_sparse_bwd kernel launch failed: "
                           f"CUDA error {rc}")
    flash_block_sparse_bwd.launches += 1
    return dq, dk, dv


flash_block_sparse_bwd.launches = 0


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


def flash_block_sparse_attention(q, k, v, layout, causal=False,
                                 q_agg="auto"):
    """Block-sparse flash attention on ``[b, s, h, d]`` inputs,
    differentiable.

    ``layout`` is the ``[H, nb, nb]`` 0/1 block layout (H == heads, or 1
    for a shared layout) of ``sparsity_config.make_layout``; pass the same
    array every call and its device tables are built once.  ``q_agg``
    ("auto", "never" or an explicit factor) resolves to G as in the JAX
    package.  ``G == 1`` runs the B5 kernels on bare ``[blk, blk]``
    tiles.  ``G > 1`` is where the JAX package runs its G×G super-tile
    kernels, which are not ported yet: that raises, on any device, and
    does not quietly run B5."""
    layout = _check(q, k, v, layout)
    nb = layout.shape[1]
    G = _pick_q_agg(q.shape[1] // nb, nb, q_agg)
    if G > 1:
        raise NotImplementedError(
            f"q_agg={q_agg!r} at layout block {q.shape[1] // nb} resolves "
            f"to G={G} super-tiles, whose kernels are not ported yet "
            f"(ROADMAP B6); q_agg='never' runs the bare-tile kernels, and "
            f"so does 'auto' for layout blocks above 128 rows")
    return FlashBlockSparse.apply(q, k, v, layout, bool(causal))
