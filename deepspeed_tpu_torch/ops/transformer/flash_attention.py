"""Flash attention: the Hopper kernels' wrappers, their plain versions and
the autograd function that joins them.

Port of ``deepspeed_tpu/ops/transformer/flash_attention.py``.  Kernels
(``csrc/transformer/``):

- B1 ``flash_attention_fwd.cu``: forward, out and the fp32 logsumexp
  (bf16 and fp16 on the tensor cores, ``mma.sync``; fp32 scalar);
- B2a and B2b ``flash_attention_bwd.cu``: dq over K/V tiles, and dk, dv
  over Q tiles (bf16 and fp16 on the tensor cores, ``mma.sync``; fp32
  scalar);
- B3 ``flash_attention_bwd.cu``: dq, dk and dv from one score pass, for
  shapes whose whole sequence fits a block's shared memory (bf16 and fp16
  on the tensor cores, ``mma.sync``; fp32 scalar);
- B4 ``flash_dropout.cu``: the attention-dropout keep mask of a whole
  call, drawn ONCE per forward into packed bits (int32 words ``[b·h, s,
  ceil(kv_len/32)]``, :func:`draw_keep_bits`) that B1, B2a, B2b and B3
  read; none of them draws.  The draw is a counter-based Philox keyed on
  two seed words and counting ELEMENTS (b·h, q row, k col >> 2), so the
  bits do not depend on any kernel's tiling.  A call on a range of the
  heads (a tensor-parallel rank's, ``head_offset`` into ``total_heads``)
  counts with the GLOBAL head, b·total_heads + head_offset + j, so the
  ranks of a sharded run drop exactly the entries of the whole call.

Each wrapper launches its kernel for CUDA tensors or raises, and runs the
plain version (:func:`flash_attention_reference`,
:func:`flash_attention_bwd_dq_reference` for B2a,
:func:`flash_attention_bwd_dkv_reference` for B2b,
:func:`flash_attention_bwd_reference` for B3, :func:`philox_keep_bits`)
for CPU tensors; a CPU run and a card run with one seed drop the same
entries.  Each wrapper counts its launches in ``.launches``, and B1–B3
their fp16 launches again in ``.fp16.launches``, so a run can show that
an fp16 path took the fp16 kernels; with a flops profiler counting, a
launch also adds its plain version's count on the same inputs
(:func:`~deepspeed_tpu_torch.profiling.flops_profiler.kernel_launch`).  ``in_kernel_dropout`` counts the B1–B3
launches that applied a keep mask (``.fp16`` the fp16 ones), and
``draw_keep_bits.launches`` B4's draws.
:class:`FlashAttention` is the ``torch.autograd.Function``: its forward
draws the bits with B4 and runs B1, and its backward runs B3 or B2a+B2b
on the same bits.

Layout is the JAX package's: q ``[b, s, h, d]``, k and v
``[b, kv_len, h, d]``, ``kv_mask`` ``[b, kv_len]`` with 1 at visible keys.
The kernels read q, k, v and dO through their strides (only the last dim
must be contiguous), so slices of a fused QKV projection go in as they
are.  lse is fp32 ``[b·h, s]`` (the TPU kernel's ``[b·h, 1, s]`` without
the singleton axis).  Not carried over: the v5e block picker
``_auto_blocks``, ``kernel_tuner`` and ``DS_FLASH_EXP2``.
"""

import ctypes
import math
import types

import torch

from .. import op_builder
from ...profiling.flops_profiler.profiler import kernel_launch

NEG_INF = -1e30
# Running-max floor: keeps exp(NEG_INF - m) == 0 even for rows where every
# key is masked out (m would otherwise be NEG_INF and exp(0) = 1).
MAX_FLOOR = -1e20

HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the types the tensor-core kernels take (16-byte cp.async copies)
MMA_DTYPES = (torch.bfloat16, torch.float16)
_NAMES = {torch.bfloat16: "bf16", torch.float16: "fp16"}
_MAX_GRID_Y = 65535
# shared memory one Hopper block may use (232,448 bytes of the SM's 256 KB)
SMEM_PER_BLOCK = 232448

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

# launches of B1, B2a, B2b or B3 that applied B4's keep mask (and of
# those, the fp16 ones)
in_kernel_dropout = types.SimpleNamespace(
    launches=0, fp16=types.SimpleNamespace(launches=0))


# ---------------------------------------------------------------- dropout
def dropout_thresh(rate):
    """``(thresh, inv_keep)`` of ``_dropout_thresh``: a key is dropped iff
    its 32 random bits are below ``thresh`` = round(rate·2³²) clamped to
    [1, 2³²−1], and a kept P is scaled by 1 / (1 − thresh/2³²)."""
    thresh = int(round(float(rate) * float(1 << 32)))
    thresh = min((1 << 32) - 1, max(1, thresh))
    return thresh, 1.0 / (1.0 - thresh / float(1 << 32))


def _mulhilo(a, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a``
    and the int64 tensor ``b`` (both below 2³²), in int64 ops that never
    overflow: b is split into 16-bit halves."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _M32


def philox_bits(seed, heads, rows, c_lo, c_hi):
    """The 32 random bits the kernels draw for every element of the block
    ``heads`` (b·h indices) × ``rows`` (int64 index tensors) × columns
    ``c_lo .. c_hi-1``, as int64 ``[len(heads), len(rows), c_hi-c_lo]`` on
    the seed's device.  Philox4x32-10 keyed on the two seed words, counter
    (b·h, row, col >> 2, 0); column ``col`` takes output word ``col & 3``.
    int64 ops only, so it runs on any device."""
    dev = seed.device
    key = seed.to(torch.int64) & _M32
    k0, k1 = key[0], key[1]
    groups = torch.arange(c_lo >> 2, ((c_hi - 1) >> 2) + 1, device=dev)
    shape = (len(heads), len(rows), len(groups))
    c0 = heads.to(dev).view(-1, 1, 1).expand(shape)
    c1 = rows.to(dev).view(1, -1, 1).expand(shape)
    c2 = groups.view(1, 1, -1).expand(shape)
    c3 = torch.zeros(shape, dtype=torch.int64, device=dev)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    words = torch.stack((c0, c1, c2, c3), dim=-1).reshape(
        shape[0], shape[1], 4 * shape[2])
    first = c_lo - 4 * (c_lo >> 2)
    return words[..., first:first + c_hi - c_lo]


def drop_heads(b, h, head_offset=0, total_heads=None, device=None):
    """The Philox counter word of each (batch, head) of a ``[b, s, h,
    d]`` call on heads ``head_offset .. head_offset + h - 1`` of
    ``total_heads`` (default ``h``): ``batch·total_heads + head_offset +
    j``, int64 ``[b·h]`` in the kernels' b·h order."""
    total = h if total_heads is None else int(total_heads)
    return (torch.arange(b, device=device)[:, None] * total + head_offset
            + torch.arange(h, device=device)[None, :]).reshape(-1)


def philox_keep_mask(seed, bh, s, kv_len, rate, heads=None, q_offset=0):
    """The bool keep mask ``[bh, s, kv_len]`` of seed words ``seed`` (two
    int32, on any device; the mask comes back on that device): an element
    is kept iff its :func:`philox_bits` are at least ``thresh``.
    ``heads`` (int64 ``[bh]``, :func:`drop_heads`) are the counter words
    of the b·h rows, ``0 .. bh-1`` by default; row i is the global row
    ``q_offset + i`` (a sequence-parallel chunk's rows of a whole call)."""
    thresh, _ = dropout_thresh(rate)
    dev = seed.device
    heads = torch.arange(bh, device=dev) if heads is None else heads
    return philox_bits(seed, heads,
                       torch.arange(q_offset, q_offset + s, device=dev), 0,
                       kv_len) >= thresh


def keep_words(kv_len):
    """int32 words a row of B4's packed keep mask holds."""
    return (kv_len + 31) // 32


def pack_keep_bits(mask):
    """A bool mask ``[bh, s, kv_len]`` as B4's int32 words ``[bh, s,
    ceil(kv_len/32)]``: bit c of word w of a row is element 32w + c."""
    bh, s, kv_len = mask.shape
    n = keep_words(kv_len)
    cols = torch.nn.functional.pad(mask, (0, 32 * n - kv_len))
    shifts = torch.arange(32, device=mask.device, dtype=torch.int64)
    words = (cols.view(bh, s, n, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def unpack_keep_bits(bits, kv_len):
    """B4's int32 words ``[bh, s, words]`` as the bool keep mask ``[bh, s,
    kv_len]``."""
    bh, s, n = bits.shape
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    cols = (bits.to(torch.int64)[..., None] >> shifts) & 1
    return cols.view(bh, s, 32 * n)[..., :kv_len].bool()


def philox_keep_bits(seed, bh, s, kv_len, rate, heads=None, causal=False,
                     q_offset=0):
    """Plain version of B4: the packed keep bits ``[bh, s,
    ceil(kv_len/32)]`` (int32, on the seed's device) of
    :func:`philox_keep_mask`'s mask, with the bits of every group of 4
    columns that holds no visible element 0, as the kernel leaves them:
    under ``causal`` row i (the global row ``q_offset + i``) sees columns
    0 .. q_offset + i, so group g is drawn iff 4g <= q_offset + i.  A
    chunk's words are its rows of a whole call's, cut to its
    ``ceil(kv_len/32)`` words.  Bitwise the kernel's words."""
    mask = philox_keep_mask(seed, bh, s, kv_len, rate, heads, q_offset)
    if causal:
        dev = seed.device
        groups = torch.arange(kv_len, device=dev) // 4
        rows = torch.arange(q_offset, q_offset + s, device=dev)
        mask &= groups[None, :] <= rows[:, None] // 4
    return pack_keep_bits(mask)


# ----------------------------------------------------------- plain versions
def _scores(q, k, kv_mask, causal, q_offset=0):
    """Scaled fp32 [b, h, s, kv_len] scores, masked to NEG_INF; under
    ``causal`` row i is the global row ``q_offset + i``."""
    s, kv_len, d = q.shape[1], k.shape[1], q.shape[-1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    if causal:
        rows = torch.arange(q_offset, q_offset + s, device=q.device)
        visible = rows[:, None] >= torch.arange(kv_len,
                                                device=q.device)[None, :]
        sc = torch.where(visible[None, None], sc, NEG_INF)
    if kv_mask is not None:
        sc = torch.where(kv_mask.float()[:, None, None, :] > 0.0, sc, NEG_INF)
    return sc


def flash_attention_reference(q, k, v, kv_mask=None, causal=False,
                              keep=None, inv_keep=1.0, q_offset=0):
    """Dense plain-PyTorch version of B1, with its exact masking
    semantics (port of ``_jnp_flash_reference``): scores in fp32, masked
    scores ``NEG_INF``, the row max floored at ``MAX_FLOOR``, l summing
    the undropped P, the kept P (``keep`` ``[b, h, s, kv_len]``, scaled by
    ``inv_keep``) cast to the storage dtype before the fp32-accumulated
    P·V, normalized after, as the TPU and Hopper kernels do.
    O(s·kv_len) memory.  ``q_offset`` is the global row of q's row 0 (a
    sequence-parallel chunk against the gathered keys): under ``causal``
    row i sees keys 0 .. q_offset + i.  Returns ``(out [b, s, h, d], lse
    [b·h, s])``."""
    b, s, h, _ = q.shape
    sc = _scores(q, k, kv_mask, causal, q_offset)
    m = sc.amax(dim=-1, keepdim=True).clamp_min(MAX_FLOOR)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    if keep is not None:
        p = torch.where(keep, p * inv_keep, 0.0)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b * h, s)
    return out.to(q.dtype), lse


def _bwd_scores(q, k, v, out, lse, dout, kv_mask, causal, keep, inv_keep,
                q_offset):
    """The backward's shared terms: P_kept (the kept P, scaled) and dS in
    the storage dtype, as fp32 ``[b, h, s, kv_len]``."""
    b, s, h, d = q.shape
    p = torch.exp(_scores(q, k, kv_mask, causal, q_offset)
                  - lse.view(b, h, s, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    p_v = p
    if keep is not None:
        p_v = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = (p * (dp - delta)).to(q.dtype).float()
    return p_v, ds


def _dq(q, k, ds):
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
            * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype)


def _dkv(q, k, v, dout, p_v, ds):
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    dv = torch.einsum("bhqk,bqhd->bkhd", p_v.to(v.dtype).float(),
                      dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, out, lse, dout, kv_mask=None,
                                  causal=False, keep=None, inv_keep=1.0,
                                  q_offset=0):
    """Dense plain-PyTorch version of B3 (and of B2a and B2b together):
    P = exp(S − lse) from the forward's lse, dP = dO·Vᵀ, both masked and
    scaled by the keep mask under dropout, Δ = rowsum(dO∘O), dS =
    P∘(dP − Δ) in the storage dtype, dq = dS·K/√d, dk = dSᵀ·Q/√d, dv =
    P_keptᵀ·dO with P_kept in the storage dtype; ``q_offset`` as in
    :func:`flash_attention_reference` (dk and dv are then the chunk's
    partials).  Returns ``(dq, dk, dv)`` in the input dtype."""
    p_v, ds = _bwd_scores(q, k, v, out, lse, dout, kv_mask, causal, keep,
                          inv_keep, q_offset)
    return (_dq(q, k, ds),) + _dkv(q, k, v, dout, p_v, ds)


def flash_attention_bwd_dq_reference(q, k, v, out, lse, dout, kv_mask=None,
                                     causal=False, keep=None, inv_keep=1.0,
                                     q_offset=0):
    """Plain version of B2a: dq of :func:`flash_attention_bwd_reference`,
    bitwise, from its own score pass (as B2a recomputes P and dP)."""
    _, ds = _bwd_scores(q, k, v, out, lse, dout, kv_mask, causal, keep,
                        inv_keep, q_offset)
    return _dq(q, k, ds)


def flash_attention_bwd_dkv_reference(q, k, v, out, lse, dout, kv_mask=None,
                                      causal=False, keep=None, inv_keep=1.0,
                                      q_offset=0):
    """Plain version of B2b: ``(dk, dv)`` of
    :func:`flash_attention_bwd_reference`, bitwise, from its own score
    pass (as B2b recomputes P and dP)."""
    p_v, ds = _bwd_scores(q, k, v, out, lse, dout, kv_mask, causal, keep,
                          inv_keep, q_offset)
    return _dkv(q, k, v, dout, p_v, ds)


# ----------------------------------------------------------------- kernels
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# ds_flash_attention_fwd(dtype, head_dim, q, k, v, kv_mask, out, lse,
# batch, heads, s, kv_len, 9 strides, scale, causal, q_offset,
# keep_bits, keep_words, inv_keep, stream)
FWD_ARGTYPES = ([_I32, _I32] + [_PTR] * 6 + [_I32] * 4 + [_I64] * 9
                + [ctypes.c_float, _I32, _I32, _PTR, _I32, ctypes.c_float,
                   _PTR])
# ds_flash_attention_bwd(which, dtype, head_dim, q, k, v, dout, lse,
# delta, kv_mask, dq, dk, dv, batch, heads, s, kv_len, strides, scale,
# causal, q_offset, keep_bits, keep_words, inv_keep, stream)
BWD_ARGTYPES = ([_I32] * 3 + [_PTR] * 10 + [_I32] * 4
                + [ctypes.POINTER(ctypes.c_int64), ctypes.c_float, _I32,
                   _I32, _PTR, _I32, ctypes.c_float, _PTR])


def _fwd_kernel():
    fn = op_builder.load("flash_attention_fwd").ds_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = FWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _keep_kernel():
    fn = op_builder.load("flash_dropout").ds_flash_keep_bits
    if fn.argtypes is None:
        fn.argtypes = ([_PTR, _PTR] + [_I32] * 5
                       + [ctypes.c_uint32, _I32, _I32, _I32, _PTR])
        fn.restype = ctypes.c_int
    return fn


def _bwd_kernel():
    lib = op_builder.load("flash_attention_bwd")
    fn = lib.ds_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = BWD_ARGTYPES
        fn.restype = ctypes.c_int
        smem = lib.ds_flash_attention_bwd_fused_smem
        smem.argtypes = [_I32] * 4
        smem.restype = ctypes.c_int64
    return fn


def fused_smem_bytes(head_dim, s, kv_len, dtype):
    """Shared memory B3 needs for one b·h, as the CUDA source counts it
    (``ds_flash_attention_bwd_fused_smem``).  fp32, the scalar kernel:
    Q and dO ``[s, d]``, K and V ``[kv_len, d+1]`` and the ``[s, kv_len]``
    score tile in fp32, lse and Δ, the key mask and the keep bits.  bf16,
    the tensor-core kernel: Q and dO ``[s16, d+8]``, K and V ``[kv32,
    d+8]``, P_kept and dS ``[s16, kv32+8]`` in bf16, the key mask and the
    keep bits, with s rounded up to 16 (s16) and kv_len to 32 (kv32).
    Builds the backward library."""
    _bwd_kernel()
    return op_builder.load("flash_attention_bwd") \
        .ds_flash_attention_bwd_fused_smem(_DTYPE_CODES[dtype], head_dim, s,
                                           kv_len)


def fused_backward_fits(head_dim, s, kv_len, dtype):
    """Whether B3's tiles for ``dtype`` fit one block's shared memory:
    fp32 s = kv_len ≤ 142 at head_dim 64, ≤ 94 at 128; bf16 s = kv_len ≤
    160 at 64, ≤ 128 at 128 (BERT's 21 gathered rows against up to 512
    keys at 64).  The v5e rule "one tile up to s=1024" is TPU-only."""
    return fused_smem_bytes(head_dim, s, kv_len, dtype) <= SMEM_PER_BLOCK


# The bf16 crossover between B3 and B2a+B2b, each on one precomputed Δ,
# with a key mask of ones and dropout 0.1 at h=16: B3 measured faster at
# every shape up to the 160 query rows and keys its bf16 tiles fit at
# d=64 (examples/profile_torch_b3.py and chip_smoke.py's
# check_b3_bert_scale on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md),
# B3 against B2a+B2b in ms: b=64 s=128 0.120 / 0.147, BERT's 21 gathered
# rows against 128 keys 0.050 / 0.090, b=8 s=128 0.016 / 0.028, b=64 s=64
# 0.040 / 0.064, s=160 0.206 / 0.256, s=128 at d=128 0.180 / 0.259.
# Unmeasured beyond 160, so B2a+B2b there.
BF16_FUSED_MAX_LEN = 160


def use_fused_backward(head_dim, s, kv_len, dtype):
    """B3 (True) or B2a+B2b (False) for CUDA tensors of ``dtype``.  B3
    computes P and dP once where B2a and B2b each recompute both, but
    holds the whole sequence in one block per b·h, so it runs only where
    :func:`fused_backward_fits`.  fp32 takes it wherever it fits (B2a and
    B2b are scalar-FMA kernels in fp32); bf16 up to
    ``BF16_FUSED_MAX_LEN`` query rows and keys, where it measured faster
    than the tensor-core B2a+B2b, and fp16, whose kernels are the same
    design with the fp16 ``mma.sync``, by the same rule."""
    if dtype in MMA_DTYPES and max(s, kv_len) > BF16_FUSED_MAX_LEN:
        return False
    return fused_backward_fits(head_dim, s, kv_len, dtype)


def mma_aligned(*tensors):
    """Whether the bf16 and fp16 B1, B2a, B2b and B3 can read these
    ``[b, n, h, d]`` tensors with 16-byte ``cp.async`` copies: each base
    pointer 16-byte aligned and each batch, sequence and head stride (of
    a dim longer than 1) a multiple of 8 elements.  Slices of a fused QKV projection
    (training and the serving prefill), the gathered ``positions``
    queries and contiguous tensors all are."""
    return all(t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st, n in zip(t.stride()[:3],
                                                   t.shape[:3]) if n > 1)
               for t in tensors)


def check_fwd_views(q, k, v):
    """The forward wrapper's rule for the views it is given: bf16 and
    fp16 q, k and v go to B1 on the tensor cores, which copies them in
    16-byte ``cp.async`` chunks, so it raises a ValueError naming B1 where
    :func:`mma_aligned` refuses them (never copies or sends them
    elsewhere); fp32 takes any view whose last dim is contiguous."""
    if q.dtype in MMA_DTYPES and not mma_aligned(q, k, v):
        raise ValueError(
            f"the {_NAMES[q.dtype]} B1 kernel needs q, k and v 16-byte "
            "aligned with batch, seq and head strides that are multiples "
            "of 8 elements; "
            f"got strides {q.stride()}, {k.stride()}, {v.stride()}")


def _check(q, k, v, kv_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [b, s, h, d] q, k, v")
    b, s, h, d = q.shape
    kv_len = k.shape[1]
    if k.shape != (b, kv_len, h, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be [b, kv_len, h, d] matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if s == 0 or kv_len == 0:
        raise ValueError("flash attention needs s > 0 and kv_len > 0")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, kv_len):
        raise ValueError(f"kv_mask must be [batch, kv_len]={b, kv_len}, "
                         f"got {tuple(kv_mask.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def _total_heads(h, head_offset, total_heads):
    """``total_heads`` (default ``h``), checked to hold heads
    ``head_offset .. head_offset + h - 1``."""
    total = h if total_heads is None else int(total_heads)
    if head_offset < 0 or head_offset + h > total:
        raise ValueError(f"heads {head_offset}..{head_offset + h - 1} are "
                         f"not within {total}")
    return total


def _check_rate(dropout_rate):
    if not 0.0 < dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")


def _check_seed(seed, device):
    if seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout seed (two int32 "
                         "words) or its keep bits")
    if (seed.dtype != torch.int32 or seed.numel() != 2
            or seed.device != device):
        raise ValueError(f"the dropout seed must be two int32 words on "
                         f"{device}, got {seed.dtype} {tuple(seed.shape)} "
                         f"on {seed.device}")


def draw_keep_bits(seed, b, h, s, kv_len, dropout_rate, causal=False,
                   head_offset=0, total_heads=None, q_offset=0):
    """B4: the keep bits of a ``[b, s, h, *]`` attention call with
    ``kv_len`` keys at ``dropout_rate``, int32 ``[b·h, s,
    ceil(kv_len/32)]`` on the seed's device (bit c of word w of a row is
    1 iff key 32w + c is kept), drawn from the two int32 seed words
    ``seed``; under ``causal`` the groups of 4 keys a row cannot see are
    not drawn and their bits are 0.  ``head_offset`` and ``total_heads``
    place the heads in a whole call's (a tensor-parallel rank's range),
    and ``q_offset`` the rows (a sequence-parallel rank's chunk, rows
    ``q_offset .. q_offset + s - 1`` of the whole call): the bits are
    then exactly those heads' and rows' bits of the whole call.

    A CPU seed takes :func:`philox_keep_bits`.  A CUDA seed launches the
    Hopper kernel (``flash_dropout.cu``) or raises, and adds one to
    ``draw_keep_bits.launches``."""
    _check_rate(dropout_rate)
    _check_seed(seed, None if seed is None else seed.device)
    total = _total_heads(h, head_offset, total_heads)
    _check_offset(q_offset)
    if seed.device.type == "cpu":
        return _keep_plain(seed, b, h, s, kv_len, dropout_rate, causal,
                           head_offset, total, q_offset)
    if seed.device.type != "cuda":
        raise ValueError(f"the keep-bit kernel runs on cuda or cpu seeds, "
                         f"got {seed.device}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"batch*heads={b * h} exceeds the kernel grid "
                         f"({_MAX_GRID_Y})")
    bits = torch.empty((b * h, s, keep_words(kv_len)), dtype=torch.int32,
                       device=seed.device)
    with torch.cuda.device(seed.device):
        stream = torch.cuda.current_stream(seed.device).cuda_stream
        rc = _keep_kernel()(bits.data_ptr(), seed.data_ptr(), b, h, s,
                            kv_len, int(bool(causal)),
                            dropout_thresh(dropout_rate)[0], head_offset,
                            total, int(q_offset), stream)
    if rc != 0:
        raise RuntimeError(f"keep-bit kernel launch failed: CUDA error {rc}")
    draw_keep_bits.launches += 1
    kernel_launch("B4", _keep_plain, seed, b, h, s, kv_len, dropout_rate,
                  causal, head_offset, total, q_offset)
    return bits


draw_keep_bits.launches = 0


def _keep_plain(seed, b, h, s, kv_len, dropout_rate, causal, head_offset,
                total, q_offset):
    """B4's plain version as the wrapper calls it, on the seed's device."""
    return philox_keep_bits(
        seed, b * h, s, kv_len, dropout_rate,
        drop_heads(b, h, head_offset, total, seed.device), causal, q_offset)


def _keep_bits_arg(q, kv_len, dropout_rate, keep_bits):
    """The keep bits a kernel applies: None without dropout, else
    ``keep_bits`` (B4's words of the forward), checked."""
    if not dropout_rate:
        return None
    _check_rate(dropout_rate)
    b, s, h, _ = q.shape
    shape = (b * h, s, keep_words(kv_len))
    if keep_bits is None:
        raise ValueError(f"dropout_rate {dropout_rate} needs the call's keep "
                         f"bits (draw_keep_bits): int32 {shape}")
    if (keep_bits.dtype != torch.int32 or tuple(keep_bits.shape) != shape
            or not keep_bits.is_contiguous() or keep_bits.device != q.device):
        raise ValueError(f"keep_bits must be contiguous int32 {shape} on "
                         f"{q.device}, got {keep_bits.dtype} "
                         f"{tuple(keep_bits.shape)} on {keep_bits.device}")
    return keep_bits


def _forward_bits(q, kv_len, causal, dropout_rate, seed, keep_bits,
                  head_offset, total_heads, q_offset):
    """The forward's keep bits: ``keep_bits`` as given, or B4's draw from
    ``seed`` where they are not."""
    if dropout_rate and keep_bits is None:
        _check_rate(dropout_rate)
        _check_seed(seed, q.device)
        b, s, h, _ = q.shape
        keep_bits = draw_keep_bits(seed, b, h, s, kv_len, dropout_rate,
                                   causal, head_offset, total_heads,
                                   q_offset)
    return _keep_bits_arg(q, kv_len, dropout_rate, keep_bits)


def _plain_keep(keep_bits, dropout_rate, b, h, kv_len):
    """The bool keep mask ``[b, h, s, kv_len]`` and scale the plain
    versions take from the keep bits."""
    if keep_bits is None:
        return None, 1.0
    s = keep_bits.shape[1]
    return (unpack_keep_bits(keep_bits, kv_len).view(b, h, s, kv_len),
            dropout_thresh(dropout_rate)[1])


def _check_cuda(q, k, v, kv_mask, extra=()):
    """The kernels' limits, for CUDA tensors: raises on what they do not
    take, never falls back."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the flash kernels take float32, bfloat16 or "
                         f"float16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"batch*heads={b * h} exceeds the kernel grid "
                         f"({_MAX_GRID_Y})")
    tensors = (q, k, v) + tuple(extra) + (
        () if kv_mask is None else (kv_mask,))
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash attention tensors must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v) + tuple(extra)):
        raise ValueError("the flash kernels need the last dim of q, k, v "
                         "and dO contiguous")


def _mask_arg(kv_mask):
    return None if kv_mask is None else kv_mask.to(torch.float32).contiguous()


def _dropout_args(keep_bits, dropout_rate):
    if keep_bits is None:
        return None, 0, 1.0
    return (keep_bits.data_ptr(), keep_bits.shape[-1],
            dropout_thresh(dropout_rate)[1])


def _count_launch(wrapper, dropout_rate, dtype):
    """One more launch of ``wrapper``'s kernel, and of a mask-applying
    launch under dropout, each counted again under ``.fp16`` for an fp16
    launch; called only after the launch succeeded."""
    counters = [wrapper] + ([in_kernel_dropout] if dropout_rate else [])
    for counter in counters:
        counter.launches += 1
        if dtype == torch.float16:
            counter.fp16.launches += 1


def _check_offset(q_offset):
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def flash_attention_fwd(q, k, v, kv_mask=None, causal=False,
                        dropout_rate=0.0, seed=None, head_offset=0,
                        total_heads=None, keep_bits=None, q_offset=0):
    """Flash-attention forward (B1); returns ``(out, lse)``.  With
    ``dropout_rate`` > 0 it applies the keep bits ``keep_bits``, or,
    without them, first draws them by :func:`draw_keep_bits` from
    ``seed`` (two int32 seed words).  ``head_offset`` and ``total_heads``
    place q's heads in a whole call's (a tensor-parallel rank's range):
    B4 then draws the whole call's keep bits of those heads.
    ``q_offset`` is the global row of q's row 0 (a sequence-parallel
    rank's chunk against the gathered keys): under ``causal`` row i sees
    keys 0 .. q_offset + i, and B4 draws those rows of the whole call.

    CPU tensors take :func:`flash_attention_reference` with the bits'
    mask.  CUDA tensors launch the Hopper kernel
    (bf16 and fp16 on the tensor cores, fp32 scalar; head_dim 64 or 128)
    or raise, also on bf16 or fp16 views that :func:`mma_aligned`
    refuses.  Every launch adds one to ``flash_attention_fwd.launches``
    (an fp16 one also to ``flash_attention_fwd.fp16.launches``)."""
    _check(q, k, v, kv_mask)
    b, s, h, d = q.shape
    kv_len = k.shape[1]
    _check_offset(q_offset)
    if q.device.type != "cpu":
        _check_cuda(q, k, v, kv_mask)
        check_fwd_views(q, k, v)
    keep_bits = _forward_bits(q, kv_len, causal, dropout_rate, seed,
                              keep_bits, head_offset, total_heads, q_offset)
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, kv_mask, causal, dropout_rate, keep_bits,
                          q_offset)
    mask = _mask_arg(kv_mask)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    fn = _fwd_kernel()
    bits_ptr, words, inv_keep = _dropout_args(keep_bits, dropout_rate)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), None if mask is None else mask.data_ptr(),
                out.data_ptr(), lse.data_ptr(), b, h, s, kv_len,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                1.0 / math.sqrt(d), int(bool(causal)), int(q_offset),
                bits_ptr, words, inv_keep, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    _count_launch(flash_attention_fwd, dropout_rate, q.dtype)
    kernel_launch("B1", _fwd_plain, q, k, v, kv_mask, causal, dropout_rate,
                  keep_bits, q_offset)
    return out, lse


def _fwd_plain(q, k, v, kv_mask, causal, dropout_rate, keep_bits, q_offset):
    """B1's plain version as the wrapper calls it."""
    b, _, h, _ = q.shape
    kv_len = k.shape[1]
    return flash_attention_reference(
        q, k, v, kv_mask, causal,
        *_plain_keep(keep_bits, dropout_rate, b, h, kv_len), q_offset)

_WHICH = {"dq": 0, "dkv": 1, "fused": 2}


def _delta(out, dout):
    """Δ = rowsum(dO∘O) in fp32, ``[b·h, s]`` contiguous, as the JAX
    package computes it outside Pallas."""
    b, s, h, _ = out.shape
    return (dout.float() * out.float()).sum(-1).transpose(1, 2) \
        .reshape(b * h, s).contiguous()


def _launch_bwd(which, q, k, v, lse, dout, kv_mask, causal, dropout_rate,
                keep_bits, delta, dq, dk, dv, q_offset=0):
    b, s, h, d = q.shape
    kv_len = k.shape[1]
    if q.dtype in MMA_DTYPES and not mma_aligned(q, k, v, dout):
        kernels = "B3 kernel needs" if which == "fused" else \
            "B2a/B2b kernels need"
        raise ValueError(
            f"the {_NAMES[q.dtype]} {kernels} q, k, v and dO 16-byte "
            "aligned with batch, seq and head strides that are multiples "
            f"of 8 elements; got strides {q.stride()}, {k.stride()}, "
            f"{v.stride()}, {dout.stride()}")
    if tuple(delta.shape) != (b * h, s) or delta.dtype != torch.float32 \
            or not delta.is_contiguous() or delta.device != q.device:
        raise ValueError(f"delta must be contiguous fp32 [b·h, s]="
                         f"{(b * h, s)} on {q.device}")
    mask = _mask_arg(kv_mask)
    grads_q = dq if dq is not None else q
    grads_kv = dk if dk is not None else k
    if dv is not None and dv.stride() != grads_kv.stride():
        raise ValueError("dk and dv must share their strides")
    strides = (ctypes.c_int64 * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], *grads_q.stride()[:3], *grads_kv.stride()[:3])
    fn = _bwd_kernel()
    bits_ptr, words, inv_keep = _dropout_args(keep_bits, dropout_rate)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_WHICH[which], _DTYPE_CODES[q.dtype], d, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), ptr(mask), ptr(dq), ptr(dk), ptr(dv), b, h,
                s, kv_len, strides, 1.0 / math.sqrt(d), int(bool(causal)),
                int(q_offset), bits_ptr, words, inv_keep, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention backward ({which}) kernel "
                           f"launch failed: CUDA error {rc}")


def _bwd_inputs(q, k, v, out, lse, dout, kv_mask, causal, dropout_rate,
                keep_bits, q_offset):
    """dO, lse and the keep bits, checked."""
    _check(q, k, v, kv_mask)
    b, s, h, _ = q.shape
    _check_offset(q_offset)
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
        _check_cuda(q, k, v, kv_mask, extra=(dout, out))
        lse = lse.contiguous()
    keep_bits = _keep_bits_arg(q, k.shape[1], dropout_rate, keep_bits)
    return dout, lse, keep_bits


def _bwd_plain(q, k, v, out, lse, dout, kv_mask, causal, dropout_rate,
               keep_bits, q_offset, which="fused"):
    """The plain version of B2a (``which`` "dq"), B2b ("dkv") or B3
    ("fused"), as the wrappers call it."""
    b, _, h, _ = q.shape
    ref = {"dq": flash_attention_bwd_dq_reference,
           "dkv": flash_attention_bwd_dkv_reference,
           "fused": flash_attention_bwd_reference}[which]
    return ref(q, k, v, out, lse, dout, kv_mask, causal,
               *_plain_keep(keep_bits, dropout_rate, b, h, k.shape[1]),
               q_offset)


def flash_attention_bwd_dq(q, k, v, out, lse, dout, kv_mask=None,
                           causal=False, dropout_rate=0.0, keep_bits=None,
                           delta=None, q_offset=0):
    """B2a: dq ``[b, s, h, d]``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (``flash_attention_bwd_dq.launches``)
    or raise.  ``delta``, Δ = rowsum(dO∘O) as fp32 ``[b·h, s]``, is
    computed from out and dO when not given (:func:`flash_attention_bwd`
    computes it once for B2a and B2b).  Under dropout it applies the
    forward's ``keep_bits`` (:func:`draw_keep_bits`), its one dropout
    input.  ``q_offset`` as for :func:`flash_attention_fwd`."""
    dout, lse, keep_bits = _bwd_inputs(q, k, v, out, lse, dout, kv_mask,
                                       causal, dropout_rate, keep_bits,
                                       q_offset)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, out, lse, dout, kv_mask, causal,
                          dropout_rate, keep_bits, q_offset, "dq")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dq", q, k, v, lse, dout, kv_mask, causal, dropout_rate,
                keep_bits, _delta(out, dout) if delta is None else delta, dq,
                None, None, q_offset)
    _count_launch(flash_attention_bwd_dq, dropout_rate, q.dtype)
    kernel_launch("B2a", _bwd_plain, q, k, v, out, lse, dout, kv_mask, causal,
                  dropout_rate, keep_bits, q_offset, "dq")
    return dq


def flash_attention_bwd_dkv(q, k, v, out, lse, dout, kv_mask=None,
                            causal=False, dropout_rate=0.0, keep_bits=None,
                            delta=None, q_offset=0):
    """B2b: ``(dk, dv)``, each ``[b, kv_len, h, d]`` (a chunk's partials
    at ``q_offset`` > 0 or q shorter than the keys).  CPU tensors take
    the plain version; CUDA tensors launch the kernel
    (``flash_attention_bwd_dkv.launches``) or raise.  ``delta``,
    ``keep_bits`` and ``q_offset`` as for :func:`flash_attention_bwd_dq`."""
    dout, lse, keep_bits = _bwd_inputs(q, k, v, out, lse, dout, kv_mask,
                                       causal, dropout_rate, keep_bits,
                                       q_offset)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, out, lse, dout, kv_mask, causal,
                          dropout_rate, keep_bits, q_offset, "dkv")
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("dkv", q, k, v, lse, dout, kv_mask, causal, dropout_rate,
                keep_bits, _delta(out, dout) if delta is None else delta,
                None, dk, dv, q_offset)
    _count_launch(flash_attention_bwd_dkv, dropout_rate, q.dtype)
    kernel_launch("B2b", _bwd_plain, q, k, v, out, lse, dout, kv_mask,
                  causal, dropout_rate, keep_bits, q_offset, "dkv")
    return dk, dv


def flash_attention_bwd_fused(q, k, v, out, lse, dout, kv_mask=None,
                              causal=False, dropout_rate=0.0, keep_bits=None,
                              delta=None, q_offset=0):
    """B3: ``(dq, dk, dv)`` from one score pass.  CPU tensors take the
    plain version; CUDA tensors launch the kernel
    (``flash_attention_bwd_fused.launches``: bf16 and fp16 on the tensor
    cores, with a ValueError naming B3 on views :func:`mma_aligned`
    refuses;
    fp32 scalar) or raise, also when the shape does not fit
    (:func:`fused_backward_fits`).  ``delta``, ``keep_bits`` and
    ``q_offset`` as for :func:`flash_attention_bwd_dq`."""
    dout, lse, keep_bits = _bwd_inputs(q, k, v, out, lse, dout, kv_mask,
                                       causal, dropout_rate, keep_bits,
                                       q_offset)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, out, lse, dout, kv_mask, causal,
                          dropout_rate, keep_bits, q_offset)
    d, s, kv_len = q.shape[-1], q.shape[1], k.shape[1]
    if not fused_backward_fits(d, s, kv_len, q.dtype):
        raise ValueError(f"the fused backward needs "
                         f"{fused_smem_bytes(d, s, kv_len, q.dtype)} bytes "
                         f"of shared memory at s={s}, kv_len={kv_len}, "
                         f"d={d}, {q.dtype}; a block has {SMEM_PER_BLOCK}")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("fused", q, k, v, lse, dout, kv_mask, causal, dropout_rate,
                keep_bits, _delta(out, dout) if delta is None else delta, dq,
                dk, dv, q_offset)
    _count_launch(flash_attention_bwd_fused, dropout_rate, q.dtype)
    kernel_launch("B3", _bwd_plain, q, k, v, out, lse, dout, kv_mask, causal,
                  dropout_rate, keep_bits, q_offset)
    return dq, dk, dv


for _wrapper in (flash_attention_fwd, flash_attention_bwd_dq,
                 flash_attention_bwd_dkv, flash_attention_bwd_fused):
    _wrapper.launches = 0
    _wrapper.fp16 = types.SimpleNamespace(launches=0)


def flash_attention_bwd(q, k, v, out, lse, dout, kv_mask=None, causal=False,
                        dropout_rate=0.0, keep_bits=None, q_offset=0):
    """Flash-attention backward: ``(dq, dk, dv)`` from the forward's out
    and lse.  CUDA tensors run B3 where :func:`use_fused_backward` takes
    it, else B2a then B2b, which share one Δ, one fp32 key mask and the
    forward's keep bits; CPU tensors run the plain version.  ``q_offset``
    as for :func:`flash_attention_fwd`."""
    dout, lse, keep_bits = _bwd_inputs(q, k, v, out, lse, dout, kv_mask,
                                       causal, dropout_rate, keep_bits,
                                       q_offset)
    if q.device.type == "cuda" and not use_fused_backward(
            q.shape[-1], q.shape[1], k.shape[1], q.dtype):
        kv_mask = _mask_arg(kv_mask)
        delta = _delta(out, dout)
        dq = flash_attention_bwd_dq(q, k, v, out, lse, dout, kv_mask, causal,
                                    dropout_rate, keep_bits, delta, q_offset)
        dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, dout, kv_mask,
                                         causal, dropout_rate, keep_bits,
                                         delta, q_offset)
        return dq, dk, dv
    return flash_attention_bwd_fused(q, k, v, out, lse, dout, kv_mask,
                                     causal, dropout_rate, keep_bits, None,
                                     q_offset)


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, kv_mask, seed, causal,
    dropout_rate, head_offset, total_heads)`` -> out ``[b, s, h, d]``.
    Under dropout the forward draws the call's keep bits once with B4
    (of the global heads, for a rank's range), runs B1 on them and saves
    q, k, v, out, lse and the bits (no seed); the backward runs B3 or
    B2a+B2b on those bits and draws nothing.  kv_mask and the seed get
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask=None, seed=None, causal=False,
                dropout_rate=0.0, head_offset=0, total_heads=None):
        _check(q, k, v, kv_mask)
        keep_bits = _forward_bits(q, k.shape[1], causal, dropout_rate, seed,
                                  None, head_offset, total_heads, 0)
        out, lse = flash_attention_fwd(q, k, v, kv_mask, causal,
                                       dropout_rate, keep_bits=keep_bits)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask, keep_bits)
        ctx.causal = causal
        ctx.dropout_rate = dropout_rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_mask, keep_bits = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, kv_mask,
                                         ctx.causal, ctx.dropout_rate,
                                         keep_bits)
        return dq, dk, dv, None, None, None, None, None, None
