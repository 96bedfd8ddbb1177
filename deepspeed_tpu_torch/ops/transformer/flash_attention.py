"""Flash-attention forward: the Hopper kernel's wrapper and its plain version.

Port of ``deepspeed_tpu/ops/transformer/flash_attention.py`` (forward
only; the backward kernels and in-kernel dropout come with the training
slice).  ``flash_attention_fwd`` launches the CUDA kernel
``csrc/transformer/flash_attention_fwd.cu`` for CUDA tensors and runs
``flash_attention_reference`` for CPU tensors; on a CUDA tensor it
launches the kernel or raises, never falling back.

Layout is the JAX package's: q ``[b, s, h, d]``, k and v
``[b, kv_len, h, d]``, ``kv_mask`` ``[b, kv_len]`` with 1 at visible keys.
The kernel reads q, k and v through their strides (only the last dim
must be contiguous), so slices of a fused QKV projection go in as they
are.  It returns out ``[b, s, h, d]`` in the input dtype and the fp32
logsumexp ``[b·h, s]`` (the TPU kernel's ``[b·h, 1, s]`` without the
singleton axis).
"""

import ctypes
import math

import torch

from .. import op_builder

NEG_INF = -1e30
# Running-max floor: keeps exp(NEG_INF - m) == 0 even for rows where every
# key is masked out (m would otherwise be NEG_INF and exp(0) = 1).
MAX_FLOOR = -1e20

HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def flash_attention_reference(q, k, v, kv_mask=None, causal=False):
    """Dense plain-PyTorch version of the kernel, with its exact masking
    semantics (port of ``_jnp_flash_reference``): scores in fp32, masked
    scores ``NEG_INF``, the row max floored at ``MAX_FLOOR``, P cast to the
    storage dtype before the fp32-accumulated P·V, normalized after, as
    the TPU and Hopper kernels do.  O(s·kv_len) memory.  Returns
    ``(out [b, s, h, d], lse [b·h, s])``."""
    b, s, h, d = q.shape
    kv_len = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(kv_len, device=q.device)[None, :])
        sc = torch.where(keep[None, None], sc, NEG_INF)
    if kv_mask is not None:
        sc = torch.where(kv_mask.float()[:, None, None, :] > 0.0, sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True).clamp_min(MAX_FLOOR)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0].reshape(b * h, s)
    return out.to(q.dtype), lse


def _kernel():
    lib = op_builder.load("flash_attention_fwd")
    fn = lib.ds_flash_attention_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = ([i32, i32] + [ptr] * 6 + [i32] * 4 + [i64] * 9
                       + [ctypes.c_float, i32, ptr])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, kv_mask):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd takes [b, s, h, d] q, k, v")
    b, s, h, d = q.shape
    kv_len = k.shape[1]
    if k.shape != (b, kv_len, h, d) or v.shape != k.shape:
        raise ValueError(f"k and v must be [b, kv_len, h, d] matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if s == 0 or kv_len == 0:
        raise ValueError("flash_attention_fwd needs s > 0 and kv_len > 0")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, kv_len):
        raise ValueError(f"kv_mask must be [batch, kv_len]={b, kv_len}, "
                         f"got {tuple(kv_mask.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")


def flash_attention_fwd(q, k, v, kv_mask=None, causal=False,
                        dropout_rate=0.0):
    """Flash-attention forward; returns ``(out, lse)``.

    CPU tensors take :func:`flash_attention_reference`.  CUDA tensors
    launch the Hopper kernel (bf16 or fp32, head_dim 64 or 128) or raise.
    Every launch adds one to ``flash_attention_fwd.launches``."""
    if dropout_rate:
        raise NotImplementedError(
            "in-kernel attention dropout is not ported yet; it comes with "
            "the backward kernels")
    _check(q, k, v, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu tensors, "
                         f"got {q.device}")
    b, s, h, d = q.shape
    kv_len = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the flash kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"batch*heads={b * h} exceeds the kernel grid "
                         f"({_MAX_GRID_Y})")
    tensors = (q, k, v) if kv_mask is None else (q, k, v, kv_mask)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and kv_mask must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the flash kernel needs the last dim of q, k and v "
                         "contiguous")
    mask = (None if kv_mask is None
            else kv_mask.to(torch.float32).contiguous())
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), None if mask is None else mask.data_ptr(),
                out.data_ptr(), lse.data_ptr(), b, h, s, kv_len,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                1.0 / math.sqrt(d), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
