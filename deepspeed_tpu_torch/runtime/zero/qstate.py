"""Reduced-precision host optimizer state for the streamed offload update
(port of ``deepspeed_tpu/runtime/zero/qstate.py``).

The streamed update is bound by the bytes it moves: the fp32 master and
both Adam moments cross the host link down and back up every step, 24
bytes a parameter.  Storing the pinned host buffers in bf16 (or the
moments in fp16) halves that.  Each chunk is upcast to fp32 on the
card, updated in fp32 exactly as the fp32 layout is, and downcast on
write-back by a rule that keeps the rounding error from accumulating
across steps:

- stochastic rounding (the default): round up or down with probability
  proportional to the distance to each neighbour, so sub-ulp updates
  survive in expectation at no extra bytes;
- error feedback (``error_feedback: true``): a residual buffer per
  reduced buffer carries the exact rounding error to the next step
  (store ``q = cast(y)``, ``r = y - q``; load ``up(q) + up(r)``), at the
  cost of its own bytes on the link.

``rounding: "nearest"`` with error feedback off is reachable as the
control that drifts.

The JAX package draws its rounding bits from threefry keys; PyTorch
cannot reproduce them, so the port draws them from a ``torch.Generator``
on the buffer's device, seeded from (``seed``, optimizer step, chunk
tag, buffer slot) as :meth:`StateQuant.chunk_key` folds them there.  SR
therefore agrees with the JAX package in distribution, not bit for bit;
:func:`ef_store` is deterministic and matches it bit for bit.
"""

import torch

# config names -> torch storage dtypes
STATE_DTYPES = {
    "fp32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp16": torch.float16, "float16": torch.float16,
}

ROUNDING_NEAREST = "nearest"
ROUNDING_STOCHASTIC = "stochastic"

# the random bits below each target mantissa, and the mask that keeps
# the bits above it (the int32 views of 0xFFFF0000 and 0xFFFFE000)
_SR_BITS = {torch.bfloat16: (1 << 16, -(1 << 16)),
            torch.float16: (1 << 13, -(1 << 13))}
_MASK64 = (1 << 64) - 1


def up32(x):
    """Storage -> fp32 (exact from bf16 and fp16)."""
    return x.float()


def sr_from_bits(x, dtype, rnd):
    """fp32 ``x`` -> ``dtype`` by stochastic rounding with the given
    random bits (int32, each below the target's dropped-bit range).

    The JAX package's bit trick: add the bits below the target mantissa
    to the fp32 pattern and truncate, so for sign-magnitude floats the
    carry rounds the magnitude up with the right probability.  torch has
    no uint32 arithmetic: the int32 view adds modulo 2^32 alike, and a
    mask of the kept bits stands in for the logical right shift (the
    fp32 with zeroed low bits converts to bf16 exactly; for fp16 the
    conversion's own rounding then applies, as ``astype`` does in JAX).
    Non-finite inputs bypass the add (random bits would walk an inf into
    the NaN space)."""
    x = x.float()
    _, keep = _SR_BITS[dtype]
    trunc = (x.view(torch.int32) + rnd).bitwise_and_(keep)
    q = trunc.view(torch.float32).to(dtype)
    return torch.where(torch.isfinite(x), q, x.to(dtype))


def stochastic_round(x, dtype, generator):
    """fp32 -> ``dtype`` with stochastic rounding, the random bits drawn
    from ``generator`` (on ``x``'s device).  fp32 passes through."""
    if dtype not in _SR_BITS:
        return x.to(dtype)
    span, _ = _SR_BITS[dtype]
    rnd = torch.randint(0, span, x.shape, dtype=torch.int32,
                        device=x.device, generator=generator)
    return sr_from_bits(x, dtype, rnd)


def ef_store(x32, dtype):
    """fp32 -> (nearest-rounded ``dtype`` value, residual in ``dtype``):
    the residual is the exact rounding error, stored in the same 16-bit
    dtype, so ``up(q) + up(r)`` carries about 16 mantissa bits."""
    q = x32.to(dtype)
    r = (x32 - up32(q)).to(dtype)
    return q, r


def _mix(h, x):
    """One splitmix64 round of ``h`` with ``x`` folded in."""
    h = (h ^ (int(x) & _MASK64)) + 0x9E3779B97F4A7C15 & _MASK64
    h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _MASK64
    return h ^ (h >> 31)


class StateQuant:
    """The storage-dtype plan of the streamed update, built by
    :func:`build_state_quant` only when a buffer is reduced (``None``
    leaves the update the fp32 form).

    - ``master_dtype``: the master's storage dtype;
    - ``leaf_dtypes``: each optimizer-state leaf's storage dtype (``None``
      for the step counter), in the state's field order;
    - ``error_feedback`` / ``rounding``: the write-back rule;
    - ``res_master`` / ``res_leaf_lis``: which buffers carry residuals.
    """

    def __init__(self, master_dtype, leaf_dtypes, leaf_names,
                 error_feedback, rounding, seed):
        self.master_dtype = master_dtype
        self.leaf_dtypes = tuple(leaf_dtypes)
        self.leaf_names = tuple(leaf_names)
        self.error_feedback = bool(error_feedback)
        self.rounding = rounding
        self.seed = int(seed)
        self.res_master = (self.error_feedback
                           and master_dtype != torch.float32)
        self.res_leaf_lis = tuple(
            li for li, dt in enumerate(self.leaf_dtypes)
            if self.error_feedback and dt is not None
            and dt != torch.float32)
        self.stochastic = (rounding == ROUNDING_STOCHASTIC
                           and not self.error_feedback)

    def residual_names(self):
        """The buffers that carry error-feedback residuals."""
        out = ["master"] if self.res_master else []
        out.extend(self.leaf_names[li] for li in self.res_leaf_lis)
        return out

    def dtype_of(self, name):
        """The storage dtype of buffer ``name`` (``master`` or a leaf)."""
        if name == "master":
            return self.master_dtype
        return self.leaf_dtypes[self.leaf_names.index(name)]

    def chunk_key(self, step, tag, slot):
        """The SR seed of one (optimizer step, chunk tag, buffer slot):
        slot 0 is the master, 1 + i the i-th flat leaf, as the JAX
        package folds its keys."""
        h = _mix(_mix(_mix(self.seed, step), tag), slot)
        return h & ((1 << 63) - 1)

    def generator(self, step, tag, slot, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(self.chunk_key(step, tag, slot))
        return gen

    def load(self, q, res=None):
        """Storage chunk (+ its residual chunk) -> fp32 chunk."""
        if q.dtype == torch.float32:
            return q
        y = up32(q)
        if res is not None:
            y = y + up32(res)
        return y

    def store(self, x32, dtype, step=None, tag=None, slot=None):
        """fp32 chunk -> (storage chunk, residual chunk or None)."""
        if dtype == torch.float32:
            return x32, None
        if self.error_feedback:
            return ef_store(x32, dtype)
        if self.stochastic:
            return stochastic_round(
                x32, dtype, self.generator(step, tag, slot, x32.device)), None
        return x32.to(dtype), None


def build_state_quant(state_dtype_cfg, leaves):
    """The ``offload_state_dtype`` block against the optimizer state's
    leaves (``[(name, is_flat)]`` in field order) -> :class:`StateQuant`,
    or ``None`` when everything is fp32.  ``exp_avg`` stores at the
    ``momentum`` dtype, ``exp_avg_sq`` at ``variance``."""
    cfg = state_dtype_cfg or {}
    m_dt = STATE_DTYPES[cfg.get("master", "fp32")]
    mom_dt = STATE_DTYPES[cfg.get("momentum", "fp32")]
    var_dt = STATE_DTYPES[cfg.get("variance", "fp32")]
    if m_dt == mom_dt == var_dt == torch.float32:
        return None
    by_name = {"exp_avg": mom_dt, "exp_avg_sq": var_dt}
    return StateQuant(
        master_dtype=m_dt,
        leaf_dtypes=[by_name.get(n, torch.float32) if flat else None
                     for n, flat in leaves],
        leaf_names=[n for n, _ in leaves],
        error_feedback=bool(cfg.get("error_feedback", False)),
        rounding=cfg.get("rounding", ROUNDING_STOCHASTIC),
        seed=int(cfg.get("seed", 0)))


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


def host_state_bytes_per_step(rows, lanes, quant, n_flat_leaves=2):
    """Bytes one optimizer step moves for the host state: each streamed
    buffer (master, flat optimizer leaves, residuals) crosses the link
    down and up once.  ``quant=None`` is the fp32 layout; gradients
    (``offload_gradients``) are counted apart."""
    elems = rows * lanes
    if quant is None:
        per_buf = [4] * (1 + n_flat_leaves)
    else:
        per_buf = [_itemsize(quant.master_dtype)]
        if quant.res_master:
            per_buf.append(_itemsize(quant.master_dtype))
        for li, dt in enumerate(quant.leaf_dtypes):
            if dt is None:
                continue
            per_buf.append(_itemsize(dt))
            if li in quant.res_leaf_lis:
                per_buf.append(_itemsize(dt))
    return 2 * elems * sum(per_buf)

