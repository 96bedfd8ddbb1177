"""ZeRO config subsection (port of ``deepspeed_tpu/runtime/zero/config.py``).

Parses and validates every key of the block as the JAX package does,
in its order, so a bad config raises the same error class naming the
same key in both packages.  The port's engine runs stages 0 to 3 at any
data-parallel degree, with ``cpu_offload`` on every mesh (above one
data rank each rank's host state is its rows); ``overlap_comm`` (default ``"auto"``) picks the bucketed
exchange of ``reduce_bucket_size`` buckets and ``allgather_bucket_size``
groups wherever the JAX package does (ROADMAP A8).

Two offload keys exist in the JAX package for XLA alone:
``offload_group_mb`` splits the host state into row groups under XLA's
per-host-buffer size bound (its ``coordinator.py:60-72``) and
``offload_uniform_chunks`` picks a ``lax.scan`` over chunks to bound
XLA's compile time (its ``stream.py:1-30``).  PyTorch has neither
bound: the port keeps one host buffer per state family and one chunk
loop, so both keys are parsed, validated and read by nothing; every
value gives the same result bit for bit.
"""

from .. import constants as C
from ..config_utils import get_scalar_param


def _bucket_size(key, val):
    """A positive element count; integral floats (JSON ``5e8``) pass,
    bools do not (``true`` would mean one element)."""
    if (isinstance(val, float) and not isinstance(val, bool)
            and float(val).is_integer()):
        val = int(val)
    if isinstance(val, bool) or not isinstance(val, int) or val < 1:
        raise ValueError(f"{key} must be a positive integer element count, "
                         f"got {val!r}")
    return val


class DeepSpeedZeroConfig:
    def __init__(self, param_dict):
        d = param_dict.get(C.ZERO_OPTIMIZATION, {})
        if isinstance(d, bool):
            # deprecated boolean form: "zero_optimization": true is stage 1
            d = {C.ZERO_STAGE: 1 if d else 0}
        self.stage = get_scalar_param(d, C.ZERO_STAGE, C.ZERO_STAGE_DEFAULT)
        assert 0 <= self.stage <= C.MAX_STAGE_ZERO_OPTIMIZATION, (
            f"ZeRO stage must be in [0,{C.MAX_STAGE_ZERO_OPTIMIZATION}], got "
            f"{self.stage}")
        self.contiguous_gradients = get_scalar_param(
            d, C.ZERO_CONTIGUOUS_GRADIENTS,
            C.ZERO_CONTIGUOUS_GRADIENTS_DEFAULT)
        self.reduce_scatter = get_scalar_param(d, C.ZERO_REDUCE_SCATTER,
                                               C.ZERO_REDUCE_SCATTER_DEFAULT)
        self.overlap_comm = get_scalar_param(d, C.ZERO_OVERLAP_COMM,
                                             C.ZERO_OVERLAP_COMM_DEFAULT)
        # identity checks: 0/1 must not alias the booleans
        if not (self.overlap_comm is True or self.overlap_comm is False
                or self.overlap_comm == "auto"):
            raise ValueError(f"overlap_comm must be true, false, or \"auto\", "
                             f"got {self.overlap_comm!r}")
        self.reduce_bucket_size = _bucket_size(
            C.ZERO_REDUCE_BUCKET_SIZE,
            get_scalar_param(d, C.ZERO_REDUCE_BUCKET_SIZE,
                             C.ZERO_REDUCE_BUCKET_SIZE_DEFAULT))
        self.allgather_bucket_size = _bucket_size(
            C.ZERO_ALLGATHER_BUCKET_SIZE,
            get_scalar_param(d, C.ZERO_ALLGATHER_BUCKET_SIZE,
                             C.ZERO_ALLGATHER_BUCKET_SIZE_DEFAULT))
        self.cpu_offload = get_scalar_param(d, C.ZERO_CPU_OFFLOAD,
                                            C.ZERO_CPU_OFFLOAD_DEFAULT)
        self.offload_chunk_mb = get_scalar_param(
            d, C.ZERO_OFFLOAD_CHUNK_MB, C.ZERO_OFFLOAD_CHUNK_MB_DEFAULT)
        self.offload_group_mb = get_scalar_param(
            d, C.ZERO_OFFLOAD_GROUP_MB, C.ZERO_OFFLOAD_GROUP_MB_DEFAULT)
        if (isinstance(self.offload_group_mb, bool)
                or not isinstance(self.offload_group_mb, int)
                or not 0 < self.offload_group_mb <= 3584):
            raise ValueError(
                f"offload_group_mb must be an integer in (0, 3584] (the "
                f"JAX package's ~5 GB/host-buffer toolchain bound with "
                f"margin), got {self.offload_group_mb!r}")
        self.offload_uniform_chunks = get_scalar_param(
            d, C.ZERO_OFFLOAD_UNIFORM_CHUNKS,
            C.ZERO_OFFLOAD_UNIFORM_CHUNKS_DEFAULT)
        # identity checks: 0/1 must not alias the booleans
        if not (self.offload_uniform_chunks is True
                or self.offload_uniform_chunks is False
                or self.offload_uniform_chunks == "auto"):
            raise ValueError(
                f"offload_uniform_chunks must be true, false, or \"auto\", "
                f"got {self.offload_uniform_chunks!r}")
        self.offload_gradients = get_scalar_param(
            d, C.ZERO_OFFLOAD_GRADIENTS, C.ZERO_OFFLOAD_GRADIENTS_DEFAULT)
        if not isinstance(self.offload_gradients, bool):
            raise ValueError(f"offload_gradients must be a bool, got "
                             f"{self.offload_gradients!r}")
        if self.offload_gradients and not self.cpu_offload:
            raise ValueError("offload_gradients requires cpu_offload: true")
        if (isinstance(self.offload_chunk_mb, bool)
                or not isinstance(self.offload_chunk_mb, int)
                or self.offload_chunk_mb < 0):
            raise ValueError(
                f"offload_chunk_mb must be a non-negative integer (MB; 0 "
                f"disables chunking), got {self.offload_chunk_mb!r}")
        self.offload_overlap = get_scalar_param(
            d, C.ZERO_OFFLOAD_OVERLAP, C.ZERO_OFFLOAD_OVERLAP_DEFAULT)
        if not (self.offload_overlap is True
                or self.offload_overlap is False
                or self.offload_overlap == "auto"):
            raise ValueError(
                f"offload_overlap must be true, false, or \"auto\", got "
                f"{self.offload_overlap!r}")
        self.offload_prefetch_depth = get_scalar_param(
            d, C.ZERO_OFFLOAD_PREFETCH_DEPTH,
            C.ZERO_OFFLOAD_PREFETCH_DEPTH_DEFAULT)
        if (isinstance(self.offload_prefetch_depth, bool)
                or not isinstance(self.offload_prefetch_depth, int)
                or self.offload_prefetch_depth < 1):
            raise ValueError(
                f"offload_prefetch_depth must be an integer >= 1 (chunks "
                f"in flight; 1 = serialized), got "
                f"{self.offload_prefetch_depth!r}")
        if self.offload_overlap is True and not self.cpu_offload:
            raise ValueError(
                "offload_overlap: true requires cpu_offload: true (it "
                "schedules the streamed host<->device update)")
        self.elastic_checkpoint = get_scalar_param(
            d, C.ZERO_ELASTIC_CHECKPOINT, C.ZERO_ELASTIC_CHECKPOINT_DEFAULT)
        self.offload_state_dtype = self._parse_state_dtype(
            d.get(C.ZERO_OFFLOAD_STATE_DTYPE))

    def _parse_state_dtype(self, raw):
        """``offload_state_dtype`` -> its canonical dict (JAX
        ``zero/config.py:527-611``).  The shorthand string sets momentum
        and variance to that dtype and the master to bf16 (fp16's 5-bit
        exponent cannot hold master weights); ``"fp32"`` is the
        default."""
        dtypes = ("fp32", "bf16", "fp16")
        out = {
            C.ZERO_OFFLOAD_STATE_DTYPE_MASTER:
                C.ZERO_OFFLOAD_STATE_DTYPE_MASTER_DEFAULT,
            C.ZERO_OFFLOAD_STATE_DTYPE_MOMENTUM:
                C.ZERO_OFFLOAD_STATE_DTYPE_MOMENTUM_DEFAULT,
            C.ZERO_OFFLOAD_STATE_DTYPE_VARIANCE:
                C.ZERO_OFFLOAD_STATE_DTYPE_VARIANCE_DEFAULT,
            C.ZERO_OFFLOAD_STATE_DTYPE_ERROR_FEEDBACK:
                C.ZERO_OFFLOAD_STATE_DTYPE_ERROR_FEEDBACK_DEFAULT,
            C.ZERO_OFFLOAD_STATE_DTYPE_ROUNDING:
                C.ZERO_OFFLOAD_STATE_DTYPE_ROUNDING_DEFAULT,
            C.ZERO_OFFLOAD_STATE_DTYPE_SEED:
                C.ZERO_OFFLOAD_STATE_DTYPE_SEED_DEFAULT,
        }
        if raw is None:
            return out
        if isinstance(raw, str):
            if raw not in dtypes:
                raise ValueError(
                    f"offload_state_dtype shorthand must be one of "
                    f"{dtypes}, got {raw!r}")
            out[C.ZERO_OFFLOAD_STATE_DTYPE_MOMENTUM] = raw
            out[C.ZERO_OFFLOAD_STATE_DTYPE_VARIANCE] = raw
            out[C.ZERO_OFFLOAD_STATE_DTYPE_MASTER] = (
                "bf16" if raw != "fp32" else "fp32")
            raw = {}
        if not isinstance(raw, dict):
            raise ValueError(
                f"offload_state_dtype must be a dict or a dtype-name "
                f"shorthand string, got {raw!r}")
        for key in (C.ZERO_OFFLOAD_STATE_DTYPE_MASTER,
                    C.ZERO_OFFLOAD_STATE_DTYPE_MOMENTUM,
                    C.ZERO_OFFLOAD_STATE_DTYPE_VARIANCE):
            val = raw.get(key, out[key])
            if val not in dtypes:
                raise ValueError(
                    f"offload_state_dtype.{key} must be one of {dtypes}, "
                    f"got {val!r}")
            out[key] = val
        if out[C.ZERO_OFFLOAD_STATE_DTYPE_MASTER] == "fp16":
            raise ValueError(
                "offload_state_dtype.master does not support fp16 (5-bit "
                "exponent: master weights over/underflow); use bf16")
        ef = raw.get(C.ZERO_OFFLOAD_STATE_DTYPE_ERROR_FEEDBACK,
                     out[C.ZERO_OFFLOAD_STATE_DTYPE_ERROR_FEEDBACK])
        if not isinstance(ef, bool):
            raise ValueError(
                f"offload_state_dtype.error_feedback must be a bool, got "
                f"{ef!r}")
        out[C.ZERO_OFFLOAD_STATE_DTYPE_ERROR_FEEDBACK] = ef
        rounding = raw.get(C.ZERO_OFFLOAD_STATE_DTYPE_ROUNDING,
                           out[C.ZERO_OFFLOAD_STATE_DTYPE_ROUNDING])
        if rounding not in ("stochastic", "nearest"):
            raise ValueError(
                f"offload_state_dtype.rounding must be \"stochastic\" or "
                f"\"nearest\", got {rounding!r}")
        out[C.ZERO_OFFLOAD_STATE_DTYPE_ROUNDING] = rounding
        seed = raw.get(C.ZERO_OFFLOAD_STATE_DTYPE_SEED,
                       out[C.ZERO_OFFLOAD_STATE_DTYPE_SEED])
        if isinstance(seed, bool) or not isinstance(seed, int):
            raise ValueError(
                f"offload_state_dtype.seed must be an int, got {seed!r}")
        out[C.ZERO_OFFLOAD_STATE_DTYPE_SEED] = seed
        if self._reduced(out) and not self.cpu_offload:
            raise ValueError(
                "offload_state_dtype with reduced dtypes requires "
                "cpu_offload: true (it compresses the pinned host state "
                "the streamed update moves)")
        return out

    @staticmethod
    def _reduced(sd):
        return any(sd[k] != "fp32" for k in (
            C.ZERO_OFFLOAD_STATE_DTYPE_MASTER,
            C.ZERO_OFFLOAD_STATE_DTYPE_MOMENTUM,
            C.ZERO_OFFLOAD_STATE_DTYPE_VARIANCE))

    @property
    def offload_state_reduced(self):
        """True when any host state buffer is stored below fp32."""
        return self._reduced(self.offload_state_dtype)

    @property
    def offload_state_residual_count(self):
        """The error-feedback residual buffers the layout carries (0
        unless ``error_feedback`` is on): one per reduced buffer."""
        sd = self.offload_state_dtype
        if not sd[C.ZERO_OFFLOAD_STATE_DTYPE_ERROR_FEEDBACK]:
            return 0
        return sum(sd[k] != "fp32" for k in (
            C.ZERO_OFFLOAD_STATE_DTYPE_MASTER,
            C.ZERO_OFFLOAD_STATE_DTYPE_MOMENTUM,
            C.ZERO_OFFLOAD_STATE_DTYPE_VARIANCE))

    def repr(self):
        return dict(stage=self.stage,
                    contiguous_gradients=self.contiguous_gradients,
                    reduce_scatter=self.reduce_scatter,
                    reduce_bucket_size=self.reduce_bucket_size,
                    allgather_bucket_size=self.allgather_bucket_size,
                    overlap_comm=self.overlap_comm,
                    cpu_offload=self.cpu_offload,
                    offload_chunk_mb=self.offload_chunk_mb,
                    offload_gradients=self.offload_gradients,
                    offload_uniform_chunks=self.offload_uniform_chunks,
                    offload_group_mb=self.offload_group_mb,
                    offload_overlap=self.offload_overlap,
                    offload_prefetch_depth=self.offload_prefetch_depth,
                    offload_state_dtype=self.offload_state_dtype,
                    elastic_checkpoint=self.elastic_checkpoint)

    def __repr__(self):
        return str(self.repr())
