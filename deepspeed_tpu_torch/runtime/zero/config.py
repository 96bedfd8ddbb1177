"""ZeRO config subsection (port of ``deepspeed_tpu/runtime/zero/config.py``).

Parses and validates the keys that block shares with the JAX package.
The port's engine runs stages 0, 1 and 2 at one data-parallel rank;
``cpu_offload`` and stage 3 parse here and are refused by the engine
(ROADMAP A9, A8).  The offload tuning keys (``offload_group_mb``,
``offload_uniform_chunks``, ``offload_overlap``,
``offload_prefetch_depth``, ``offload_state_dtype``) are known keys that
only the offload path reads, so they are not parsed here.
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
        if (isinstance(self.offload_chunk_mb, bool)
                or not isinstance(self.offload_chunk_mb, int)
                or self.offload_chunk_mb < 0):
            raise ValueError(
                f"offload_chunk_mb must be a non-negative integer (MB; 0 "
                f"disables chunking), got {self.offload_chunk_mb!r}")
        self.offload_gradients = get_scalar_param(
            d, C.ZERO_OFFLOAD_GRADIENTS, C.ZERO_OFFLOAD_GRADIENTS_DEFAULT)
        if not isinstance(self.offload_gradients, bool):
            raise ValueError(f"offload_gradients must be a bool, got "
                             f"{self.offload_gradients!r}")
        if self.offload_gradients and not self.cpu_offload:
            raise ValueError("offload_gradients requires cpu_offload: true")
        self.elastic_checkpoint = get_scalar_param(
            d, C.ZERO_ELASTIC_CHECKPOINT, C.ZERO_ELASTIC_CHECKPOINT_DEFAULT)

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
                    elastic_checkpoint=self.elastic_checkpoint)

    def __repr__(self):
        return str(self.repr())
