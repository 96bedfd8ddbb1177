"""``"inference"`` config block (port of ``deepspeed_tpu/inference/config.py``).

Typed view of the serving subsection.  Every knob here is a shape knob:
the engine runs one decode step of fixed width and one prefill per
declared bucket, so the set of shapes the serve loop sees is bounded by
``len(prefill_buckets) + 1``.
"""

from ..runtime import constants as C
from ..runtime.config_utils import get_scalar_param


class DeepSpeedInferenceConfig:
    """Typed view of the ``inference`` subsection (all keys optional)."""

    def __init__(self, param_dict):
        inf = param_dict.get(C.INFERENCE, {}) or {}
        self.kv_block_size = int(get_scalar_param(
            inf, C.INFERENCE_KV_BLOCK_SIZE,
            C.INFERENCE_KV_BLOCK_SIZE_DEFAULT))
        self.kv_blocks = int(get_scalar_param(
            inf, C.INFERENCE_KV_BLOCKS, C.INFERENCE_KV_BLOCKS_DEFAULT))
        self.max_batch_slots = int(get_scalar_param(
            inf, C.INFERENCE_MAX_BATCH_SLOTS,
            C.INFERENCE_MAX_BATCH_SLOTS_DEFAULT))
        self.max_seq_len = int(get_scalar_param(
            inf, C.INFERENCE_MAX_SEQ_LEN, C.INFERENCE_MAX_SEQ_LEN_DEFAULT))
        buckets = get_scalar_param(inf, C.INFERENCE_PREFILL_BUCKETS,
                                   C.INFERENCE_PREFILL_BUCKETS_DEFAULT)
        self.prefill_buckets = tuple(sorted(int(b) for b in buckets))
        self.token_budget = int(get_scalar_param(
            inf, C.INFERENCE_TOKEN_BUDGET, C.INFERENCE_TOKEN_BUDGET_DEFAULT))
        self.max_new_tokens = int(get_scalar_param(
            inf, C.INFERENCE_MAX_NEW_TOKENS,
            C.INFERENCE_MAX_NEW_TOKENS_DEFAULT))
        self.eos_token_id = int(get_scalar_param(
            inf, C.INFERENCE_EOS_TOKEN_ID, C.INFERENCE_EOS_TOKEN_ID_DEFAULT))
        self.weights_dtype = str(get_scalar_param(
            inf, C.INFERENCE_WEIGHTS_DTYPE,
            C.INFERENCE_WEIGHTS_DTYPE_DEFAULT))
        self.request_deadline_ms = int(get_scalar_param(
            inf, C.INFERENCE_REQUEST_DEADLINE_MS,
            C.INFERENCE_REQUEST_DEADLINE_MS_DEFAULT))
        self.max_queue_depth = int(get_scalar_param(
            inf, C.INFERENCE_MAX_QUEUE_DEPTH,
            C.INFERENCE_MAX_QUEUE_DEPTH_DEFAULT))
        self.degrade_queue_depth = int(get_scalar_param(
            inf, C.INFERENCE_DEGRADE_QUEUE_DEPTH,
            C.INFERENCE_DEGRADE_QUEUE_DEPTH_DEFAULT))
        self.degraded_max_new_tokens = int(get_scalar_param(
            inf, C.INFERENCE_DEGRADED_MAX_NEW_TOKENS,
            C.INFERENCE_DEGRADED_MAX_NEW_TOKENS_DEFAULT))
        slo = inf.get(C.INFERENCE_SLO, {}) or {}
        self.slo_ttft_ms = float(get_scalar_param(
            slo, C.INFERENCE_SLO_TTFT_MS, C.INFERENCE_SLO_TTFT_MS_DEFAULT))
        self.slo_per_token_ms = float(get_scalar_param(
            slo, C.INFERENCE_SLO_PER_TOKEN_MS,
            C.INFERENCE_SLO_PER_TOKEN_MS_DEFAULT))
        self._check()

    def _check(self):
        bs = self.kv_block_size
        assert bs > 0, "inference.kv_block_size must be > 0"
        assert self.kv_blocks > 1, (
            "inference.kv_blocks must be > 1 (block 0 is the reserved "
            "null block inactive decode slots write into)")
        assert self.max_batch_slots > 0, (
            "inference.max_batch_slots must be > 0")
        assert self.max_seq_len % bs == 0, (
            f"inference.max_seq_len ({self.max_seq_len}) must be a "
            f"multiple of kv_block_size ({bs}) — the block table covers "
            "the context in whole blocks")
        assert self.prefill_buckets, "inference.prefill_buckets is empty"
        for b in self.prefill_buckets:
            assert 0 < b <= self.max_seq_len and b % bs == 0, (
                f"prefill bucket {b} must be a positive multiple of "
                f"kv_block_size ({bs}) no larger than max_seq_len "
                f"({self.max_seq_len}) — prefill writes whole blocks")
        assert self.token_budget > 0, "inference.token_budget must be > 0"
        assert self.max_new_tokens > 0, (
            "inference.max_new_tokens must be > 0")
        assert self.weights_dtype in ("float32", "bfloat16"), (
            f"inference.weights_dtype must be 'float32' or 'bfloat16', "
            f"got {self.weights_dtype!r}")
        assert self.request_deadline_ms >= 0, (
            "inference.request_deadline_ms must be >= 0 (0 disables)")
        assert self.max_queue_depth >= 0, (
            "inference.max_queue_depth must be >= 0 (0 = unbounded)")
        assert self.degrade_queue_depth >= 0, (
            "inference.degrade_queue_depth must be >= 0 (0 disables)")
        assert 0 < self.degraded_max_new_tokens <= self.max_new_tokens, (
            f"inference.degraded_max_new_tokens "
            f"({self.degraded_max_new_tokens}) must be in "
            f"[1, max_new_tokens={self.max_new_tokens}] — degradation "
            "shortens answers, it never lengthens them")
        assert self.slo_ttft_ms >= 0, (
            "inference.slo.ttft_ms must be >= 0 (0 disables)")
        assert self.slo_per_token_ms >= 0, (
            "inference.slo.per_token_ms must be >= 0 (0 disables)")
        if self.max_queue_depth and self.degrade_queue_depth:
            assert self.degrade_queue_depth <= self.max_queue_depth, (
                f"inference.degrade_queue_depth "
                f"({self.degrade_queue_depth}) must not exceed "
                f"max_queue_depth ({self.max_queue_depth}) — degradation "
                "is the pressure valve BEFORE shedding, not after")

    @property
    def max_blocks_per_seq(self):
        return self.max_seq_len // self.kv_block_size

    def bucket_for(self, prompt_len):
        """Smallest declared prefill bucket that fits ``prompt_len``;
        raises when the prompt exceeds every bucket (the front-end
        rejects such requests at submission, not mid-serve)."""
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the largest prefill "
            f"bucket {self.prefill_buckets[-1]}")

    def __repr__(self):
        return (f"DeepSpeedInferenceConfig(kv_block_size="
                f"{self.kv_block_size}, kv_blocks={self.kv_blocks}, "
                f"max_batch_slots={self.max_batch_slots}, max_seq_len="
                f"{self.max_seq_len}, prefill_buckets="
                f"{self.prefill_buckets}, token_budget={self.token_budget})")
