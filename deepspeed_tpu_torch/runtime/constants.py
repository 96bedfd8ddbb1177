"""Config keys serving reads (port of ``deepspeed_tpu/runtime/constants.py``:
``STEPS_PER_PRINT``, the ``inference`` block at ``:517-586`` and
``STRICT_CONFIG``).  Key strings and defaults are the JAX package's, so
one config dict drives either engine."""

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

#############################################
# Inference / serving (deepspeed_tpu_torch/inference): continuous
# batching over a paged KV cache.  The prefill buckets bound the set of
# prefill shapes, as in the JAX package.
#############################################
INFERENCE = "inference"
# tokens per KV-cache block (the paged-allocation granularity; the
# prefill buckets and max_seq_len must be multiples of it)
INFERENCE_KV_BLOCK_SIZE = "kv_block_size"
INFERENCE_KV_BLOCK_SIZE_DEFAULT = 16
# total preallocated KV blocks per layer (the device-memory budget:
# 2 * layers * kv_blocks * kv_block_size * hidden * dtype bytes)
INFERENCE_KV_BLOCKS = "kv_blocks"
INFERENCE_KV_BLOCKS_DEFAULT = 256
# decode batch width: the fixed slot count of the decode step
INFERENCE_MAX_BATCH_SLOTS = "max_batch_slots"
INFERENCE_MAX_BATCH_SLOTS_DEFAULT = 4
# longest context (prompt + generated) a sequence may reach; bounds the
# per-slot block-table width
INFERENCE_MAX_SEQ_LEN = "max_seq_len"
INFERENCE_MAX_SEQ_LEN_DEFAULT = 64
# padded prefill lengths, ascending: each prompt runs at the smallest
# bucket that fits
INFERENCE_PREFILL_BUCKETS = "prefill_buckets"
INFERENCE_PREFILL_BUCKETS_DEFAULT = (16, 32, 64)
# admission budget: a request is admitted only while the sum of
# (context + remaining generation) tokens over active slots stays
# under this — the Orca iteration-level admission knob
INFERENCE_TOKEN_BUDGET = "token_budget"
INFERENCE_TOKEN_BUDGET_DEFAULT = 2048
# per-request generation cap when the request does not set one
INFERENCE_MAX_NEW_TOKENS = "max_new_tokens"
INFERENCE_MAX_NEW_TOKENS_DEFAULT = 16
# stop token: a slot emitting it is finished and recycled mid-batch
# (-1 disables — fixed-length generation)
INFERENCE_EOS_TOKEN_ID = "eos_token_id"
INFERENCE_EOS_TOKEN_ID_DEFAULT = -1
# serve-time weight dtype: "bfloat16" casts every floating-point leaf
# at ingestion; "float32" keeps the checkpoint dtype
INFERENCE_WEIGHTS_DTYPE = "weights_dtype"
INFERENCE_WEIGHTS_DTYPE_DEFAULT = "float32"
# per-request wall-clock deadline in milliseconds (0 disables)
INFERENCE_REQUEST_DEADLINE_MS = "request_deadline_ms"
INFERENCE_REQUEST_DEADLINE_MS_DEFAULT = 0
# front-end admission bound and graceful degradation (read by the
# serving front-end, which a later slice ports; parsed and checked here
# so one config dict is valid for both packages)
INFERENCE_MAX_QUEUE_DEPTH = "max_queue_depth"
INFERENCE_MAX_QUEUE_DEPTH_DEFAULT = 0
INFERENCE_DEGRADE_QUEUE_DEPTH = "degrade_queue_depth"
INFERENCE_DEGRADE_QUEUE_DEPTH_DEFAULT = 0
INFERENCE_DEGRADED_MAX_NEW_TOKENS = "degraded_max_new_tokens"
INFERENCE_DEGRADED_MAX_NEW_TOKENS_DEFAULT = 4
# "slo": {"ttft_ms": ..., "per_token_ms": ...} serving SLO targets
INFERENCE_SLO = "slo"
INFERENCE_SLO_TTFT_MS = "ttft_ms"
INFERENCE_SLO_TTFT_MS_DEFAULT = 0
INFERENCE_SLO_PER_TOKEN_MS = "per_token_ms"
INFERENCE_SLO_PER_TOKEN_MS_DEFAULT = 0

# every key the ``inference`` block and its ``slo`` sub-block may hold
INFERENCE_KEYS = frozenset((
    INFERENCE_KV_BLOCK_SIZE, INFERENCE_KV_BLOCKS, INFERENCE_MAX_BATCH_SLOTS,
    INFERENCE_MAX_SEQ_LEN, INFERENCE_PREFILL_BUCKETS, INFERENCE_TOKEN_BUDGET,
    INFERENCE_MAX_NEW_TOKENS, INFERENCE_EOS_TOKEN_ID,
    INFERENCE_WEIGHTS_DTYPE, INFERENCE_REQUEST_DEADLINE_MS,
    INFERENCE_MAX_QUEUE_DEPTH, INFERENCE_DEGRADE_QUEUE_DEPTH,
    INFERENCE_DEGRADED_MAX_NEW_TOKENS, INFERENCE_SLO))
INFERENCE_SLO_KEYS = frozenset((INFERENCE_SLO_TTFT_MS,
                                INFERENCE_SLO_PER_TOKEN_MS))

# "strict_config": true turns unknown-key warnings into errors
STRICT_CONFIG = "strict_config"
STRICT_CONFIG_DEFAULT = False
