"""Config keys and defaults (port of ``deepspeed_tpu/runtime/constants.py``:
the batch triple, optimizer, scheduler, precision, clipping, logging and
ZeRO keys the training engine reads, the ``checkpoint`` block at
``:313-335``, the ``inference`` block at ``:517-586`` and
``STRICT_CONFIG``).  Key strings and defaults are the
JAX package's, so one config dict drives either engine.  ``KNOWN_KEYS``
and ``SECTION_KEYS`` list every key the JAX package's schema knows
(``deepspeed_tpu/tools/dslint/schema.py``), for the unknown-key check;
``UNPORTED_SECTIONS`` names the blocks the port parses but does not
implement yet, with the ROADMAP item that ports each."""

#############################################
# Batch
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"
ADAM_OPTIMIZER = "adam"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER]
ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False

#############################################
# Precision and clipping
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
# 0 selects dynamic loss scaling; any other value is a static scale
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1
BF16 = "bf16"
BF16_ENABLED = "enabled"
BF16_ENABLED_DEFAULT = False
AMP = "amp"
AMP_ENABLED = "enabled"
AMP_ENABLED_DEFAULT = False
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
# engine rng seed (dropout streams)
SEED = "seed"
SEED_DEFAULT = 0

#############################################
# Logging
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

#############################################
# ZeRO (reference runtime/zero/constants.py)
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
ZERO_OPTIMIZATION_DISABLED = 0
ZERO_OPTIMIZATION_OPTIMIZER_STATES = 1
ZERO_OPTIMIZATION_GRADIENTS = 2
ZERO_OPTIMIZATION_WEIGHTS = 3
MAX_STAGE_ZERO_OPTIMIZATION = ZERO_OPTIMIZATION_WEIGHTS
ZERO_STAGE = "stage"
ZERO_STAGE_DEFAULT = ZERO_OPTIMIZATION_DISABLED
ZERO_REDUCE_SCATTER = "reduce_scatter"
ZERO_REDUCE_SCATTER_DEFAULT = True
ZERO_REDUCE_BUCKET_SIZE = "reduce_bucket_size"
ZERO_REDUCE_BUCKET_SIZE_DEFAULT = 500000000
ZERO_ALLGATHER_BUCKET_SIZE = "allgather_bucket_size"
ZERO_ALLGATHER_BUCKET_SIZE_DEFAULT = 500000000
ZERO_OVERLAP_COMM = "overlap_comm"
ZERO_OVERLAP_COMM_DEFAULT = "auto"
ZERO_CONTIGUOUS_GRADIENTS = "contiguous_gradients"
ZERO_CONTIGUOUS_GRADIENTS_DEFAULT = False
ZERO_CPU_OFFLOAD = "cpu_offload"
ZERO_CPU_OFFLOAD_DEFAULT = False
ZERO_OFFLOAD_CHUNK_MB = "offload_chunk_mb"
ZERO_OFFLOAD_CHUNK_MB_DEFAULT = 512
ZERO_OFFLOAD_GRADIENTS = "offload_gradients"
ZERO_OFFLOAD_GRADIENTS_DEFAULT = False
ZERO_ELASTIC_CHECKPOINT = "elastic_checkpoint"
ZERO_ELASTIC_CHECKPOINT_DEFAULT = True
# the offload tuning keys of the JAX package's (:672-741), with its
# defaults.  offload_uniform_chunks and offload_group_mb exist there for
# XLA's compile time and its per-host-buffer size bound; the port parses
# and validates them and nothing reads them (zero/config.py)
ZERO_OFFLOAD_UNIFORM_CHUNKS = "offload_uniform_chunks"
ZERO_OFFLOAD_UNIFORM_CHUNKS_DEFAULT = "auto"
ZERO_OFFLOAD_GROUP_MB = "offload_group_mb"
ZERO_OFFLOAD_GROUP_MB_DEFAULT = 1792
# fetch chunk k+d-1 while chunk k updates ("auto": whenever the update
# streams; false: depth 1, the serialized schedule)
ZERO_OFFLOAD_OVERLAP = "offload_overlap"
ZERO_OFFLOAD_OVERLAP_DEFAULT = "auto"
ZERO_OFFLOAD_PREFETCH_DEPTH = "offload_prefetch_depth"
ZERO_OFFLOAD_PREFETCH_DEPTH_DEFAULT = 2
# reduced-precision host state (zero/qstate.py): a sub-block, or the
# shorthand "bf16"/"fp16"
ZERO_OFFLOAD_STATE_DTYPE = "offload_state_dtype"
ZERO_OFFLOAD_STATE_DTYPE_MASTER = "master"
ZERO_OFFLOAD_STATE_DTYPE_MASTER_DEFAULT = "fp32"
ZERO_OFFLOAD_STATE_DTYPE_MOMENTUM = "momentum"
ZERO_OFFLOAD_STATE_DTYPE_MOMENTUM_DEFAULT = "fp32"
ZERO_OFFLOAD_STATE_DTYPE_VARIANCE = "variance"
ZERO_OFFLOAD_STATE_DTYPE_VARIANCE_DEFAULT = "fp32"
ZERO_OFFLOAD_STATE_DTYPE_ERROR_FEEDBACK = "error_feedback"
ZERO_OFFLOAD_STATE_DTYPE_ERROR_FEEDBACK_DEFAULT = False
ZERO_OFFLOAD_STATE_DTYPE_ROUNDING = "rounding"
ZERO_OFFLOAD_STATE_DTYPE_ROUNDING_DEFAULT = "stochastic"
ZERO_OFFLOAD_STATE_DTYPE_SEED = "seed"
ZERO_OFFLOAD_STATE_DTYPE_SEED_DEFAULT = 0

#############################################
# Schema: every key the JAX package knows
#############################################
KNOWN_KEYS = frozenset((
    "activation_checkpointing", "allgather_size", AMP, BF16, "checkpoint",
    "compilation", "disable_allgather", "dump_state", "elasticity",
    "flops_profiler", FP16, "fp32_allreduce", GRADIENT_ACCUMULATION_STEPS,
    GRADIENT_CLIPPING, "gradient_predivide_factor", "inference",
    "memory_breakdown", "mesh", OPTIMIZER, "pipeline", "prescale_gradients",
    "prng_impl", "profiling", "progressive_layer_drop", "resilience",
    "ring_attention", SCHEDULER, SEED, "sparse_attention", "sparse_gradients",
    STEPS_PER_PRINT, "strict_config", "telemetry", "tensorboard",
    TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU, "vocabulary_size",
    WALL_CLOCK_BREAKDOWN, ZERO_ALLOW_UNTESTED_OPTIMIZER, ZERO_OPTIMIZATION))
SECTION_KEYS = {
    AMP: ("enabled",),
    BF16: ("enabled",),
    FP16: ("enabled", "hysteresis", "initial_scale_power", "loss_scale",
           "loss_scale_window", "min_loss_scale"),
    OPTIMIZER: ("legacy_fusion", "max_grad_norm", "params", "type"),
    SCHEDULER: ("params", "type"),
    ZERO_OPTIMIZATION: (
        "allgather_bucket_size", "contiguous_gradients", "cpu_offload",
        "elastic_checkpoint", "offload_chunk_mb", "offload_gradients",
        "offload_group_mb", "offload_overlap", "offload_prefetch_depth",
        "offload_state_dtype", "offload_uniform_chunks", "overlap_comm",
        "reduce_bucket_size", "reduce_scatter", "stage"),
    "activation_checkpointing": (
        "contiguous_memory_optimization", "cpu_checkpointing",
        "number_checkpoints", "partition_activations", "profile",
        "synchronize_checkpoint_boundary"),
    "checkpoint": ("async_save", "keep_every_n_steps", "keep_last_n",
                   "retry_backoff_secs", "save_on_preemption",
                   "save_retries", "verify_on_load"),
    "compilation": ("cache", "cache_dir", "min_compile_secs",
                    "min_entry_size_bytes"),
    "elasticity": ("enabled", "ignore_non_elastic_batch_info", "max_gpus",
                   "max_train_batch_size", "micro_batch_sizes", "min_gpus",
                   "min_time", "prefer_larger_batch", "version"),
    "flops_profiler": ("detailed", "enabled", "module_depth", "profile_step",
                       "top_modules"),
    "mesh": ("data", "model", "pipe", "seq"),
    "pipeline": ("activation_checkpoint_interval", "partition",
                 "seed_layers", "stages"),
    "profiling": ("comm_ledger", "memory_ledger", "memory_watermarks",
                  "program_dump"),
    "progressive_layer_drop": ("enabled", "gamma", "theta"),
    "resilience": ("checkpoint_dir", "divergence_patience", "enabled",
                   "floor_scale_patience", "hang_timeout_secs", "integrity",
                   "integrity_action", "integrity_peer_timeout_secs",
                   "integrity_window", "max_rollbacks", "policy",
                   "rollback_cooldown_steps", "spike_window", "spike_zscore",
                   "straggler_factor"),
    "resilience": (
        "checkpoint_dir", "divergence_patience", "enabled",
        "floor_scale_patience", "hang_timeout_secs", "integrity",
        "integrity_action", "integrity_peer_timeout_secs",
        "integrity_window", "max_rollbacks", "policy",
        "rollback_cooldown_steps", "spike_window", "spike_zscore",
        "straggler_factor"),
    "ring_attention": ("enabled",),
    "sparse_attention": (
        "attention", "block", "different_layout_per_head",
        "global_block_end_indices", "global_block_indices",
        "horizontal_global_attention", "local_window_blocks", "mode",
        "num_different_global_patterns", "num_global_blocks",
        "num_local_blocks", "num_random_blocks",
        "num_sliding_window_blocks"),
    "telemetry": ("device_trace_secs", "device_trace_trigger", "enabled",
                  "events", "run_dir", "trace", "trace_max_events"),
    "tensorboard": ("enabled", "job_name", "output_path"),
}
# blocks the port parses but does not implement yet -> ROADMAP item
UNPORTED_SECTIONS = {
    "compilation": "A16", "elasticity": "A15", "flops_profiler": "A16",
    "pipeline": "A13", "profiling": "A12/A16",
    "ring_attention": "A10", "telemetry": "A12", "tensorboard": "A12",
}

#############################################
# Data parallelism: the "mesh" block (axis sizes; data -1 is the whole
# torch.distributed world), the JAX package's :267-271.  Its axes other
# than data are ROADMAP A10 (model, seq, expert) and A13 (pipe)
#############################################
MESH = "mesh"
MESH_DATA = "data"
MESH_MODEL = "model"
MESH_PIPE = "pipe"
MESH_SEQ = "seq"
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

#############################################
# Progressive Layer Drop (the JAX package's :254-262)
#############################################
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001

#############################################
# Checkpoint subsystem (deepspeed_tpu_torch/checkpoint): the
# "checkpoint" block, keys and defaults of the JAX package's (:313-335)
#############################################
CHECKPOINT = "checkpoint"
# hand the host-side snapshot to a background writer thread so
# train_batch resumes immediately; commits stay atomic either way
CHECKPOINT_ASYNC_SAVE = "async_save"
CHECKPOINT_ASYNC_SAVE_DEFAULT = True
# retention: keep the newest N committed checkpoints (0 = keep all) ...
CHECKPOINT_KEEP_LAST_N = "keep_last_n"
CHECKPOINT_KEEP_LAST_N_DEFAULT = 0
# ... plus every checkpoint whose step is a multiple of this (0 = none)
CHECKPOINT_KEEP_EVERY_N_STEPS = "keep_every_n_steps"
CHECKPOINT_KEEP_EVERY_N_STEPS_DEFAULT = 0
# re-checksum payload files against the manifest before restoring
CHECKPOINT_VERIFY_ON_LOAD = "verify_on_load"
CHECKPOINT_VERIFY_ON_LOAD_DEFAULT = True
# retries (beyond the first attempt) for a failed commit, with
# exponential backoff starting at retry_backoff_secs
CHECKPOINT_SAVE_RETRIES = "save_retries"
CHECKPOINT_SAVE_RETRIES_DEFAULT = 2
CHECKPOINT_RETRY_BACKOFF_SECS = "retry_backoff_secs"
CHECKPOINT_RETRY_BACKOFF_SECS_DEFAULT = 0.5
# drain in-flight saves and take one final synchronous save on SIGTERM
CHECKPOINT_SAVE_ON_PREEMPTION = "save_on_preemption"
CHECKPOINT_SAVE_ON_PREEMPTION_DEFAULT = False

#############################################
# Resilience subsystem (deepspeed_tpu_torch/resilience): the "resilience"
# block, keys and defaults of the JAX package's (:336-404).  The
# integrity keys are parsed and refused when on: the fleet integrity
# plane is ROADMAP A15's second half
#############################################
RESILIENCE = "resilience"
RESILIENCE_ENABLED = "enabled"
RESILIENCE_ENABLED_DEFAULT = False
# what to do about anomalous steps beyond the always-on skip of
# non-finite updates: skip | rescale | rollback | abort
RESILIENCE_POLICY = "policy"
RESILIENCE_POLICY_DEFAULT = "skip"
# rolling window (in steps) for the loss-spike z-score; 0 disables
# spike detection (non-finite detection stays on)
RESILIENCE_SPIKE_WINDOW = "spike_window"
RESILIENCE_SPIKE_WINDOW_DEFAULT = 64
RESILIENCE_SPIKE_ZSCORE = "spike_zscore"
RESILIENCE_SPIKE_ZSCORE_DEFAULT = 6.0
# consecutive anomalous steps before rollback/abort policies escalate
RESILIENCE_DIVERGENCE_PATIENCE = "divergence_patience"
RESILIENCE_DIVERGENCE_PATIENCE_DEFAULT = 3
# rollback budget per run; exhausting it aborts with the poison code
RESILIENCE_MAX_ROLLBACKS = "max_rollbacks"
RESILIENCE_MAX_ROLLBACKS_DEFAULT = 2
# re-diverging within this many steps of the restored step = thrashing
RESILIENCE_ROLLBACK_COOLDOWN_STEPS = "rollback_cooldown_steps"
RESILIENCE_ROLLBACK_COOLDOWN_STEPS_DEFAULT = 0
# step watchdog: heartbeat stall (seconds) before the all-thread stack
# dump + respawnable exit; 0 disables the watchdog
RESILIENCE_HANG_TIMEOUT_SECS = "hang_timeout_secs"
RESILIENCE_HANG_TIMEOUT_SECS_DEFAULT = 0.0
# consecutive overflows with the fp16 loss scale pinned at min_scale
# before the guard declares the scaler stuck (loud error + anomaly event)
RESILIENCE_FLOOR_SCALE_PATIENCE = "floor_scale_patience"
RESILIENCE_FLOOR_SCALE_PATIENCE_DEFAULT = 8
# where rollback + auto_resume look for the latest committed checkpoint;
# default: the last directory this engine saved to or loaded from
RESILIENCE_CHECKPOINT_DIR = "checkpoint_dir"
RESILIENCE_CHECKPOINT_DIR_DEFAULT = None
# straggler detection: a rank whose p50 step latency exceeds this
# multiple of the fleet median (per-rank latency exchange, sampled at
# the steps_per_print cadence) raises a "straggler" anomaly event.
# 0 disables; needs telemetry (the run dir is the exchange medium)
RESILIENCE_STRAGGLER_FACTOR = "straggler_factor"
RESILIENCE_STRAGGLER_FACTOR_DEFAULT = 0.0
# fleet integrity plane (resilience/integrity.py): per-rank state
# fingerprints (a cheap on-device checksum over the flat master +
# optimizer state, riding the existing batched steps_per_print fetch)
# cross-checked by majority vote over run-dir artifacts — an SDC/desync
# suspect is named, reported to the supervisor, and evicted on resize.
# Needs telemetry (the run dir is the exchange medium)
RESILIENCE_INTEGRITY = "integrity"
RESILIENCE_INTEGRITY_DEFAULT = False
# fingerprint history steps each rank publishes (voting scans the
# window, so ranks whose publishes lag the fleet head are still judged)
RESILIENCE_INTEGRITY_WINDOW = "integrity_window"
RESILIENCE_INTEGRITY_WINDOW_DEFAULT = 8
# evict: verdict file + FleetIntegrityError (exit 87, the supervisor
# resizes around the suspect); warn: telemetry events only (use on
# meshes that shard state across processes, where per-process
# fingerprints legitimately differ)
RESILIENCE_INTEGRITY_ACTION = "integrity_action"
RESILIENCE_INTEGRITY_ACTION_DEFAULT = "evict"
# fleet heartbeat + hang quorum: a peer whose step-entry beat lags the
# fleet head and goes stale by this many seconds is the hang suspect
# (healthy ranks exit with ONE respawnable eviction instead of N local
# watchdog timeouts).  0 disables the heartbeat thread
RESILIENCE_INTEGRITY_PEER_TIMEOUT_SECS = "integrity_peer_timeout_secs"
RESILIENCE_INTEGRITY_PEER_TIMEOUT_SECS_DEFAULT = 0.0

#############################################
# Sparse attention: the "sparse_attention" block, one mode of
# ops/sparse_attention/sparsity_config.py with that class's defaults
#############################################
SPARSE_ATTENTION = "sparse_attention"
SPARSE_MODE = "mode"
SPARSE_MODE_DEFAULT = "fixed"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_BLOCK = "block"
SPARSE_BLOCK_DEFAULT = 16
SPARSE_DIFFERENT_LAYOUT_PER_HEAD = "different_layout_per_head"
SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT = False
SPARSE_NUM_LOCAL_BLOCKS = "num_local_blocks"
SPARSE_NUM_LOCAL_BLOCKS_DEFAULT = 4
SPARSE_NUM_GLOBAL_BLOCKS = "num_global_blocks"
SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT = 1
SPARSE_ATTENTION_TYPE = "attention"
SPARSE_ATTENTION_TYPE_DEFAULT = "bidirectional"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION = "horizontal_global_attention"
SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT = False
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS = "num_different_global_patterns"
SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT = 1
SPARSE_NUM_RANDOM_BLOCKS = "num_random_blocks"
SPARSE_NUM_RANDOM_BLOCKS_DEFAULT = 0
SPARSE_LOCAL_WINDOW_BLOCKS = "local_window_blocks"
SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT = [4]
SPARSE_GLOBAL_BLOCK_INDICES = "global_block_indices"
SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT = [0]
SPARSE_GLOBAL_BLOCK_END_INDICES = "global_block_end_indices"
SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT = None
SPARSE_NUM_SLIDING_WINDOW_BLOCKS = "num_sliding_window_blocks"
SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT = 3

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
