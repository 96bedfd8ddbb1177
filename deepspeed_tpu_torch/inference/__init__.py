"""Serving (port of ``deepspeed_tpu/inference``): paged-KV-cache
inference with continuous batching, prefill attention on the Hopper
flash-attention kernel, the serving observability plane, and the
multi-replica front-end (admission, shedding, degradation, requeue),
and the replicas' health plane (heartbeats, weight-fingerprint
consensus, SIGTERM drain: :mod:`.resilience`)."""

from .config import DeepSpeedInferenceConfig
from .engine import InferenceEngine
from .frontend import ServingFrontend, ServingOverloadError
from .kv_cache import (NULL_BLOCK, BlockAllocator, init_kv_cache,
                       kv_cache_bytes)
from .model import build_decode, build_prefill, reference_generate
from .observability import (SERVING_PHASE_KEYS,
                            SERVING_TRACE_SCHEMA_VERSION,
                            ServingObservability, latency_receipt,
                            mint_trace_id)
from .resilience import (SERVING_FINGERPRINT_STEP, ServingHealth,
                         arm_serving_preemption, drain_deadline_secs,
                         serving_hang_quorum)
from .scheduler import (ContinuousBatchScheduler, Request, REASON_DEADLINE,
                        REASON_EOS, REASON_LENGTH)

__all__ = ["DeepSpeedInferenceConfig", "InferenceEngine", "ServingFrontend",
           "ServingOverloadError", "NULL_BLOCK", "BlockAllocator",
           "init_kv_cache", "kv_cache_bytes", "build_decode",
           "build_prefill", "reference_generate", "SERVING_PHASE_KEYS",
           "SERVING_TRACE_SCHEMA_VERSION", "ServingObservability",
           "latency_receipt", "mint_trace_id", "ContinuousBatchScheduler",
           "Request", "REASON_DEADLINE", "REASON_EOS", "REASON_LENGTH",
           "SERVING_FINGERPRINT_STEP", "ServingHealth",
           "arm_serving_preemption", "drain_deadline_secs",
           "serving_hang_quorum"]
