"""Serving (port of ``deepspeed_tpu/inference``): paged-KV-cache
inference with continuous batching, prefill attention on the Hopper
flash-attention kernel."""

from .config import DeepSpeedInferenceConfig
from .engine import InferenceEngine
from .kv_cache import (NULL_BLOCK, BlockAllocator, init_kv_cache,
                       kv_cache_bytes)
from .model import build_decode, build_prefill, reference_generate
from .scheduler import (ContinuousBatchScheduler, Request, REASON_DEADLINE,
                        REASON_EOS, REASON_LENGTH)

__all__ = ["DeepSpeedInferenceConfig", "InferenceEngine", "NULL_BLOCK",
           "BlockAllocator", "init_kv_cache", "kv_cache_bytes",
           "build_decode", "build_prefill", "reference_generate",
           "ContinuousBatchScheduler", "Request", "REASON_DEADLINE",
           "REASON_EOS", "REASON_LENGTH"]
