"""Flat-space Adam/AdamW (port of ``deepspeed_tpu/ops/adam``)."""

from .fused_adam import FusedAdam

__all__ = ["FusedAdam"]
