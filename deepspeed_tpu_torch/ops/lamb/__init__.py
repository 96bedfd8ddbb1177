"""Flat-space LAMB (port of ``deepspeed_tpu/ops/lamb``)."""

from .fused_lamb import FusedLamb

__all__ = ["FusedLamb"]
