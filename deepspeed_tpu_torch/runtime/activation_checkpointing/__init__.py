"""Activation checkpointing (port of
``deepspeed_tpu/runtime/activation_checkpointing``)."""

from . import checkpointing
from .config import DeepSpeedActivationCheckpointingConfig

__all__ = ["checkpointing", "DeepSpeedActivationCheckpointingConfig"]
