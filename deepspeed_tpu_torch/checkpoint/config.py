"""Typed view of the ``"checkpoint": {...}`` config block (port of
``deepspeed_tpu/checkpoint/config.py``).

Parsed by :class:`~deepspeed_tpu_torch.runtime.config.DeepSpeedConfig`;
read by the engine and
:class:`~deepspeed_tpu_torch.checkpoint.manager.CheckpointManager`.
"""

from ..runtime import constants as C
from ..runtime.config_utils import get_scalar_param


class DeepSpeedCheckpointConfig:
    def __init__(self, param_dict=None):
        ckpt = (param_dict or {}).get(C.CHECKPOINT, {})
        self.async_save = bool(get_scalar_param(
            ckpt, C.CHECKPOINT_ASYNC_SAVE, C.CHECKPOINT_ASYNC_SAVE_DEFAULT))
        self.keep_last_n = int(get_scalar_param(
            ckpt, C.CHECKPOINT_KEEP_LAST_N, C.CHECKPOINT_KEEP_LAST_N_DEFAULT))
        self.keep_every_n_steps = int(get_scalar_param(
            ckpt, C.CHECKPOINT_KEEP_EVERY_N_STEPS,
            C.CHECKPOINT_KEEP_EVERY_N_STEPS_DEFAULT))
        self.verify_on_load = bool(get_scalar_param(
            ckpt, C.CHECKPOINT_VERIFY_ON_LOAD,
            C.CHECKPOINT_VERIFY_ON_LOAD_DEFAULT))
        self.save_retries = int(get_scalar_param(
            ckpt, C.CHECKPOINT_SAVE_RETRIES, C.CHECKPOINT_SAVE_RETRIES_DEFAULT))
        self.retry_backoff_secs = float(get_scalar_param(
            ckpt, C.CHECKPOINT_RETRY_BACKOFF_SECS,
            C.CHECKPOINT_RETRY_BACKOFF_SECS_DEFAULT))
        self.save_on_preemption = bool(get_scalar_param(
            ckpt, C.CHECKPOINT_SAVE_ON_PREEMPTION,
            C.CHECKPOINT_SAVE_ON_PREEMPTION_DEFAULT))

        assert self.keep_last_n >= 0, (
            f"checkpoint.{C.CHECKPOINT_KEEP_LAST_N} must be >= 0")
        assert self.keep_every_n_steps >= 0, (
            f"checkpoint.{C.CHECKPOINT_KEEP_EVERY_N_STEPS} must be >= 0")
        assert self.save_retries >= 0, (
            f"checkpoint.{C.CHECKPOINT_SAVE_RETRIES} must be >= 0")
        assert self.retry_backoff_secs >= 0, (
            f"checkpoint.{C.CHECKPOINT_RETRY_BACKOFF_SECS} must be >= 0")

    def __repr__(self):
        return (f"DeepSpeedCheckpointConfig(async_save={self.async_save}, "
                f"keep_last_n={self.keep_last_n}, "
                f"keep_every_n_steps={self.keep_every_n_steps}, "
                f"verify_on_load={self.verify_on_load}, "
                f"save_retries={self.save_retries}, "
                f"retry_backoff_secs={self.retry_backoff_secs}, "
                f"save_on_preemption={self.save_on_preemption})")
