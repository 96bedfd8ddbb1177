"""``"resilience"`` config block (port of
``deepspeed_tpu/resilience/config.py``).

Parsed by :class:`~deepspeed_tpu_torch.runtime.config.DeepSpeedConfig`
like every other block; the keys live in ``runtime/constants.py``, whose
schema gives a misspelled key (``"polcy"``) a "did you mean 'policy'?".
The integrity keys arm the fleet integrity plane
(:mod:`~deepspeed_tpu_torch.resilience.integrity`), whose arming rules
the engine applies.
"""

from ..runtime import constants as C
from ..runtime.config_utils import get_scalar_param
from .constants import GUARD_POLICIES
from .integrity import INTEGRITY_ACTIONS



class DeepSpeedResilienceConfig:
    """Typed view of the ``resilience`` subsection (all keys optional)."""

    def __init__(self, param_dict):
        res = param_dict.get(C.RESILIENCE, {}) or {}
        self.enabled = bool(get_scalar_param(
            res, C.RESILIENCE_ENABLED, C.RESILIENCE_ENABLED_DEFAULT))
        self.policy = str(get_scalar_param(
            res, C.RESILIENCE_POLICY, C.RESILIENCE_POLICY_DEFAULT)).lower()
        assert self.policy in GUARD_POLICIES, (
            f"resilience.policy {self.policy!r} not one of {GUARD_POLICIES}")
        self.spike_window = int(get_scalar_param(
            res, C.RESILIENCE_SPIKE_WINDOW, C.RESILIENCE_SPIKE_WINDOW_DEFAULT))
        assert self.spike_window >= 0, "resilience.spike_window must be >= 0"
        self.spike_zscore = float(get_scalar_param(
            res, C.RESILIENCE_SPIKE_ZSCORE, C.RESILIENCE_SPIKE_ZSCORE_DEFAULT))
        assert self.spike_zscore > 0, "resilience.spike_zscore must be > 0"
        self.divergence_patience = int(get_scalar_param(
            res, C.RESILIENCE_DIVERGENCE_PATIENCE,
            C.RESILIENCE_DIVERGENCE_PATIENCE_DEFAULT))
        assert self.divergence_patience >= 1, (
            "resilience.divergence_patience must be >= 1")
        self.max_rollbacks = int(get_scalar_param(
            res, C.RESILIENCE_MAX_ROLLBACKS,
            C.RESILIENCE_MAX_ROLLBACKS_DEFAULT))
        assert self.max_rollbacks >= 0, "resilience.max_rollbacks must be >= 0"
        self.rollback_cooldown_steps = int(get_scalar_param(
            res, C.RESILIENCE_ROLLBACK_COOLDOWN_STEPS,
            C.RESILIENCE_ROLLBACK_COOLDOWN_STEPS_DEFAULT))
        assert self.rollback_cooldown_steps >= 0, (
            "resilience.rollback_cooldown_steps must be >= 0")
        self.hang_timeout_secs = float(get_scalar_param(
            res, C.RESILIENCE_HANG_TIMEOUT_SECS,
            C.RESILIENCE_HANG_TIMEOUT_SECS_DEFAULT))
        assert self.hang_timeout_secs >= 0, (
            "resilience.hang_timeout_secs must be >= 0 (0 disables the "
            "watchdog)")
        self.floor_scale_patience = int(get_scalar_param(
            res, C.RESILIENCE_FLOOR_SCALE_PATIENCE,
            C.RESILIENCE_FLOOR_SCALE_PATIENCE_DEFAULT))
        assert self.floor_scale_patience >= 1, (
            "resilience.floor_scale_patience must be >= 1")
        self.checkpoint_dir = get_scalar_param(
            res, C.RESILIENCE_CHECKPOINT_DIR,
            C.RESILIENCE_CHECKPOINT_DIR_DEFAULT)
        self.straggler_factor = float(get_scalar_param(
            res, C.RESILIENCE_STRAGGLER_FACTOR,
            C.RESILIENCE_STRAGGLER_FACTOR_DEFAULT))
        assert self.straggler_factor == 0 or self.straggler_factor >= 1, (
            "resilience.straggler_factor must be 0 (disabled) or >= 1: "
            "it multiplies the fleet-median p50, and slowest/median is "
            ">= 1 by construction — a factor in (0,1) would flag every "
            "healthy fleet at every print cadence")
        # fleet integrity plane (resilience/integrity.py)
        self.integrity = bool(get_scalar_param(
            res, C.RESILIENCE_INTEGRITY, C.RESILIENCE_INTEGRITY_DEFAULT))
        self.integrity_window = int(get_scalar_param(
            res, C.RESILIENCE_INTEGRITY_WINDOW,
            C.RESILIENCE_INTEGRITY_WINDOW_DEFAULT))
        assert self.integrity_window >= 1, (
            "resilience.integrity_window must be >= 1")
        self.integrity_action = str(get_scalar_param(
            res, C.RESILIENCE_INTEGRITY_ACTION,
            C.RESILIENCE_INTEGRITY_ACTION_DEFAULT)).lower()
        assert self.integrity_action in INTEGRITY_ACTIONS, (
            f"resilience.integrity_action {self.integrity_action!r} not "
            f"one of {INTEGRITY_ACTIONS}")
        self.integrity_peer_timeout_secs = float(get_scalar_param(
            res, C.RESILIENCE_INTEGRITY_PEER_TIMEOUT_SECS,
            C.RESILIENCE_INTEGRITY_PEER_TIMEOUT_SECS_DEFAULT))
        assert self.integrity_peer_timeout_secs >= 0, (
            "resilience.integrity_peer_timeout_secs must be >= 0 "
            "(0 disables the fleet heartbeat)")

    def __repr__(self):
        return (f"DeepSpeedResilienceConfig(enabled={self.enabled}, "
                f"policy={self.policy!r}, "
                f"patience={self.divergence_patience}, "
                f"max_rollbacks={self.max_rollbacks}, "
                f"hang_timeout_secs={self.hang_timeout_secs})")
