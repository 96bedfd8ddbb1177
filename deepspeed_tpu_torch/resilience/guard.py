"""Runtime anomaly guard: the host-side half of bad-step detection (port
of ``deepspeed_tpu/resilience/guard.py``).

Division of labor with the engine's step:

- **In the step (on the device):** with resilience enabled the step
  computes ``overflow = !all(isfinite(flat_grads))`` for EVERY precision
  (the fp16 loss-scaler's check, generalized) and skips the optimizer
  update on that flag: a NaN burst never reaches the master weights or
  the optimizer moments, under any policy.

- **Host side (this module):** the engine fetches ``(overflow, loss,
  scale)`` in ONE batched copy per step (the copy fp16 makes for its
  overflow flag anyway) and feeds them to :meth:`AnomalyGuard.observe`,
  which classifies the step and returns the escalation the policy calls
  for.

Anomaly classes: non-finite gradients (``overflow``), non-finite loss,
rolling-window loss-spike z-score, and a pinned-at-floor fp16 loss scale
(``floor_scale_patience`` consecutive overflows with ``cur_scale`` at
``min_scale`` — the silent death spiral the scaler itself cannot see).

Policies (``resilience.policy``):

- ``skip`` — rely on the step's skip; log and count, never escalate.
- ``rescale`` — fp16: the dynamic scaler already halves on overflow, so
  this is ``skip`` plus trust in the scaler; bf16/fp32 have no scale to
  move, degenerates to ``skip`` (warned once).
- ``rollback`` — after ``divergence_patience`` CONSECUTIVE anomalous
  steps, restore from the latest committed checkpoint
  (:class:`~deepspeed_tpu_torch.resilience.rollback.RollbackManager`).
- ``abort`` — after patience, raise
  :class:`~deepspeed_tpu_torch.resilience.constants.TrainingDivergedError`
  (poison exit code: the launcher never respawns it).
"""

import logging
import math
from collections import deque

from .constants import (GUARD_POLICIES, POLICY_RESCALE, POLICY_ROLLBACK,
                        POLICY_SKIP)

logger = logging.getLogger(__name__)

# actions observe() can return to the engine
ACTION_NONE = "none"
ACTION_ROLLBACK = "rollback"
ACTION_ABORT = "abort"

# anomaly kinds recorded in the event log
KIND_NONFINITE_GRADS = "nonfinite_grads"
KIND_NONFINITE_LOSS = "nonfinite_loss"
KIND_LOSS_SPIKE = "loss_spike"
KIND_SCALE_FLOOR = "scale_floor"

# spike detection needs a minimally-populated window before the z-score
# means anything; below this many samples every step is "normal"
_MIN_SPIKE_SAMPLES = 8


class AnomalyGuard:
    """Per-engine anomaly classifier + policy escalator.

    Pure host-side bookkeeping, no device access: the engine hands it
    already-fetched python scalars.
    """

    def __init__(self, policy=POLICY_SKIP, spike_window=64,
                 spike_zscore=6.0, divergence_patience=3,
                 floor_scale_patience=8, min_scale=1.0, fp16=False,
                 max_events=256, event_sink=None):
        assert policy in GUARD_POLICIES, policy
        self.policy = policy
        # optional (step, kind, detail) callback — the telemetry bridge:
        # every recorded anomaly also lands in the structured event
        # stream.  Host-side only, called with already-fetched scalars.
        self.event_sink = event_sink
        self.spike_zscore = float(spike_zscore)
        self.divergence_patience = int(divergence_patience)
        self.floor_scale_patience = int(floor_scale_patience)
        self.min_scale = float(min_scale)
        self.fp16 = bool(fp16)
        self._window = deque(maxlen=int(spike_window)) if spike_window else None
        self.events = deque(maxlen=int(max_events))
        self.consecutive_anomalies = 0
        self.total_anomalies = 0
        self._floor_overflows = 0
        self._floor_warned = False
        if policy == POLICY_RESCALE and not fp16:
            logger.warning(
                "resilience.policy=rescale has no loss scale to move "
                "without fp16 dynamic loss scaling; behaving as "
                "policy=skip (the step's non-finite skip still protects "
                "the master weights)")

    # ------------------------------------------------------------------
    def _spike(self, loss):
        """Positive loss-spike z-score against the rolling window."""
        w = self._window
        if w is None or len(w) < _MIN_SPIKE_SAMPLES:
            return False, 0.0
        mean = math.fsum(w) / len(w)
        var = math.fsum((x - mean) ** 2 for x in w) / len(w)
        # std floor: a flat window (converged toy runs) must not turn
        # float noise into an infinite z-score
        std = max(math.sqrt(var), 1e-8, 1e-3 * max(1.0, abs(mean)))
        z = (loss - mean) / std
        return z > self.spike_zscore, z

    def _record(self, step, kind, detail):
        self.events.append((step, kind, detail))
        self.total_anomalies += 1
        if self.event_sink is not None:
            try:
                self.event_sink(step, kind, detail)
            except Exception as e:  # noqa: BLE001 — observability must
                # never escalate an anomaly into a training crash
                logger.error("anomaly event sink failed: %s", e)

    def observe(self, loss, overflow, scale=None, step=None):
        """Classify one completed step; returns one of ``ACTION_*``.

        ``loss``/``overflow``/``scale`` are host python scalars from the
        engine's single batched per-step fetch.  The step's skip already
        protected the weights on ``overflow``; what's decided here is
        whether the run as a whole is diverging.
        """
        anomaly = None
        if overflow:
            anomaly = (KIND_NONFINITE_GRADS, "non-finite gradients "
                       "(update skipped)")
        elif not math.isfinite(loss):
            anomaly = (KIND_NONFINITE_LOSS, f"loss={loss}")
        else:
            spiked, z = self._spike(loss)
            if spiked:
                anomaly = (KIND_LOSS_SPIKE,
                           f"loss={loss:.6g} z={z:.1f} over last "
                           f"{len(self._window)} steps")

        # pinned-at-floor loss scale: consecutive overflows while the
        # dynamic scaler sits at min_scale mean rescaling can no longer
        # help — the run needs intervention, not more halving
        if self.fp16 and overflow and scale is not None \
                and scale <= self.min_scale:
            self._floor_overflows += 1
            if (self._floor_overflows >= self.floor_scale_patience
                    and not self._floor_warned):
                self._floor_warned = True
                self._record(step, KIND_SCALE_FLOOR,
                             f"{self._floor_overflows} consecutive "
                             f"overflows at min_scale={self.min_scale}")
                logger.error(
                    "fp16 loss scale pinned at its floor (%s) for %d "
                    "consecutive overflowing steps — dynamic rescaling "
                    "can no longer recover this run; expect rollback or "
                    "abort (resilience.policy=%s)", self.min_scale,
                    self._floor_overflows, self.policy)
        elif not overflow:
            self._floor_overflows = 0
            self._floor_warned = False

        if anomaly is None:
            self.consecutive_anomalies = 0
            if self._window is not None:
                self._window.append(float(loss))
            return ACTION_NONE

        kind, detail = anomaly
        self.consecutive_anomalies += 1
        self._record(step, kind, detail)
        logger.warning(
            "anomaly guard: %s at step %s (%s) — %d consecutive "
            "anomalous step(s), policy=%s", kind, step, detail,
            self.consecutive_anomalies, self.policy)

        if self.policy in (POLICY_SKIP, POLICY_RESCALE):
            return ACTION_NONE
        if self.consecutive_anomalies < self.divergence_patience:
            return ACTION_NONE
        return (ACTION_ROLLBACK if self.policy == POLICY_ROLLBACK
                else ACTION_ABORT)

    def notify_rollback(self):
        """Reset divergence tracking after a successful state restore —
        the window's history belongs to the abandoned timeline."""
        self.consecutive_anomalies = 0
        self._floor_overflows = 0
        self._floor_warned = False
        if self._window is not None:
            self._window.clear()

    def recent_events(self):
        return list(self.events)
