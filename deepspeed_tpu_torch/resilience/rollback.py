"""Divergence rollback: restore the engine from the latest committed
checkpoint when the anomaly guard declares sustained divergence (port of
``deepspeed_tpu/resilience/rollback.py``).

The restore itself is the engine's own :meth:`load_checkpoint` — params,
optimizer state, loss-scale state, step counters (``global_steps`` /
``micro_steps`` / ``global_samples``) and the lr scheduler
all rewind together, and integrity verification / in-flight-save
draining come with it.  What this module adds is the *policy* around it:

- where to roll back to (``resilience.checkpoint_dir``, else the last
  directory the engine saved to or loaded from);
- a rollback **budget** (``max_rollbacks``) so a run that keeps
  re-diverging aborts instead of looping forever on the same data;
- a **cooldown** (``rollback_cooldown_steps``): re-diverging within N
  steps of the restored step means the checkpoint itself is past the
  point of no return — thrashing, abort.
"""

import logging

from .constants import TrainingDivergedError

logger = logging.getLogger(__name__)


class RollbackManager:
    """Owns the rollback budget/cooldown for one engine."""

    def __init__(self, engine, max_rollbacks=2, cooldown_steps=0,
                 checkpoint_dir=None):
        self._engine = engine
        self.max_rollbacks = int(max_rollbacks)
        self.cooldown_steps = int(cooldown_steps)
        self.checkpoint_dir = checkpoint_dir
        self.rollbacks_used = 0
        self._restored_step = None

    def _load_dir(self):
        return self.checkpoint_dir or self._engine._last_ckpt_dir

    def rollback(self, reason=""):
        """Restore from the latest committed checkpoint; raises
        :class:`TrainingDivergedError` when no recovery is possible
        (no checkpoint, budget spent, or thrashing inside the cooldown).
        Returns the restored checkpoint path."""
        engine = self._engine
        load_dir = self._load_dir()
        if load_dir is None:
            raise TrainingDivergedError(
                "divergence rollback requested but no checkpoint "
                "directory is known — set resilience.checkpoint_dir or "
                f"save a checkpoint first ({reason})")
        if self.rollbacks_used >= self.max_rollbacks:
            raise TrainingDivergedError(
                f"divergence persists after {self.rollbacks_used} "
                f"rollback(s) — budget (max_rollbacks="
                f"{self.max_rollbacks}) exhausted ({reason})")
        if (self._restored_step is not None and engine.global_steps
                - self._restored_step <= self.cooldown_steps):
            raise TrainingDivergedError(
                f"re-diverged {engine.global_steps - self._restored_step} "
                f"step(s) after the last rollback (cooldown "
                f"{self.cooldown_steps}) — the checkpoint is already past "
                f"the divergence point ({reason})")

        diverged_at = engine.global_steps
        # async saves to this dir may still be landing; load_checkpoint
        # drains them and verifies integrity before restoring
        path, _ = engine.load_checkpoint(load_dir)
        if path is None:
            raise TrainingDivergedError(
                f"divergence rollback found no loadable checkpoint in "
                f"{load_dir} ({reason})")
        self.rollbacks_used += 1
        self._restored_step = engine.global_steps
        logger.error(
            "divergence rollback %d/%d: restored %s (step %d <- diverged "
            "at step %d)%s", self.rollbacks_used, self.max_rollbacks,
            path, engine.global_steps, diverged_at,
            f" — {reason}" if reason else "")
        return path
