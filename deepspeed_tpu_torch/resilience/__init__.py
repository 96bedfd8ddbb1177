"""Training resilience (port of ``deepspeed_tpu/resilience/``):
detect bad steps, recover, prove it.

- :mod:`.guard`: per-step anomaly detection (non-finite gradients or
  loss, a rolling loss-spike z-score, a pinned-at-floor fp16 loss scale)
  on the engine's one batched per-step fetch, with the policies
  ``skip | rescale | rollback | abort``;
- :mod:`.rollback`: restore from the latest committed checkpoint on
  sustained divergence, with a budget and a cooldown;
- :mod:`.watchdog`: a heartbeat thread that catches a hung step, dumps
  every thread's stack and the recent step latencies, and exits with the
  respawnable code;
- :mod:`.chaos`: a seeded fault injector (NaN batches, torn, corrupt and
  delayed checkpoints, a crash mid-save, SIGTERM, step hangs and kills,
  state bitflips);
- :mod:`.integrity`: the fleet integrity plane across ranks or replicas
  (fingerprint consensus, heartbeats and the hang quorum, the verdict
  files the launcher's elastic supervisor acts on), stdlib-only, with
  :mod:`.fingerprint`, the state checksum it votes on.

The exit codes and :class:`TrainingDivergedError` live in
:mod:`.constants`; the other modules load lazily.
"""

from .constants import (EXIT_DIVERGENCE_ABORT, EXIT_INTEGRITY_EVICT,  # noqa: F401,E501
                        EXIT_STEP_HANG, GUARD_POLICIES, POISON_EXIT_CODES,
                        FleetIntegrityError, TrainingDivergedError)

_LAZY = {
    "AnomalyGuard": ("guard", "AnomalyGuard"),
    "RollbackManager": ("rollback", "RollbackManager"),
    "StepWatchdog": ("watchdog", "StepWatchdog"),
    "ChaosMonkey": ("chaos", "ChaosMonkey"),
    "DeepSpeedResilienceConfig": ("config", "DeepSpeedResilienceConfig"),
}

__all__ = ["EXIT_DIVERGENCE_ABORT", "EXIT_INTEGRITY_EVICT",
           "EXIT_STEP_HANG", "GUARD_POLICIES", "POISON_EXIT_CODES",
           "FleetIntegrityError", "TrainingDivergedError", *_LAZY]


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module = importlib.import_module(f".{entry[0]}", __name__)
    value = getattr(module, entry[1])
    globals()[name] = value
    return value
