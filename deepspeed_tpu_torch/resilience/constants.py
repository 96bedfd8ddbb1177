"""Exit-code contract between the resilience subsystem and the launcher
(port of ``deepspeed_tpu/resilience/constants.py``, which is stdlib-only;
the port keeps its own copy, since importing any module of the JAX
package loads jax).

The codes live in the 80s so they cannot collide with shell conventions
(126/127), Python's own 1/2, or the launcher's 128+signum mapping for
signal deaths.

- ``EXIT_STEP_HANG`` — the step watchdog detected a hung step (stuck
  collective, wedged host thread, dead remote attachment), dumped every
  thread's stack, and killed the process.  A *respawn-with-backoff*
  failure: the hang is environmental, and a restart from the latest
  checkpoint usually clears it (``launch.py --max-restarts``).

- ``EXIT_DIVERGENCE_ABORT`` — the anomaly guard declared the run
  diverged (sustained non-finite/spiking loss after the rollback budget
  was spent, or ``policy=abort``).  A *poison* code: restarting replays
  the same data into the same diverging state, so the launcher must
  never respawn on it — a human (or sweep controller) has to change
  something first.

- ``EXIT_INTEGRITY_EVICT`` — the fleet integrity plane reached a
  verdict naming one bad rank: a fingerprint-consensus outlier (an
  SDC/desync suspect whose state checksum disagrees with the replica
  majority) or a hang-quorum suspect (a peer whose heartbeat went
  stale while a majority kept making step progress).  A
  *resize-with-eviction* failure: the launcher's elastic supervisor
  reads the verdict file, charges the suspect's devices against the
  elastic budget (an eviction blocklist the planner respects), rolls
  the fleet back to the latest committed checkpoint, and respawns
  WITHOUT the suspect.  A no-majority split or a repeated eviction
  escalates to the poison code instead — there is no healthy majority
  left to trust.
"""

EXIT_STEP_HANG = 85
EXIT_DIVERGENCE_ABORT = 86
EXIT_INTEGRITY_EVICT = 87

# codes the launcher must never respawn, regardless of --max-restarts
POISON_EXIT_CODES = frozenset({EXIT_DIVERGENCE_ABORT})

# guard policies (config: resilience.policy)
POLICY_SKIP = "skip"
POLICY_RESCALE = "rescale"
POLICY_ROLLBACK = "rollback"
POLICY_ABORT = "abort"
GUARD_POLICIES = (POLICY_SKIP, POLICY_RESCALE, POLICY_ROLLBACK, POLICY_ABORT)


class TrainingDivergedError(RuntimeError):
    """Raised when the guard aborts a run (policy=abort, rollback budget
    exhausted, or no checkpoint to roll back to).  ``exit_code`` is the
    poison code the training script should exit with so the launcher
    never respawns the job into the same divergence."""

    def __init__(self, message, exit_code=EXIT_DIVERGENCE_ABORT):
        super().__init__(message)
        self.exit_code = exit_code


class FleetIntegrityError(RuntimeError):
    """Raised when the integrity plane's fingerprint consensus names a
    bad rank (this one or a peer).  Training scripts should
    ``sys.exit(err.exit_code)`` so the launcher's elastic supervisor
    evicts the suspect and resizes around it; the verdict file in the
    run dir carries who and why."""

    def __init__(self, message, exit_code=EXIT_INTEGRITY_EVICT,
                 suspect=None, kind=None):
        super().__init__(message)
        self.exit_code = exit_code
        self.suspect = suspect      # fleet rank the consensus named
        self.kind = kind            # "sdc_outlier" | "hang_quorum"
