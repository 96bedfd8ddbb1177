"""Step watchdog: detect hung steps and kill the process diagnosably
(port of ``deepspeed_tpu/resilience/watchdog.py``).

A hung collective (one host of a pod preempted mid-allreduce), a wedged
remote attachment, or a deadlocked host thread all present the same way:
``train_batch`` simply never returns, and the job burns its reservation
doing nothing until an outer cluster timeout fires hours later.  The
watchdog turns that into minutes: a daemon thread watches a heartbeat
the engine touches once per completed step; when the gap exceeds
``hang_timeout_secs`` it

1. dumps EVERY thread's stack (``faulthandler``) plus the recent
   step-latency ring from the step profiler — the post-mortem a hang
   otherwise destroys, and
2. exits the process with :data:`EXIT_STEP_HANG`, which the launcher's
   ``--max-restarts`` maps to *respawn with backoff* (unlike the
   divergence poison codes, which never respawn).

The watchdog only arms after the FIRST beat: initial compilation of a
large fused step legitimately takes longer than any sane hang timeout.
``os._exit`` (not ``sys.exit``) is deliberate — the process is wedged,
so atexit/thread-join cleanup would hang right behind the step.
"""

import faulthandler
import logging
import os
import sys
import threading
import time

from .constants import EXIT_STEP_HANG

logger = logging.getLogger(__name__)


class StepWatchdog:
    """Heartbeat monitor for one engine's step loop."""

    def __init__(self, timeout_secs, poll_interval=None, exit_fn=None,
                 dump_file=None, latency_ring=None, describe=None,
                 on_fire=None):
        assert timeout_secs > 0, "watchdog timeout must be > 0"
        self.timeout_secs = float(timeout_secs)
        # optional (stalled_secs) callback run after the dump, before the
        # exit — the telemetry flush hook (os._exit skips atexit, so the
        # tail events must land here or be lost with the process)
        self._on_fire = on_fire
        self.poll_interval = float(poll_interval
                                   if poll_interval is not None
                                   else min(1.0, self.timeout_secs / 4))
        # injectable for tests; the default must be os._exit (see module
        # docstring: the process is wedged, graceful teardown would hang)
        self._exit_fn = exit_fn if exit_fn is not None else (
            lambda code: os._exit(code))
        self._dump_file = dump_file          # None -> sys.stderr at fire time
        self._ring = latency_ring
        self._describe = describe            # optional () -> str context line
        self._last_beat = None
        self._stop = threading.Event()
        self._thread = None
        self.fired = False

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ds-step-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def pause(self):
        """Disarm until the next :meth:`beat` — for known-long gaps in the
        step cadence (a rollback restore, a synchronous final save) that
        must not read as hangs."""
        self._last_beat = None

    def beat(self):
        """One completed step.  Called from the engine's step loop; must
        stay O(1) host work with no device access."""
        now = time.monotonic()
        if self._ring is not None and self._last_beat is not None:
            self._ring.record(now - self._last_beat)
        self._last_beat = now

    # ------------------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.poll_interval):
            last = self._last_beat
            if last is None:      # arm only after the first beat
                continue
            stalled = time.monotonic() - last
            if stalled < self.timeout_secs or self.fired:
                continue
            self.fired = True
            self.dump(stalled)
            if self._on_fire is not None:
                try:
                    self._on_fire(stalled)
                except Exception as e:  # noqa: BLE001 — dying anyway
                    logger.error("watchdog on_fire hook failed: %s", e)
            self._exit_fn(EXIT_STEP_HANG)
            return

    def dump(self, stalled_secs):
        """Write the hang post-mortem: context, step latencies, and every
        thread's stack."""
        out = self._dump_file or sys.stderr
        # context/latency lines are best-effort and must never cost us the
        # stack dump (e.g. a concurrent beat() mutating the ring deque
        # mid-summary), so each rides its own try
        try:
            out.write(
                f"\n=== deepspeed-tpu step watchdog ===\n"
                f"step heartbeat stalled for {stalled_secs:.1f}s "
                f"(timeout {self.timeout_secs:.1f}s); exiting with code "
                f"{EXIT_STEP_HANG} (respawnable)\n")
            if self._describe is not None:
                out.write(f"context: {self._describe()}\n")
        except Exception as e:  # noqa: BLE001 — dying anyway; say why
            logger.error("watchdog context dump failed: %s", e)
        try:
            if self._ring is not None:
                out.write(f"recent step latencies: {self._ring.summary()}\n")
        except Exception as e:  # noqa: BLE001 — dying anyway; say why
            logger.error("watchdog latency dump failed: %s", e)
        try:
            out.write("--- all thread stacks ---\n")
            out.flush()
            faulthandler.dump_traceback(file=out, all_threads=True)
            out.flush()
        except Exception as e:  # noqa: BLE001 — dying anyway; say why
            logger.error("watchdog stack dump failed: %s", e)
        logger.error(
            "step watchdog: heartbeat stalled %.1fs (> %.1fs timeout); "
            "stack dump written, exiting %d", stalled_secs,
            self.timeout_secs, EXIT_STEP_HANG)
