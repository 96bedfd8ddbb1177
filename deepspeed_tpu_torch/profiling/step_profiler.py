"""The step-latency ring (port of ``StepLatencyRing`` of
``deepspeed_tpu/profiling/step_profiler.py:31``; the rest of that module,
the wall-time attribution of a step, is ROADMAP A16).  The resilience
watchdog dumps its summary in a hang post-mortem."""

import time
from collections import deque

import numpy as np

__all__ = ["StepLatencyRing"]


class StepLatencyRing:
    """Fixed-size ring of recent per-step wall latencies (beat-to-beat
    intervals of the engine's step loop).

    O(1) host work per step, no device access, safe on the step
    critical path.  The resilience watchdog dumps :meth:`summary` in its
    hang post-mortem so
    "was the job slowing down before it wedged?" is answerable from the
    crash log alone.  Appends are GIL-atomic; the watchdog thread reads
    without locking.
    """

    def __init__(self, capacity=64):
        self._buf = deque(maxlen=int(capacity))
        self.total_steps = 0
        self._last_beat = None

    def record(self, seconds):
        self._buf.append(float(seconds))
        self.total_steps += 1

    def beat(self):
        """One completed step, interval-tracked by the ring itself — for
        engines running WITHOUT the watchdog (whose own ``beat`` feeds
        this ring when it is armed).  O(1) host work, no device access."""
        now = time.monotonic()
        if self._last_beat is not None:
            self.record(now - self._last_beat)
        self._last_beat = now

    def pause(self):
        """Forget the last beat so a known-long gap (rollback restore,
        synchronous save) is not recorded as a step latency."""
        self._last_beat = None

    def recent(self):
        return list(self._buf)

    def latency_snapshot(self):
        """Summary dict for telemetry export (``comm/latency/*`` gauges
        + the per-rank skew exchange): last/mean/p50/p95/max seconds over
        the ring, plus counts.  All-host arithmetic on already-recorded
        floats — exporting this must ride the ``steps_per_print``
        cadence (dslint DSH205 guards that statically)."""
        vals = self.recent()
        if not vals:
            return {"n": 0, "steps": self.total_steps, "last": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "max": 0.0}
        arr = np.asarray(vals)
        return {"n": int(arr.size), "steps": self.total_steps,
                "last": float(arr[-1]), "mean": float(arr.mean()),
                "p50": float(np.median(arr)),
                "p95": float(np.percentile(arr, 95)),
                "max": float(arr.max())}

    def summary(self):
        snap = self.latency_snapshot()
        if not snap["n"]:
            return "no completed steps recorded"
        return (f"last={snap['last']:.3f}s mean={snap['mean']:.3f}s "
                f"p50={snap['p50']:.3f}s max={snap['max']:.3f}s "
                f"over {snap['n']} of {snap['steps']} step(s)")
