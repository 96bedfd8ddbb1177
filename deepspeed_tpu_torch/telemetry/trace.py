"""Step tracing: Chrome-trace-event host spans + on-demand device traces
(port of ``deepspeed_tpu/telemetry/trace.py``).

Two complementary tools:

- :class:`StepTracer` — host-side phase spans (batch fetch, dispatch,
  the print cadence's loss fetch, checkpoint snapshot, rollback
  restore) written in the Chrome Trace Event "JSON Array Format" that
  chrome://tracing and Perfetto load directly.  Events stream to disk as
  they complete — the format tolerates a missing ``]``, so a crashed or
  preempted run's trace is still loadable.  Span cost is two
  ``time.perf_counter()`` calls and one dict append: no device access,
  no syncs, safe on the step critical path.

- :class:`DeviceTraceTrigger` — on-demand ``torch.profiler`` device
  traces with a **bounded duration**, where the JAX package starts
  ``jax.profiler.start_trace``.  A device profile is far too heavy to
  leave on, but the interesting step is never the one you planned for:
  touch the trigger file (``<run_dir>/device_trace.trigger``) and a
  later :meth:`poll` starts ``torch.profiler`` (CPU and, on a CUDA
  engine, CUDA activity), stops it after ``max_secs`` and exports a
  Chrome trace into ``<run_dir>/device_trace/``.  The trigger file is
  stat'ed once every ``check_every`` polls.
"""

import json
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

TRACE_FILE_PREFIX = "trace-"
TRACE_FILE_SUFFIX = ".json"
DEVICE_TRACE_TRIGGER_FILE = "device_trace.trigger"
DEVICE_TRACE_DIR = "device_trace"


def trace_filename(rank):
    return f"{TRACE_FILE_PREFIX}rank{rank}{TRACE_FILE_SUFFIX}"


class _Span:
    """Context manager recording one complete ("ph": "X") event."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._record(self._name, self._t0, time.perf_counter(),
                             self._args)
        return False


class StepTracer:
    """Streams Chrome trace events for one process to
    ``<run_dir>/trace-rank<k>.json``.

    Thread-safe (checkpoint-writer spans land from their own threads,
    tagged with that thread's id so Perfetto draws them on separate
    tracks).  ``max_events`` bounds file growth on long runs: past it the
    tracer drops new spans and says so once.
    """

    def __init__(self, run_dir, rank=0, max_events=200000):
        self.rank = rank
        self.max_events = int(max_events)
        # RLock: the preemption handler's flush may interrupt a frame
        # already holding this lock on the main thread
        self._lock = threading.RLock()
        self._count = 0
        self._dropped = 0
        self._clock0 = time.perf_counter()
        os.makedirs(str(run_dir), exist_ok=True)
        self.path = os.path.join(str(run_dir), trace_filename(rank))
        self._f = open(self.path, "w", encoding="utf-8")
        self._f.write("[\n")
        # process metadata so merged multi-rank traces label their tracks
        self._meta("process_name", {"name": f"rank {rank}"})

    def _meta(self, name, args):
        self._write({"name": name, "ph": "M", "pid": self.rank,
                     "tid": threading.get_ident() % 2**31, "args": args})

    def _write(self, event):
        try:
            self._f.write(json.dumps(event) + ",\n")
        except (OSError, ValueError) as e:
            logger.error("step tracer %s failed (%s); disabling",
                         self.path, e)
            self._f = None

    def _record(self, name, t0, t1, args):
        with self._lock:
            if self._f is None:
                return
            if self._count >= self.max_events:
                self._dropped += 1
                if self._dropped == 1:
                    logger.warning(
                        "step tracer hit max_events=%d; dropping further "
                        "spans (raise telemetry.trace_max_events)",
                        self.max_events)
                return
            self._count += 1
            event = {"name": name, "ph": "X", "pid": self.rank,
                     "tid": threading.get_ident() % 2**31,
                     "ts": (t0 - self._clock0) * 1e6,
                     "dur": (t1 - t0) * 1e6}
            if args:
                event["args"] = args
            self._write(event)

    def span(self, name, **args):
        """``with tracer.span("dispatch", step=n): ...``"""
        return _Span(self, name, args)

    def instant(self, name, **args):
        """Zero-duration marker (anomalies, rollbacks, commits)."""
        now = time.perf_counter()
        self._record(name, now, now, args)

    def complete(self, name, t0, t1, **args):
        """Record an already-finished span (``perf_counter`` endpoints).
        For spans observed after the fact, where a ``with span():``
        block never existed."""
        self._record(name, t0, t1, args)

    def flush(self):
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                except OSError as e:
                    logger.error("step tracer flush failed: %s", e)
                    self._f = None

    def close(self):
        with self._lock:
            if self._f is None:
                return
            try:
                # the trailing comma is legal in the JSON Array Format;
                # close the array anyway so strict json.load works too
                self._f.write("{}]\n")
                self._f.flush()
                self._f.close()
            except (OSError, ValueError) as e:
                logger.warning("step tracer close failed: %s", e)
            self._f = None


class DeviceTraceTrigger:
    """Trigger-file-gated, duration-bounded ``torch.profiler`` traces.

    ``poll(step)`` is called once per completed engine step:

    - trigger file present and no trace running → start ``torch.profiler``
      and delete the trigger (one touch, one trace);
    - trace running for ``max_secs`` or more → stop it and export its
      Chrome trace to ``<run_dir>/device_trace/trace-rank<r>-steps<a>-<b>.json``
      (the path is appended to :attr:`paths`).

    On a CUDA ``device`` the trace must hold CUDA activity.  A trace that
    recorded none (CUPTI missing or refused) is not a device trace: its
    file is removed, the failure is logged as an error and handed to
    ``on_error`` (the telemetry manager writes it as an ``anomaly``
    event).  Failures never take training down.
    """

    # stat the trigger file only every Nth poll: run dirs often live on
    # network filesystems where a per-step stat would put a round-trip
    # on the hot path; a few steps of trigger latency is irrelevant for
    # a human-touched file.  Deadline checks (stopping an ACTIVE trace)
    # still run every poll — a time.monotonic compare, no I/O.
    CHECK_EVERY = 10

    def __init__(self, run_dir, trigger_path=None, max_secs=10.0,
                 check_every=CHECK_EVERY, device=None, rank=0,
                 on_error=None):
        self.run_dir = str(run_dir)
        self.trigger_path = trigger_path or os.path.join(
            self.run_dir, DEVICE_TRACE_TRIGGER_FILE)
        self.out_dir = os.path.join(self.run_dir, DEVICE_TRACE_DIR)
        self.max_secs = float(max_secs)
        self.check_every = max(1, int(check_every))
        self.cuda = (device is not None and str(
            getattr(device, "type", device)).split(":")[0] == "cuda")
        self.rank = rank
        self.on_error = on_error
        self.paths = []
        self._polls = 0
        self._deadline = None
        self._signal_flag = False
        self._prof = None
        self._first_step = None

    def request(self):
        """Programmatic trigger (e.g. from a signal handler)."""
        self._signal_flag = True

    @property
    def active(self):
        return self._deadline is not None

    def poll(self, step=None):
        """Start/stop the device trace as the trigger + deadline dictate;
        returns True while a trace is running."""
        if self._deadline is not None:
            if time.monotonic() >= self._deadline:
                self._stop(step)
            return self._deadline is not None
        self._polls += 1
        if not self._signal_flag and self._polls % self.check_every:
            return False
        if self._signal_flag or os.path.exists(self.trigger_path):
            self._signal_flag = False
            try:
                os.remove(self.trigger_path)
            except OSError:
                # requested, or a concurrent rank won the unlink; either
                # way the trace itself still starts
                logger.info("device trace trigger file already gone")
            self._start(step)
        return self._deadline is not None

    def _fail(self, message):
        logger.error(message)
        if self.on_error is not None:
            try:
                self.on_error(message)
            except Exception as e:  # noqa: BLE001 — profiling is best-effort
                logger.error("device trace error sink failed: %s", e)

    def _start(self, step):
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.out_dir, exist_ok=True)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            self._fail(f"device trace start failed: {e}")
            return
        self._prof = prof
        self._first_step = step
        self._deadline = time.monotonic() + self.max_secs
        logger.info("device trace started at step %s into %s (max %.1fs)",
                    step, self.out_dir, self.max_secs)

    def _stop(self, step):
        prof, self._prof = self._prof, None
        self._deadline = None
        path = os.path.join(
            self.out_dir, f"{TRACE_FILE_PREFIX}rank{self.rank}-steps"
            f"{self._first_step}-{step}{TRACE_FILE_SUFFIX}")
        try:
            prof.stop()
            prof.export_chrome_trace(path)
            recorded_device = not self.cuda or _has_device_events(prof)
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            self._fail(f"device trace stop failed: {e}")
            return
        if not recorded_device:
            os.remove(path)
            self._fail(
                "device trace recorded no CUDA activity (CUPTI missing or "
                "refused?); the host-only trace was discarded")
            return
        self.paths.append(path)
        logger.info("device trace stopped at step %s; load %s in "
                    "Perfetto or chrome://tracing", step, path)

    def close(self):
        if self._deadline is not None:
            self._stop(None)


def _has_device_events(prof):
    """Whether a stopped ``torch.profiler`` run recorded any CUDA kernel,
    copy or memset."""
    from torch.autograd import DeviceType

    return any(getattr(e, "device_type", None) == DeviceType.CUDA
               or getattr(e, "kernels", None) for e in prof.events())
