"""TelemetryManager: the engine-facing facade over the telemetry sinks
(port of ``deepspeed_tpu/telemetry/manager.py``).

One instance per engine.  Owns the structured event stream
(:mod:`.events`), the metrics registry (:mod:`.registry`), the host-span
tracer + device-trace trigger (:mod:`.trace`), and — as a *consumer* —
the :class:`~deepspeed_tpu_torch.utils.monitor.TrainingMonitor`: per-step
scalars flow engine → :meth:`step_metrics` → event stream + registry,
and the monitor's TensorBoard/JSONL output is fed from the same call, so
TB behavior is preserved while the canonical record is the event stream.

Cost model: every method here is host-only Python.  Nothing in this
module touches a device tensor — all scalar *values* arrive as
already-fetched Python floats that rode the engine's existing
``steps_per_print`` fetch.  Telemetry adds **zero** per-step host syncs
by construction (the card tests count them with CUDA sync debug mode).

Shutdown: ``close()`` is registered via ``atexit`` and is idempotent;
``flush()`` (events + trace + monitor + a metrics snapshot to disk) is
what the preemption and watchdog paths call — the process is about to
die without atexit, and the tail events are the post-mortem.
"""

import atexit
import contextlib
import logging
import os
import threading

from . import events as ev
from .events import EventLog
from .registry import MetricsRegistry
from .trace import DeviceTraceTrigger, StepTracer

METRICS_FILE_PREFIX = "metrics-"
METRICS_FILE_SUFFIX = ".json"

_NULL_SPAN = contextlib.nullcontext()

logger = logging.getLogger(__name__)


def metrics_filename(rank):
    return f"{METRICS_FILE_PREFIX}rank{rank}{METRICS_FILE_SUFFIX}"


class TelemetryManager:
    """Facade the engine (and, injected, the checkpoint manager) talks to.

    With ``config.enabled`` false every emit/span/counter call is a cheap
    no-op — except :meth:`step_metrics`, which still forwards scalars to
    the TrainingMonitor so the pre-telemetry TensorBoard path keeps
    working unchanged.
    """

    def __init__(self, config=None, rank=0, monitor=None, registry=None,
                 device=None):
        from .config import DeepSpeedTelemetryConfig

        self.config = config or DeepSpeedTelemetryConfig({})
        self.rank = int(rank)
        self.monitor = monitor
        self.enabled = bool(self.config.enabled)
        self.run_dir = self.config.run_dir if self.enabled else None
        self._lock = threading.Lock()
        self._closed = False
        self._last_scale = None
        self.events = None
        self.tracer = None
        self.device_trace = None
        self.registry = registry if registry is not None else (
            MetricsRegistry() if self.enabled else None)
        if not self.enabled:
            return
        os.makedirs(self.run_dir, exist_ok=True)
        if self.config.events:
            self.events = EventLog(self.run_dir, rank=self.rank)
        if self.config.trace:
            self.tracer = StepTracer(
                self.run_dir, rank=self.rank,
                max_events=self.config.trace_max_events)
        # ``device``: the engine's; a CUDA engine's trace must hold CUDA
        # activity, and a trace that does not is reported, not kept
        self.device_trace = DeviceTraceTrigger(
            self.run_dir, trigger_path=self.config.device_trace_trigger,
            max_secs=self.config.device_trace_secs, device=device,
            rank=self.rank, on_error=self._device_trace_failed)
        self.metrics_path = os.path.join(self.run_dir,
                                         metrics_filename(self.rank))
        atexit.register(self.close)

    # ----------------------------------------------------------- events
    def emit(self, event_type, step=None, **data):
        if self.events is not None:
            self.events.emit(event_type, step=step, **data)
        if self.tracer is not None:
            self.tracer.instant(event_type, step=step)

    def step_metrics(self, step, samples, scalars, **extra):
        """Print-cadence scalars: one event + registry gauges + the
        TrainingMonitor's TensorBoard/JSONL output (always, even with
        telemetry disabled — TB is config-gated separately)."""
        if self.monitor is not None:
            self.monitor.write_scalars(samples, scalars)
        if not self.enabled:
            return
        if self.events is not None:
            self.events.emit(ev.EVENT_STEP_METRICS, step=step,
                             samples=int(samples), scalars=dict(scalars),
                             **extra)
        for tag, val in scalars.items():
            self.registry.gauge(tag).set(val)

    def note_scale(self, scale, step=None):
        """Loss-scale observation from a batched fetch the engine already
        paid for; emits a ``loss_scale`` event on change only."""
        if not self.enabled:
            return
        scale = float(scale)
        prev = self._last_scale
        if prev is not None and prev != scale:
            self.emit(ev.EVENT_LOSS_SCALE, step=step, scale=scale,
                      prev_scale=prev)
            self.registry.counter("fp16/scale_changes").inc()
        self._last_scale = scale
        self.registry.gauge("fp16/loss_scale").set(scale)

    # ---------------------------------------------------------- metrics
    def counter(self, name):
        return self.registry.counter(name) if self.enabled else _NULL_METRIC

    def gauge(self, name):
        return self.registry.gauge(name) if self.enabled else _NULL_METRIC

    def histogram(self, name):
        return (self.registry.histogram(name) if self.enabled
                else _NULL_METRIC)

    def quantiles(self, name):
        """P² streaming-percentile instrument (O(1) per observation) —
        for high-rate streams like the serving per-token latencies."""
        return (self.registry.quantiles(name) if self.enabled
                else _NULL_METRIC)

    # ------------------------------------------------------------ spans
    def span(self, name, **args):
        if self.tracer is None:
            return _NULL_SPAN
        return self.tracer.span(name, **args)

    def poll_device_trace(self, step=None):
        if self.device_trace is not None:
            self.device_trace.poll(step)

    def _device_trace_failed(self, detail):
        self.emit(ev.EVENT_ANOMALY, kind="device_trace", detail=detail,
                  consecutive=0)

    # --------------------------------------------------------- shutdown
    def flush(self, reason=None):
        """Flush every sink and snapshot the metrics registry to disk.
        Called from paths that will NOT reach atexit (SIGTERM re-raise,
        the watchdog's ``os._exit``) — and cheap enough to call anywhere."""
        if self.monitor is not None:
            self.monitor.flush()
        if not self.enabled:
            return
        if reason is not None:
            self.emit(ev.EVENT_RUN_END, reason=str(reason))
        if self.events is not None:
            self.events.flush()
        if self.tracer is not None:
            self.tracer.flush()
        try:
            self.registry.dump(self.metrics_path)
        except OSError as e:
            logger.error("telemetry metrics dump to %s failed: %s",
                         self.metrics_path, e)

    def close(self, reason="close"):
        """Idempotent final flush + close of every sink (events, trace,
        metrics snapshot, monitor)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.enabled:
            # a trace still running is exported first: its failure is
            # an event, which must land before the event log closes
            if self.device_trace is not None:
                self.device_trace.close()
            self.flush(reason=reason)
            if self.events is not None:
                self.events.close()
            if self.tracer is not None:
                self.tracer.close()
        if self.monitor is not None:
            self.monitor.close()

    @property
    def closed(self):
        return self._closed


class _NullMetric:
    """Disabled-telemetry stand-in: every instrument method is a no-op."""

    def inc(self, n=1):
        pass

    def add(self, n=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    value = 0.0


_NULL_METRIC = _NullMetric()
