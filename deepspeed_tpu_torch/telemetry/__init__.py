"""deepspeed_tpu_torch.telemetry — the observability subsystem (port of
``deepspeed_tpu/telemetry``).

One answer to "what happened in this run?", read from artifacts instead
of grep'd from stdout:

- :mod:`.registry` — process-local, thread-safe MetricsRegistry
  (counters, gauges, bounded-reservoir histograms, P² streaming
  quantiles) with an O(1) Python-only hot path, safe for the engine step
  loop and the checkpoint-writer and watchdog threads;
- :mod:`.events` — schema-versioned, rank- and seq-tagged JSONL event
  stream: step scalars, resilience anomaly/rollback/watchdog events, the
  checkpoint lifecycle, loss-scale changes, serving lifecycle records;
- :mod:`.trace` — Chrome-trace spans of the host's step phases, plus
  on-demand duration-bounded ``torch.profiler`` device traces through a
  trigger file;
- :mod:`.report` — ``python -m deepspeed_tpu_torch.telemetry report
  <run_dir>``: merged per-rank timeline, metric summaries, a Prometheus
  text dump, the serving section.

The schema version, the event type table and the file names are the
JAX package's: either package's report reads the other's run dir.
Gated by the ``"telemetry"`` config block; adds no host sync (every
scalar rides the engine's existing ``steps_per_print`` fetch).
"""

from .events import (EVENT_TYPES, SCHEMA_VERSION, EventLog,  # noqa: F401
                     read_events, validate_event)
from .manager import TelemetryManager  # noqa: F401
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, get_registry, prometheus_text)
from .trace import DeviceTraceTrigger, StepTracer  # noqa: F401

__all__ = [
    "SCHEMA_VERSION", "EVENT_TYPES", "EventLog", "read_events",
    "validate_event", "TelemetryManager", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "get_registry", "prometheus_text", "StepTracer",
    "DeviceTraceTrigger",
]
