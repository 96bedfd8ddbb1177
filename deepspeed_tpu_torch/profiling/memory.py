"""Memory observability: a per-entry-point device-memory ledger and live
watermarks (port of ``deepspeed_tpu/profiling/memory.py``).

The JAX ledger reads each compiled program's static
``memory_analysis()``.  Eager PyTorch compiles no program and has no
static memory account, so this ledger MEASURES:

- :class:`MemoryLedger` — ``wrap(name, fn)`` around an engine entry
  point (the training engine's forward, backward and optimizer apply, the
  serving engine's prefill buckets and decode); the first call of each
  records the bytes in use at entry, the peak during the call (the
  card's peak counter is reset just before it,
  ``torch.cuda.reset_peak_memory_stats``) and the bytes held after it,
  each fenced by a synchronization, and emits them as a ``memory`` event
  (kind ``program``) and ``memory/program/<name>/*`` gauges, under the
  JAX field names where a field has a meaning: ``argument_size_in_bytes``
  is everything in use at entry (the arguments among it),
  ``output_size_in_bytes`` what the call leaves allocated,
  ``temp_size_in_bytes`` the peak less the entry bytes (the JAX
  "temporaries"), and ``predicted_peak_bytes`` keeps its name although
  the value is the measured peak.  Later calls run the function as it
  is: no sync, nothing on the step path.
- :func:`device_memory_summary` — bytes in use, peak and capacity
  summed over ALL local cards (``torch.cuda.memory_allocated``,
  ``max_memory_allocated`` and the card's total memory): the one
  implementation behind :func:`see_memory_usage`,
  ``SynchronizedWallClockTimer.memory_usage`` and the engine's watermark
  events at the ``steps_per_print`` cadence.  Without a card it reports
  ``reporting: 0`` (no stats), as the JAX summary does where
  ``memory_stats()`` is None: absent data, never the CPU's.
- :class:`HostBufferRegistry` — the pinned host buffers of ZeRO-Offload
  by family (``master``, ``opt/<field>``, ``grads``, ``qres/<name>``).
"""

import threading

import torch

from ..utils.logging import logger

# memory-event kinds (the ``kind`` data key of EVENT_MEMORY)
KIND_PROGRAM = "program"
KIND_WATERMARK = "watermark"
KIND_HOST_BUFFERS = "host_buffers"

# the measured fields of one ledger entry
ENTRY_FIELDS = ("argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "peak_bytes_in_use",
                "bytes_in_use_after")


def predicted_peak_bytes(entry):
    """The entry's peak device bytes during the call (measured: the name
    is the JAX ledger's, whose value is predicted from the program)."""
    if not entry:
        return None
    return entry.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# Live watermarks (the one shared summary)
# ---------------------------------------------------------------------------

def _device_stats(dev):
    """``{bytes_in_use, peak_bytes_in_use, bytes_limit}`` of one device:
    a CUDA device's allocator counters, an object's own
    ``memory_stats()`` (a test's fake device), or {} (no stats: a CPU
    device)."""
    if hasattr(dev, "memory_stats"):
        return dev.memory_stats() or {}
    dev = torch.device("cuda", dev) if isinstance(dev, int) \
        else torch.device(dev)
    if dev.type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(dev),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
            "bytes_limit": torch.cuda.get_device_properties(dev)
            .total_memory}


def device_memory_summary(devices=None):
    """Allocation stats summed over ALL local cards (or ``devices``).

    Returns ``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "devices", "reporting"}``; ``reporting`` counts the devices that
    returned stats (0 without a card: callers treat the sums as
    unavailable then).  Summing matters: on a multi-card host, card 0
    alone understates the footprint by the local card count."""
    out = {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0,
           "devices": 0, "reporting": 0}
    if devices is None:
        devices = list(range(torch.cuda.device_count())) \
            if torch.cuda.is_available() else []
    devices = list(devices)
    out["devices"] = len(devices)
    for dev in devices:
        stats = _device_stats(dev)
        if stats:
            out["reporting"] += 1
        out["bytes_in_use"] += int(stats.get("bytes_in_use", 0))
        out["peak_bytes_in_use"] += int(stats.get("peak_bytes_in_use", 0))
        out["bytes_limit"] += int(stats.get("bytes_limit", 0))
    return out


def format_memory_summary(summary):
    gib = 1024.0 ** 3
    return (f"mem allocated {summary['bytes_in_use'] / gib:.4f} GB peak "
            f"{summary['peak_bytes_in_use'] / gib:.4f} GB limit "
            f"{summary['bytes_limit'] / gib:.4f} GB across "
            f"{summary['reporting']}/{summary['devices']} local device(s)")


def see_memory_usage(message, force=False):
    """Log the cross-card memory summary (reference
    ``see_memory_usage``, ``utils.py:547-566``)."""
    if not force:
        return
    summary = device_memory_summary()
    if summary["reporting"] == 0:
        logger.info(f"{message} | memory stats unavailable (no CUDA device)")
        return
    logger.info(f"{message} | {format_memory_summary(summary)}")


# ---------------------------------------------------------------------------
# Host pinned-buffer registry (fed by the engine's offload state)
# ---------------------------------------------------------------------------

class HostBufferRegistry:
    """Ledger of the pinned host buffer families the offload layout
    holds: one entry per family, its buffer count, bytes and dtype."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = []

    def register(self, family, count, total_bytes, dtype):
        with self._lock:
            self._entries = [e for e in self._entries
                             if e["family"] != family]
            self._entries.append({"family": str(family), "count": int(count),
                                  "bytes": int(total_bytes),
                                  "dtype": str(dtype)})

    def entries(self):
        with self._lock:
            return [dict(e) for e in self._entries]

    def total_bytes(self):
        with self._lock:
            return sum(e["bytes"] for e in self._entries)

    def total_count(self):
        with self._lock:
            return sum(e["count"] for e in self._entries)

    def as_event_data(self):
        return {"buffers": self.total_count(), "bytes": self.total_bytes(),
                "families": self.entries()}


# ---------------------------------------------------------------------------
# MemoryLedger: per-entry-point measured accounting
# ---------------------------------------------------------------------------

class _LedgeredCall:
    """``fn`` whose first call on a CUDA device is measured and
    recorded; every later call is ``fn`` itself."""

    __slots__ = ("_ledger", "_name", "_fn", "_done", "__weakref__")

    def __init__(self, ledger, name, fn):
        self._ledger = ledger
        self._name = name
        self._fn = fn
        self._done = False

    def __call__(self, *args, **kwargs):
        if self._done:
            return self._fn(*args, **kwargs)
        self._done = True
        device = self._ledger.device
        if device is None or torch.device(device).type != "cuda":
            self._ledger.record(self._name, None)
            return self._fn(*args, **kwargs)
        torch.cuda.synchronize(device)
        entry_bytes = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = self._fn(*args, **kwargs)
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        after = torch.cuda.memory_allocated(device)
        self._ledger.record(self._name, {
            "argument_size_in_bytes": int(entry_bytes),
            "output_size_in_bytes": int(max(after - entry_bytes, 0)),
            "temp_size_in_bytes": int(max(peak - entry_bytes, 0)),
            "peak_bytes_in_use": int(peak),
            "bytes_in_use_after": int(after)})
        return out

    @property
    def wrapped(self):
        return self._fn


class MemoryLedger:
    """Per-engine ledger of the entry points' measured memory.

    ``wrap(name, fn)`` at build time; entries accumulate as entry points
    first run on ``device``.  With a telemetry manager attached, each
    recording emits one ``memory`` event (kind ``program``) and
    per-entry gauges, at that first call only."""

    def __init__(self, enabled=True, telemetry=None, device=None):
        self.enabled = bool(enabled)
        self.telemetry = telemetry
        self.device = device
        self.host_buffers = HostBufferRegistry()
        self._lock = threading.Lock()
        self._entries = {}

    def wrap(self, name, fn):
        if not self.enabled:
            return fn
        return _LedgeredCall(self, name, fn)

    def record(self, name, entry):
        """Record one entry point's measurement (None: no stats on this
        device, the name is kept without numbers)."""
        name = str(name)
        with self._lock:
            self._entries[name] = dict(entry) if entry else None
            n = len(self._entries)
        tel = self.telemetry
        if entry is None or tel is None or not getattr(tel, "enabled", False):
            return entry
        from ..telemetry import events as TEL

        tel.emit(TEL.EVENT_MEMORY, kind=KIND_PROGRAM, program=name,
                 predicted_peak_bytes=predicted_peak_bytes(entry), **entry)
        for field in ENTRY_FIELDS:
            tel.gauge(f"memory/program/{name}/{field}").set(
                float(entry[field]))
        tel.gauge("memory/programs").set(float(n))
        return entry

    def entry(self, name):
        with self._lock:
            e = self._entries.get(str(name))
        return dict(e) if e else None

    def entries(self):
        with self._lock:
            return {k: (dict(v) if v else None)
                    for k, v in self._entries.items()}

    def predicted_peak_bytes(self, name):
        return predicted_peak_bytes(self.entry(name))

    def predicted_temp_bytes(self, name):
        e = self.entry(name)
        return e.get("temp_size_in_bytes") if e else None

    # -- host pinned buffers ------------------------------------------
    def record_host_buffers(self, bytes_per_step=None):
        """Publish the host-buffer registry (one event + gauges); called
        by the engine once its offload state is built."""
        tel = self.telemetry
        if tel is None or not getattr(tel, "enabled", False):
            return
        from ..telemetry import events as TEL

        data = self.host_buffers.as_event_data()
        if bytes_per_step is not None:
            data["state_wire_bytes_per_step"] = int(bytes_per_step)
        tel.emit(TEL.EVENT_MEMORY, kind=KIND_HOST_BUFFERS, **data)
        tel.gauge("memory/host_buffer_bytes").set(
            float(self.host_buffers.total_bytes()))
        tel.gauge("memory/host_buffers").set(
            float(self.host_buffers.total_count()))
