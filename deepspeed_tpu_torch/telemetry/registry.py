"""Process-local metrics registry: counters, gauges, bounded-reservoir
histograms (port of ``deepspeed_tpu/telemetry/registry.py``, the same
instruments, snapshots and Prometheus text, so a run dir written by
either package reads alike).

Design constraints (the reason this is not a third-party metrics client):

- **O(1) Python-only hot path.**  ``Counter.inc`` / ``Gauge.set`` /
  ``Histogram.observe`` are a lock acquire plus one or two attribute
  writes — no device access, no I/O, no allocation beyond the reservoir
  slot.  Safe on the engine step critical path.
- **Thread-safe.**  The engine step loop, the async checkpoint-writer
  threads, and the resilience watchdog all write concurrently; readers
  (the report CLI via :meth:`MetricsRegistry.dump`, the watchdog's
  post-mortem) snapshot without stopping writers.  Each instrument has
  its own lock so contention between unrelated metrics is zero.
- **Deterministic.**  Histogram reservoirs use algorithm R seeded from
  the metric name, so a replayed run produces byte-identical snapshots.

Stdlib-only: importable from the report CLI without torch.
"""

import json
import math
import os
import random
import threading

__all__ = ["Counter", "Gauge", "Histogram", "P2Quantile",
           "StreamingQuantiles", "MetricsRegistry", "get_registry"]


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name):
        self.name = name
        self._lock = threading.RLock()
        self._value = 0.0

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self):
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-written value (e.g. current loss scale, queue depth)."""

    kind = "gauge"

    def __init__(self, name):
        self.name = name
        self._lock = threading.RLock()
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def add(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self):
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Streaming count/sum/min/max plus a bounded reservoir for
    percentiles (algorithm R: every observation has equal probability of
    surviving, memory is fixed at ``reservoir_size`` floats)."""

    kind = "histogram"

    def __init__(self, name, reservoir_size=256):
        self.name = name
        self._lock = threading.RLock()
        self._reservoir_size = int(reservoir_size)
        self._reservoir = []
        # seeded from the name: replayed runs snapshot identically
        self._rng = random.Random(name)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value):
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            if len(self._reservoir) < self._reservoir_size:
                self._reservoir.append(value)
            else:
                slot = self._rng.randrange(self.count)
                if slot < self._reservoir_size:
                    self._reservoir[slot] = value

    def percentile(self, p):
        """Approximate p-th percentile (0..100) from the reservoir."""
        with self._lock:
            data = sorted(self._reservoir)
        if not data:
            return 0.0
        idx = min(len(data) - 1, int(round((p / 100.0) * (len(data) - 1))))
        return data[idx]

    def snapshot(self):
        with self._lock:
            count, total = self.count, self.sum
            lo = self.min if self.count else 0.0
            hi = self.max if self.count else 0.0
            data = sorted(self._reservoir)
        out = {"kind": self.kind, "count": count, "sum": total,
               "min": lo, "max": hi, "mean": total / count if count else 0.0}
        for p in (50, 90, 99):
            if data:
                idx = min(len(data) - 1,
                          int(round((p / 100.0) * (len(data) - 1))))
                out[f"p{p}"] = data[idx]
            else:
                out[f"p{p}"] = 0.0
        return out


class P2Quantile:
    """One streaming quantile via the P² (P-square) algorithm: five
    markers adjusted per observation with the parabolic prediction
    formula — O(1) time and O(1) memory per observation, no reservoir,
    no sort.  The estimator of choice for HIGH-RATE streams (the
    serving per-token latency stream observes once per generated
    token); the algorithm-R reservoir :class:`Histogram` stays the
    right tool for low-rate metrics where an exact small-sample
    percentile matters more than constant cost.

    Jain & Chlamtac, "The P² algorithm for dynamic calculation of
    quantiles and histograms without storing observations", CACM 1985.
    """

    __slots__ = ("p", "count", "_heights", "_positions", "_desired",
                 "_increments")

    def __init__(self, p):
        assert 0.0 < p < 1.0, f"quantile must be in (0, 1), got {p}"
        self.p = float(p)
        self.count = 0
        self._heights = []            # marker heights (sorted)
        self._positions = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._desired = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p,
                         3.0 + 2.0 * p, 5.0]
        self._increments = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def observe(self, value):
        value = float(value)
        self.count += 1
        q, n = self._heights, self._positions
        if len(q) < 5:
            # warm-up: collect the first five observations sorted
            q.append(value)
            q.sort()
            return
        # find the cell k with q[k] <= value < q[k+1], clamping extremes
        if value < q[0]:
            q[0] = value
            k = 0
        elif value >= q[4]:
            q[4] = value
            k = 3
        else:
            k = 0
            while k < 3 and value >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._desired[i] += self._increments[i]
        # adjust the three interior markers toward their desired
        # positions (parabolic P² step, linear fallback)
        for i in (1, 2, 3):
            d = self._desired[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) \
                    or (d <= -1.0 and n[i - 1] - n[i] < -1.0):
                d = 1.0 if d >= 1.0 else -1.0
                candidate = q[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (q[i + 1] - q[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1])
                    / (n[i] - n[i - 1]))
                if not (q[i - 1] < candidate < q[i + 1]):
                    # parabolic prediction left the bracket: linear step
                    candidate = q[i] + d * (q[i + int(d)] - q[i]) \
                        / (n[i + int(d)] - n[i])
                q[i] = candidate
                n[i] += d

    @property
    def value(self):
        """The current quantile estimate (exact until 5 observations)."""
        q = self._heights
        if not q:
            return 0.0
        if self.count < 5:
            idx = min(len(q) - 1, int(round(self.p * (len(q) - 1))))
            return q[idx]
        return q[2]

    def markers(self):
        """(count, [(cumulative_fraction, height), ...]) — the
        estimator's state as weighted CDF support points, the merge
        interchange format."""
        q = self._heights
        if not q:
            return 0, []
        if self.count < 5:
            n = len(q)
            return self.count, [((i + 0.5) / n, h)
                                for i, h in enumerate(q)]
        total = self._positions[4]
        return self.count, [(self._positions[i] / total, q[i])
                            for i in range(5)]

    @staticmethod
    def merged_estimate(p, estimators):
        """Approximate p-quantile of the CONCATENATED streams behind
        ``estimators`` (cross-window merge): each window contributes
        its markers as count-weighted CDF support points; the merged
        quantile interpolates the pooled, weight-sorted points.  The
        windows stay O(1) each — no window ever re-sees another's
        observations."""
        points = []       # (height, weight)
        total = 0
        for est in estimators:
            count, marks = est.markers()
            if not count:
                continue
            total += count
            prev = 0.0
            for frac, height in marks:
                points.append((height, max(frac - prev, 1e-12) * count))
                prev = frac
        if not points:
            return 0.0
        points.sort()
        target = p * total
        acc = 0.0
        for height, weight in points:
            acc += weight
            if acc >= target:
                return height
        return points[-1][0]


class StreamingQuantiles:
    """Histogram-shaped instrument over :class:`P2Quantile` estimators:
    count/sum/min/max stream exactly, each tracked percentile is an
    O(1)-per-observation P² estimate.  Snapshots share the histogram
    snapshot shape (count/sum/min/max/mean/p50/p90/p99), so the report
    CLI and the Prometheus exporter render both kinds identically."""

    kind = "quantiles"

    TRACKED = (50, 90, 99)

    def __init__(self, name):
        self.name = name
        self._lock = threading.RLock()
        self._estimators = {p: P2Quantile(p / 100.0)
                            for p in self.TRACKED}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value):
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            for est in self._estimators.values():
                est.observe(value)

    def percentile(self, p):
        with self._lock:
            est = self._estimators.get(int(p))
            return est.value if est is not None else 0.0

    def snapshot(self):
        with self._lock:
            out = {"kind": self.kind, "count": self.count,
                   "sum": self.sum,
                   "min": self.min if self.count else 0.0,
                   "max": self.max if self.count else 0.0,
                   "mean": self.sum / self.count if self.count else 0.0}
            for p in self.TRACKED:
                out[f"p{p}"] = self._estimators[p].value
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "quantiles": StreamingQuantiles}


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    Creation takes the registry lock; subsequent hot-path access is a
    plain dict read the caller typically caches anyway.
    """

    # RLocks throughout (instruments included): the SIGTERM preemption
    # handler runs on the main thread and may record metrics while
    # interrupting a frame that already holds one of these locks
    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}

    def _get(self, name, kind, **kwargs):
        m = self._metrics.get(name)
        if m is not None:
            if m.kind != kind:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {kind}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _KINDS[kind](name, **kwargs)
                self._metrics[name] = m
            elif m.kind != kind:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {kind}")
            return m

    def counter(self, name):
        return self._get(name, "counter")

    def gauge(self, name):
        return self._get(name, "gauge")

    def histogram(self, name, reservoir_size=256):
        return self._get(name, "histogram", reservoir_size=reservoir_size)

    def quantiles(self, name):
        """O(1)-per-observation P² percentile instrument — the accessor
        for HIGH-RATE streams (per-token latency); use
        :meth:`histogram` for low-rate metrics."""
        return self._get(name, "quantiles")

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self):
        """{name: instrument snapshot} — consistent per instrument, not
        across instruments (writers never stop)."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def dump(self, path):
        """Write the snapshot as JSON (the report CLI's metrics input)."""
        snap = self.snapshot()
        tmp = str(path) + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        os.replace(tmp, str(path))
        return snap

    def to_prometheus_text(self, labels=None):
        """Prometheus text-exposition dump of the current snapshot."""
        return prometheus_text({"": self.snapshot()} if labels is None
                               else {labels: self.snapshot()})


def _prom_name(name):
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    base = "".join(out).strip("_")
    return f"deepspeed_tpu_{base}"


def prometheus_text(snapshots_by_label):
    """Prometheus text format for ``{label_value: snapshot_dict}`` (label
    value "" means no label).  Histograms expose _count/_sum plus
    min/max/percentile gauges — the reservoir has no fixed buckets."""
    typed = {}   # prom name -> (prom type, [(labels, value), ...])
    for label, snap in sorted(snapshots_by_label.items()):
        suffix = f'{{rank="{label}"}}' if label != "" else ""
        for name, m in sorted(snap.items()):
            if not isinstance(m, dict) or "kind" not in m:
                # corrupt/torn snapshot entry (e.g. load_metrics' _error
                # sentinel for an unreadable metrics-*.json): skip it so
                # the other ranks' metrics still export — a crashed-run
                # post-mortem is exactly when this tool matters most
                continue
            pname = _prom_name(name)
            if m["kind"] == "counter":
                typed.setdefault(pname + "_total", ["counter", []])[1] \
                    .append((suffix, m["value"]))
            elif m["kind"] == "gauge":
                typed.setdefault(pname, ["gauge", []])[1] \
                    .append((suffix, m["value"]))
            else:
                typed.setdefault(pname + "_count", ["counter", []])[1] \
                    .append((suffix, m["count"]))
                typed.setdefault(pname + "_sum", ["counter", []])[1] \
                    .append((suffix, m["sum"]))
                for stat in ("min", "max", "mean", "p50", "p90", "p99"):
                    typed.setdefault(pname + "_" + stat, ["gauge", []])[1] \
                        .append((suffix, m[stat]))
    lines = []
    for pname in sorted(typed):
        ptype, rows = typed[pname]
        lines.append(f"# TYPE {pname} {ptype}")
        for suffix, value in rows:
            lines.append(f"{pname}{suffix} {value!r}"
                         if isinstance(value, str)
                         else f"{pname}{suffix} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


_DEFAULT_REGISTRY = MetricsRegistry()


def get_registry():
    """The process-local default registry (one per process; engines built
    with telemetry enabled write here unless handed their own)."""
    return _DEFAULT_REGISTRY
