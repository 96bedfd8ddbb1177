"""Schema-versioned, rank- and seq-tagged structured JSONL event stream
(port of ``deepspeed_tpu/telemetry/events.py``: the schema version, the
type table and the file names are the JAX package's, so either
package's reader takes the other's run dir).

One line per event, one file per writer (``events-rank<k>.jsonl`` for
training processes, ``events-launcher.jsonl`` for the node spawner), all
under ``<run_dir>/``.  This unifies what used to exist only as scattered
log lines: monitor scalars, resilience anomaly/rollback/watchdog events,
checkpoint lifecycle, loss-scale changes, and launcher restarts — every
record queryable from artifacts (the report CLI,
``python -m deepspeed_tpu_torch.telemetry report``), not grep'd from stdout.

Record envelope (stable across schema versions)::

    {"schema_version": 1, "seq": 17, "rank": 0, "ts": 1712.3,
     "type": "anomaly", "step": 42, "data": {...}}

``seq`` is per-writer monotonic, so a merged multi-rank timeline has a
total order within each rank even when wall clocks disagree.  ``step``
is the engine's ``global_steps`` at emit time (None for events outside
the step loop, e.g. launcher respawns).

Stdlib-only: the report CLI reads events without importing torch.
"""

import json
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

SCHEMA_VERSION = 1

EVENTS_FILE_PREFIX = "events-"
EVENTS_FILE_SUFFIX = ".jsonl"

# -- event types + their required data keys (the golden schema) -------------
EVENT_RUN_START = "run_start"
EVENT_RUN_RESUME = "run_resume"
EVENT_RUN_END = "run_end"
EVENT_STEP_METRICS = "step_metrics"
EVENT_ANOMALY = "anomaly"
EVENT_ROLLBACK = "rollback"
EVENT_ABORT = "abort"
EVENT_WATCHDOG_HANG = "watchdog_hang"
EVENT_LOSS_SCALE = "loss_scale"
EVENT_CKPT_QUEUED = "ckpt_queued"
EVENT_CKPT_COMMIT = "ckpt_commit"
EVENT_CKPT_FAILED = "ckpt_failed"
EVENT_PREEMPTION = "preemption"
EVENT_PROC_SPAWN = "proc_spawn"
EVENT_PROC_EXIT = "proc_exit"
EVENT_PROC_RESPAWN = "proc_respawn"
# one per backend compile (runtime/compilation telemetry bridge); cache
# hits/misses ride the metrics registry as compile/cache_hit|miss
# counters — they are high-frequency bookkeeping, not timeline moments
EVENT_COMPILE = "compile"
# memory observability (profiling/memory): ``kind`` selects the payload
# shape — "program" (one per compiled program: memory_analysis bytes),
# "watermark" (live HBM in-use/peak summed over local devices, sampled
# only at the steps_per_print cadence), "host_buffers" (the pinned-host
# offload buffer registry)
EVENT_MEMORY = "memory"
# communication observability (profiling/comm): ``kind`` selects the
# payload shape — "program" (one per compiled program: collective
# count/payload/replica groups/predicted wire bytes walked out of the
# optimized HLO at compile time), "latency" (this rank's step-latency
# ring summary, exported only at the steps_per_print cadence), "skew"
# (the fleet slowest-vs-median straggler snapshot)
EVENT_COMM = "comm"
# step-time attribution (profiling/attribution): the reconciled
# per-step budget — phases (compute / exposed_collective / host_stream
# / driver / unexplained) summing to the measured p50, the predicted
# step seconds, and the unexplained fraction — exported only at the
# steps_per_print cadence from scalars the engine already holds
EVENT_ATTRIBUTION = "attribution"
# elastic resize-on-failure loop (launcher/launch.py elastic supervisor
# + engine elastic restore): ``phase`` selects the payload shape —
# "plan" (the HCN planner's re-plan after a failure: surviving device
# budget, planned world size + micro x accum factorization), "resize"
# (the fleet respawn at the planned size), "restore" (a checkpoint
# restored onto a DIFFERENT dp degree than wrote it), "evict" (the
# supervisor consuming an integrity verdict: suspect rank/slot charged
# against the elastic budget before the resize).  Together they are
# the resize timeline ``telemetry report`` prints.
EVENT_ELASTIC = "elastic"
# fleet integrity plane (resilience/integrity.py): one record per
# consensus vote at the steps_per_print cadence and per hang-quorum
# fire.  ``verdict`` is ok | outlier | no_majority | pending; ``kind``
# says what voted ("fingerprint" majority vote vs "hang_quorum"
# staleness); ``suspects`` names the ranks a non-ok verdict indicts
EVENT_INTEGRITY = "integrity"
# serving subsystem (inference/engine + frontend + resilience): ``kind``
# selects the payload shape — "admit" (a request entered the continuous
# batch: prompt tokens, prefill bucket, block grant, slot), "finish" (a
# slot was recycled mid-batch: finish reason, generated tokens), "queue"
# (the steps_per_print-cadence occupancy snapshot: queue depth, active
# slots, free KV blocks, reserved token budget).  The resilience plane
# adds: "deadline" (a request's wall-clock deadline expired; partial
# tokens returned), "shed" (admission refused at max_queue_depth),
# "degrade" (generation cap dropped under queue pressure), "requeue" (a
# dead replica's in-flight request reset and re-dispatched), "evict" (a
# replica convicted by hang quorum or weight-fingerprint consensus),
# "drain" (SIGTERM/close bounded drain of the in-flight batch).  The
# observability plane (inference/observability) adds the
# schema-versioned lifecycle records — "submit" (trace minted, before
# the shed decision), "first_token" (TTFT + prefill seconds),
# "decode_window" (the cadence occupancy/budget window with its active
# trace ids) and "slo" (per-window goodput vs raw throughput) — and
# threads ``trace``/``schema``/``t_mono`` through the older kinds;
# inference.observability.SERVING_PHASE_KEYS is the per-kind required
# payload table the golden-schema test pins
EVENT_SERVING = "serving"

# type -> required data keys.  The report CLI and the golden-schema test
# validate against this table; emitting an unknown type or dropping a
# required key is a programming error caught in tests, not silently
# shipped into run artifacts.
EVENT_TYPES = {
    EVENT_RUN_START: ("world_size",),
    EVENT_RUN_RESUME: ("checkpoint",),
    EVENT_RUN_END: ("reason",),
    EVENT_STEP_METRICS: ("scalars",),
    EVENT_ANOMALY: ("kind", "detail", "consecutive"),
    EVENT_ROLLBACK: ("reason", "from_step", "restored_path"),
    EVENT_ABORT: ("reason",),
    EVENT_WATCHDOG_HANG: ("stalled_secs", "timeout_secs"),
    EVENT_LOSS_SCALE: ("scale", "prev_scale"),
    EVENT_CKPT_QUEUED: ("tag", "queue_depth"),
    EVENT_CKPT_COMMIT: ("tag", "latency_secs", "bytes", "retries"),
    EVENT_CKPT_FAILED: ("tag", "error"),
    EVENT_PREEMPTION: ("signum",),
    EVENT_PROC_SPAWN: ("proc_rank", "pid"),
    EVENT_PROC_EXIT: ("proc_rank", "code"),
    EVENT_PROC_RESPAWN: ("proc_rank", "restart", "backoff_secs"),
    EVENT_COMPILE: ("duration_secs",),
    EVENT_MEMORY: ("kind",),
    EVENT_COMM: ("kind",),
    EVENT_ATTRIBUTION: ("program", "phases", "predicted_step_seconds",
                        "measured_step_seconds",
                        "step_unexplained_fraction"),
    EVENT_ELASTIC: ("phase",),
    EVENT_INTEGRITY: ("verdict", "kind", "suspects"),
    EVENT_SERVING: ("kind",),
}


def events_filename(rank):
    return f"{EVENTS_FILE_PREFIX}rank{rank}{EVENTS_FILE_SUFFIX}"


class EventLog:
    """Append-only JSONL writer for one rank's event stream.

    Thread-safe: the step loop, checkpoint-writer threads, and the
    watchdog all emit through one instance.  Every record is flushed on
    write — events are rare (print cadence, lifecycle transitions), and
    an unflushed tail is exactly what a post-mortem needs most.  A
    failing sink disables itself LOUDLY (one logged error) instead of
    taking training down or silently eating events.
    """

    def __init__(self, run_dir, rank=0, filename=None):
        self.run_dir = str(run_dir)
        self.rank = rank
        # RLock: the SIGTERM preemption handler runs ON the main thread
        # and emits events — it may interrupt a frame that already holds
        # this lock (same rationale as checkpoint/manager.py's RLocks)
        self._lock = threading.RLock()
        self._seq = 0
        self._f = None
        self._dead = False
        os.makedirs(self.run_dir, exist_ok=True)
        self.path = os.path.join(
            self.run_dir, filename or events_filename(rank))
        self._f = open(self.path, "a", encoding="utf-8")

    def emit(self, event_type, step=None, **data):
        """Write one event; returns the record dict (None if the sink is
        closed/dead).  Unknown ``event_type`` values are allowed (forward
        compatibility) but the known types are schema-checked in tests."""
        record = {
            "schema_version": SCHEMA_VERSION,
            "seq": None,            # assigned under the lock below
            "rank": self.rank,
            "ts": time.time(),
            "type": str(event_type),
            "step": int(step) if step is not None else None,
            "data": data,
        }
        with self._lock:
            if self._f is None or self._dead:
                return None
            record["seq"] = self._seq
            self._seq += 1
            try:
                self._f.write(json.dumps(record) + "\n")
                self._f.flush()
            except OSError as e:
                self._dead = True
                logger.error("telemetry event sink %s failed (%s); "
                             "disabling further event writes", self.path, e)
                return None
        return record

    def flush(self):
        with self._lock:
            if self._f is not None and not self._dead:
                try:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                except OSError:
                    self._dead = True
        return not self._dead

    def close(self):
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    self._f.close()
                except (OSError, ValueError) as e:
                    logger.warning("telemetry event sink %s close failed: "
                                   "%s", self.path, e)
                self._f = None

    @property
    def closed(self):
        return self._f is None


def validate_event(record):
    """Return a list of schema problems with one decoded record (empty =
    valid).  Unknown types only require the envelope."""
    problems = []
    for field in ("schema_version", "seq", "rank", "ts", "type", "data"):
        if field not in record:
            problems.append(f"missing envelope field {field!r}")
    if problems:
        return problems
    if record["schema_version"] > SCHEMA_VERSION:
        problems.append(
            f"schema_version {record['schema_version']} is newer than "
            f"this reader ({SCHEMA_VERSION})")
    required = EVENT_TYPES.get(record["type"], ())
    for key in required:
        if key not in record["data"]:
            problems.append(
                f"event type {record['type']!r} missing data key {key!r}")
    return problems


def iter_rank_files(run_dir):
    """Yield (stream_name, path) for every event stream under run_dir."""
    run_dir = str(run_dir)
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return
    for name in names:
        if (name.startswith(EVENTS_FILE_PREFIX)
                and name.endswith(EVENTS_FILE_SUFFIX)):
            stream = name[len(EVENTS_FILE_PREFIX):-len(EVENTS_FILE_SUFFIX)]
            yield stream, os.path.join(run_dir, name)


def read_events(run_dir, strict=False):
    """Merge every per-rank stream under ``run_dir`` into one list sorted
    by (ts, rank-stream, seq).  Undecodable lines are skipped (or raise,
    with ``strict=True``) — a crashed writer may leave a torn last line,
    and the rest of the stream is still evidence."""
    merged = []
    for stream, path in iter_rank_files(run_dir):
        with open(path, "r", encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    if strict:
                        raise ValueError(
                            f"{path}:{lineno}: undecodable event line: "
                            f"{e}") from e
                    continue
                rec["_stream"] = stream
                merged.append(rec)
    merged.sort(key=lambda r: (r.get("ts", 0.0), str(r.get("_stream")),
                               r.get("seq", 0)))
    return merged
