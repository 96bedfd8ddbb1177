"""The per-rank step-latency exchange (port of the file-based half of
``deepspeed_tpu/profiling/comm.py:471-534``; its HLO ``CommLedger`` is
ROADMAP A12's).

Each rank publishes its step-latency ring's snapshot to
``<run_dir>/latency-rank<k>.json`` at the print cadence and reads the
fleet's back; :func:`fleet_skew` turns the per-rank p50s into a
slowest-vs-median ratio, which the engine holds to
``resilience.straggler_factor``.  The files are the JAX package's, so
either package reads the other's.  Stdlib-only: no device access.
"""

import os
import time

from ..resilience.integrity import atomic_publish_json, read_fleet_json_files

LATENCY_FILE_PREFIX = "latency-rank"
LATENCY_FILE_SUFFIX = ".json"

# ``comm`` event kinds (telemetry/events.py EVENT_COMM)
KIND_LATENCY = "latency"
KIND_SKEW = "skew"


def latency_filename(rank):
    return f"{LATENCY_FILE_PREFIX}{rank}{LATENCY_FILE_SUFFIX}"


def publish_rank_latency(run_dir, rank, snapshot, step=None):
    """Atomically publish one rank's latency-ring snapshot to
    ``<run_dir>/latency-rank<k>.json`` (tmp + ``os.replace``: readers
    never see a torn file).  Returns the path, or None on failure
    (fail-soft — a full disk must not take the step loop down)."""
    payload = dict(snapshot)
    payload["rank"] = rank
    payload["ts"] = time.time()
    if step is not None:
        payload["step"] = int(step)
    return atomic_publish_json(
        os.path.join(str(run_dir), latency_filename(rank)), payload,
        log_context="comm skew")


def read_fleet_latencies(run_dir, max_age_secs=None, world_size=None):
    """{rank: snapshot} from every parseable ``latency-rank*.json``
    under ``run_dir`` (torn/foreign files skipped).

    Staleness guards — a fixed run dir accumulates files across runs
    and an elastic fleet shrinks, so a dead rank's last publish must
    not keep raising stragglers forever:

    - ``max_age_secs``: drop snapshots whose publish ``ts`` is older
      (snapshots without a ts pass);
    - ``world_size``: drop integer ranks outside ``[0, world_size)`` —
      definitionally not part of the current run.

    A payload without a ``rank`` key is keyed by the filename digits
    (as a string, exempt from the ``world_size`` filter)."""
    return read_fleet_json_files(run_dir, LATENCY_FILE_PREFIX,
                                 LATENCY_FILE_SUFFIX,
                                 world_size=world_size,
                                 max_age_secs=max_age_secs,
                                 require_key="p50", rank_from_name=True)


def fleet_skew(fleet):
    """Slowest-vs-median straggler metric over per-rank p50 latencies.

    Returns ``{"ranks", "slowest_rank", "slowest", "median", "ratio"}``
    or None when no rank has published.  With one rank the ratio is 1.0
    (no fleet to straggle behind)."""
    rows = [(rank, float(snap["p50"])) for rank, snap in fleet.items()
            if snap.get("p50") and float(snap["p50"]) > 0.0]
    if not rows:
        return None
    rows.sort(key=lambda rv: rv[1])
    vals = [v for _, v in rows]
    mid = len(vals) // 2
    median = (vals[mid] if len(vals) % 2
              else 0.5 * (vals[mid - 1] + vals[mid]))
    slowest_rank, slowest = rows[-1]
    return {"ranks": len(rows), "slowest_rank": slowest_rank,
            "slowest": slowest, "median": median,
            "ratio": slowest / median if median > 0 else 1.0}
