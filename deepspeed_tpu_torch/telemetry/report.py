"""Run-report CLI: reconstruct "what happened in this run?" from
artifacts alone (port of ``deepspeed_tpu/telemetry/report.py``; it reads
a run dir that either package wrote).

``python -m deepspeed_tpu_torch.telemetry report <run_dir>`` merges the
per-rank event streams (``events-rank*.jsonl``) and metric snapshots
(``metrics-rank*.json``) under ``run_dir`` and prints:

- a **timeline**: every lifecycle event (run start/resume/end, anomalies,
  rollbacks, watchdog trips, checkpoint queue/commit/failure, loss-scale
  moves, launcher spawns/respawns/exits) with its step and rank.  Ranks
  are **clock-aligned**: each stream's clock anchors on its own first
  spawn/step event, so a rank the launcher respawned minutes later
  interleaves with its siblings by run-relative time instead of sorting
  after everything (the raw-wall-clock ordering is still available via
  ``--json``);
- **metric summaries**: counters, gauges, and histogram percentiles per
  rank;
- with ``--comm``, the communication section: the per-program collective
  table (count / payload bytes / predicted wire bytes / exposed wire
  seconds from the comm ledger's phase records and overlap summaries),
  a per-step cross-rank latency table
  with a slowest-vs-median skew column, and the straggler verdicts;
- with ``--prometheus``, a Prometheus text-exposition dump of the merged
  metric snapshots (for scraping a finished or running job's artifacts);
- with ``--serving``, the serving section: the per-trace request
  timeline, the occupancy windows, SLO attainment and the
  shed/degrade/requeue accounting;
- with ``--json``, a machine-readable report document — summary, comm,
  elastic sections, plus the merged event list under ``events``.

With ``--doctor``, the step-time attribution section: the reconciled
per-rank phase table and straggler explanation of
``profiling/doctor.py``, from the run's ``programs/`` sidecars
(``profiling.program_dump``); the serving section's tail-request
decomposition is the doctor's too.  The JAX CLI's ``--diff`` of two
bench records has no port counterpart.

Stdlib-only: runs anywhere the artifacts are mounted, no torch required.
"""

import argparse
import json
import os
import sys

from . import events as ev
from .registry import prometheus_text

# event types that belong on the timeline; step_metrics is summarized
# instead (a 100k-step run would drown the lifecycle in scalar lines)
_TIMELINE_SKIP = {ev.EVENT_STEP_METRICS}

METRICS_GLOB_PREFIX = "metrics-"
METRICS_GLOB_SUFFIX = ".json"


def load_metrics(run_dir):
    """{stream_name: snapshot_dict} for every metrics-*.json in run_dir."""
    out = {}
    try:
        names = sorted(os.listdir(str(run_dir)))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(METRICS_GLOB_PREFIX)
                and name.endswith(METRICS_GLOB_SUFFIX)):
            continue
        stream = name[len(METRICS_GLOB_PREFIX):-len(METRICS_GLOB_SUFFIX)]
        try:
            with open(os.path.join(str(run_dir), name),
                      encoding="utf-8") as f:
                out[stream] = json.load(f)
        except (OSError, ValueError):
            out[stream] = {"_error": f"unreadable {name}"}
    return out


def _fmt_value(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _fmt_data(data):
    return " ".join(f"{k}={_fmt_value(v)}" for k, v in sorted(data.items())
                    if k != "scalars")


# stream-anchor event types, in anchor priority: a stream's clock zero is
# its first spawn/(re)start event — NOT the merged run's first event —
# so ranks whose runs started at different wall times (the launcher
# respawn case) compare by run-relative time
_ANCHOR_TYPES = (ev.EVENT_RUN_START, ev.EVENT_RUN_RESUME,
                 ev.EVENT_PROC_SPAWN, ev.EVENT_STEP_METRICS)


def rank_time_anchors(records):
    """{stream_name: anchor_ts}: each stream's first spawn/step event's
    wall time (first event at all when none match)."""
    anchors = {}
    fallback = {}
    for rec in records:                       # records are ts-sorted
        stream = rec.get("_stream")
        fallback.setdefault(stream, rec.get("ts", 0.0))
        if stream not in anchors and rec.get("type") in _ANCHOR_TYPES:
            anchors[stream] = rec.get("ts", 0.0)
    for stream, ts in fallback.items():
        anchors.setdefault(stream, ts)
    return anchors


def align_records(records):
    """Attach ``_rel`` (seconds since the stream's own anchor) to every
    record and return a new list sorted by it — the clock-aligned
    cross-rank ordering the timeline and skew tables print."""
    anchors = rank_time_anchors(records)
    out = []
    for rec in records:
        rec = dict(rec)
        rec["_rel"] = rec.get("ts", 0.0) - anchors.get(
            rec.get("_stream"), 0.0)
        out.append(rec)
    out.sort(key=lambda r: (r.get("_rel", 0.0), str(r.get("_stream")),
                            r.get("seq", 0)))
    return out


def format_event(record):
    step = record.get("step")
    step_s = f"step={step}" if step is not None else "step=-"
    rel = record.get("_rel", record.get("ts", 0.0))
    return (f"  t=+{rel:9.3f}s {step_s:<12} rank={record.get('rank')} "
            f"{record.get('type'):<16} {_fmt_data(record.get('data', {}))}")


def format_timeline(records):
    """Clock-aligned lifecycle timeline lines (one per event, rank- and
    step-tagged; ``t=+`` is seconds since each rank's OWN first
    spawn/step event)."""
    if not records:
        return ["  (no events)"]
    lines = []
    for rec in align_records(records):
        if rec.get("type") in _TIMELINE_SKIP:
            continue
        lines.append(format_event(rec))
    return lines or ["  (no lifecycle events)"]


def summarize_step_metrics(records):
    """Compact summary of the step_metrics stream: count, step range, and
    first/last value of each scalar tag."""
    metrics = [r for r in records if r.get("type") == ev.EVENT_STEP_METRICS]
    if not metrics:
        return ["  (no step_metrics events)"]
    steps = [r.get("step") for r in metrics if r.get("step") is not None]
    lines = [f"  {len(metrics)} step_metrics event(s)"
             + (f", steps {min(steps)}..{max(steps)}" if steps else "")]
    tags = {}
    for rec in metrics:
        for tag, val in rec.get("data", {}).get("scalars", {}).items():
            tags.setdefault(tag, []).append(val)
    for tag in sorted(tags):
        vals = tags[tag]
        lines.append(f"    {tag}: first={_fmt_value(vals[0])} "
                     f"last={_fmt_value(vals[-1])}")
    return lines


def format_metrics(metrics_by_stream):
    lines = []
    for stream in sorted(metrics_by_stream):
        snap = metrics_by_stream[stream]
        lines.append(f"  [{stream}]")
        for name in sorted(snap):
            m = snap[name]
            if not isinstance(m, dict) or "kind" not in m:
                lines.append(f"    {name}: {m}")
            elif m["kind"] in ("histogram", "quantiles"):
                # same snapshot shape: the reservoir histogram and the
                # P² streaming-quantile instrument both quote
                # count/mean/p50/p99/max
                lines.append(
                    f"    {name}: count={m['count']} "
                    f"mean={_fmt_value(m['mean'])} "
                    f"p50={_fmt_value(m['p50'])} "
                    f"p99={_fmt_value(m['p99'])} "
                    f"max={_fmt_value(m['max'])}")
            else:
                lines.append(f"    {name}: {_fmt_value(m['value'])}")
    return lines or ["  (no metric snapshots)"]


def _fmt_bytes(n):
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return (f"{n:.0f}{unit}" if unit == "B"
                    else f"{n:.2f}{unit}")
        n /= 1024.0


def elastic_timeline(records):
    """The resize story in one block: every ``elastic`` event
    (plan / resize / restore) in clock-aligned order, with the world-size
    transition spelled out per line.  Returned empty when the run never
    resized — the section only prints for elastic runs."""
    elastic = [r for r in align_records(records)
               if r.get("type") == ev.EVENT_ELASTIC]
    if not elastic:
        return []
    lines = []
    for rec in elastic:
        d = rec.get("data", {})
        phase = d.get("phase", "?")
        if phase == "plan":
            detail = (f"surviving={d.get('surviving_devices')} -> "
                      f"world {d.get('prev_world_size')}->"
                      f"{d.get('planned_world_size')} "
                      f"(micro={d.get('micro_batch')} x "
                      f"accum={d.get('grad_accum')}, "
                      f"global={d.get('global_batch')})")
        elif phase == "resize":
            detail = (f"respawned {d.get('procs')} proc(s) at world "
                      f"{d.get('world_size')} (restart "
                      f"{d.get('restart')})")
        elif phase == "restore":
            detail = (f"checkpoint dp={d.get('from_dp')} restored onto "
                      f"dp={d.get('to_dp')} ({d.get('checkpoint')})")
        elif phase == "evict":
            detail = (f"integrity verdict ({d.get('kind')}): rank "
                      f"{d.get('suspect')} / slot {d.get('slot')} "
                      f"charged against the elastic budget "
                      f"(eviction {d.get('eviction')})")
        else:
            detail = _fmt_data(d)
        rel = rec.get("_rel", rec.get("ts", 0.0))
        lines.append(f"  t=+{rel:9.3f}s rank={rec.get('rank')} "
                     f"{phase:<8} {detail}")
    return lines


def integrity_summary(records):
    """The fleet-integrity story in one block: consensus participation,
    every non-ok verdict with its suspects, and hang-quorum fires.
    Returned empty when the run never emitted an ``integrity`` event —
    the section only prints for integrity-enabled runs."""
    integ = [r for r in align_records(records)
             if r.get("type") == ev.EVENT_INTEGRITY]
    if not integ:
        return []
    votes = [r for r in integ
             if r.get("data", {}).get("kind") == "fingerprint"]
    ok = sum(1 for r in votes
             if r.get("data", {}).get("verdict") in ("ok", "pending"))
    lines = [f"  fingerprint votes: {len(votes)} "
             f"({ok} ok/pending, {len(votes) - ok} flagged)"]
    for rec in integ:
        d = rec.get("data", {})
        verdict = d.get("verdict")
        if d.get("kind") == "hang_quorum":
            detail = (f"hang quorum: rank(s) {d.get('suspects')} stalled "
                      f"{d.get('stalled_secs', 0.0):.1f}s at step "
                      f"{d.get('suspect_step')} while {d.get('voters')} "
                      f"peer(s) reached step {d.get('head_step')}")
        elif verdict in ("ok", "pending"):
            continue
        elif verdict == "outlier":
            detail = (f"fingerprint outlier: rank(s) {d.get('suspects')} "
                      f"disagree with the {d.get('voters')}-voter "
                      f"majority {d.get('majority_fingerprint')} at "
                      f"step {d.get('voted_step')}")
        else:
            detail = (f"{verdict}: {d.get('voters')} voter(s) at step "
                      f"{d.get('voted_step')} — no replica majority "
                      f"to trust")
        rel = rec.get("_rel", rec.get("ts", 0.0))
        lines.append(f"  t=+{rel:9.3f}s rank={rec.get('rank')} {detail}")
    if len(lines) == 1:
        lines.append("  no non-ok verdict: every vote agreed bit-exactly")
    return lines


# the EVENT_SERVING kinds that belong to the resilience plane (routing
# verdicts), as opposed to the decode plane's admit/finish/queue flow
_SERVING_RESILIENCE_KINDS = ("deadline", "shed", "degrade", "requeue",
                             "evict", "drain")


def serving_resilience_summary(records):
    """The serving-resilience story in one block: how many requests were
    shed / degraded / requeued / deadline-expired, plus every replica
    eviction and drain with its detail line.  Returned empty when the
    run emitted none of the resilience kinds — plain serving runs and
    training runs skip the section entirely."""
    serving = [r for r in align_records(records)
               if r.get("type") == ev.EVENT_SERVING
               and r.get("data", {}).get("kind")
               in _SERVING_RESILIENCE_KINDS]
    if not serving:
        return []
    counts = {}
    for rec in serving:
        kind = rec["data"]["kind"]
        counts[kind] = counts.get(kind, 0) + 1
    lines = ["  " + " ".join(f"{k}={counts.get(k, 0)}"
                             for k in _SERVING_RESILIENCE_KINDS)]
    for rec in serving:
        d = rec.get("data", {})
        kind = d.get("kind")
        if kind == "requeue":
            detail = (f"requeue: request {d.get('request')} off dead "
                      f"replica {d.get('replica')} (attempt "
                      f"{d.get('requeues')}, backoff "
                      f"{d.get('backoff_secs', 0.0):.2f}s)")
        elif kind == "shed":
            detail = (f"shed: queue depth {d.get('queue_depth')} at "
                      f"max_queue_depth {d.get('max_queue_depth')}")
        elif kind == "evict":
            detail = (f"evict: replica {d.get('suspect')} convicted "
                      f"({d.get('reason', d.get('detail', '?'))})")
        elif kind == "drain":
            detail = (f"drain: {d.get('active')} active + "
                      f"{d.get('queued')} queued, deadline "
                      f"{d.get('deadline_secs')}s")
        else:
            continue  # deadline/degrade are counted, not itemized
        rel = rec.get("_rel", rec.get("ts", 0.0))
        lines.append(f"  t=+{rel:9.3f}s rank={rec.get('rank')} {detail}")
    return lines


def format_serving_section(records, run_dir=None):
    """The serving observability section (``report --serving``): the
    per-trace request timeline, the cadence occupancy windows, SLO
    attainment and shed/degrade/requeue accounting.  Built from the
    schema-versioned EVENT_SERVING lifecycle records the observability
    plane emits; the tail request's decomposition is the doctor's
    (``profiling/doctor.py``)."""
    from ..profiling.doctor import (format_serving_tail, serving_traces,
                                    serving_tail_decomposition)

    out = ["serving (request traces / occupancy / SLO):"]
    aligned = align_records(records)
    traces = serving_traces(records)
    if not traces:
        out.append("  (no serving lifecycle traces — run with telemetry "
                   "events enabled)")
        return out
    # -- request timeline ------------------------------------------------
    terminal_counts = {}
    for t in traces.values():
        term = t.get("terminal") or "in_flight"
        terminal_counts[term] = terminal_counts.get(term, 0) + 1
    out.append(f"  {len(traces)} trace(s): " + " ".join(
        f"{k}={terminal_counts[k]}" for k in sorted(terminal_counts)))
    shown = 0
    for trace in sorted(
            traces,
            key=lambda tr: (traces[tr].get("submit") or {}).get(
                "t_mono", 0.0)):
        t = traces[trace]
        if shown >= 20:
            out.append(f"  ... {len(traces) - shown} more trace(s)")
            break
        shown += 1
        term = t.get("terminal") or "in_flight"
        fin = t.get("finish") or {}
        parts = [f"  {trace} req={t.get('request', '?')}"]
        if t.get("admit", {}).get("wait_seconds") is not None:
            parts.append(f"wait={t['admit']['wait_seconds'] * 1e3:.1f}ms")
        if t.get("first_token", {}).get("ttft_seconds") is not None:
            parts.append(
                f"ttft={t['first_token']['ttft_seconds'] * 1e3:.1f}ms")
        if t["requeues"]:
            parts.append(f"requeues={t['requeues']}")
        parts.append(f"-> {term}")
        if fin.get("latency_seconds") is not None:
            parts.append(f"({fin['latency_seconds'] * 1e3:.1f}ms, "
                         f"{fin.get('generated_tokens')} tok, "
                         f"{fin.get('reason')})")
        out.append(" ".join(parts))
    # -- occupancy windows -----------------------------------------------
    windows = [r for r in aligned if r.get("type") == ev.EVENT_SERVING
               and r.get("data", {}).get("kind") == "decode_window"]
    if windows:
        out.append("  occupancy windows (steps_per_print cadence):")
        out.append(f"    {'t':>10} {'iters':>5} {'tokens':>6} "
                   f"{'occupancy':>9} {'budget':>7} {'kv used':>7} "
                   f"{'kv peak':>7}")
        for rec in windows:
            d = rec["data"]
            rel = rec.get("_rel", rec.get("ts", 0.0))
            out.append(
                f"    +{rel:8.3f}s {d.get('iterations', 0):>5} "
                f"{d.get('tokens', 0):>6} "
                f"{d.get('batch_occupancy', 0.0):>8.1%} "
                f"{d.get('token_budget_utilization', 0.0):>6.1%} "
                f"{d.get('kv_used_blocks', 0):>7} "
                f"{d.get('kv_used_peak', 0):>7}")
    # -- SLO attainment ---------------------------------------------------
    slo = [r for r in aligned if r.get("type") == ev.EVENT_SERVING
           and r.get("data", {}).get("kind") == "slo"]
    if slo:
        total = sum(int(r["data"].get("window_tokens") or 0) for r in slo)
        good = sum(int(r["data"].get("goodput_tokens") or 0) for r in slo)
        out.append(
            f"  SLO: {good}/{total} token(s) within target "
            f"({good / total if total else 1.0:.1%} attainment) across "
            f"{len(slo)} window(s)")
    # -- shed/degrade/requeue accounting ----------------------------------
    counts = {}
    for rec in records:
        if rec.get("type") != ev.EVENT_SERVING:
            continue
        kind = rec.get("data", {}).get("kind")
        if kind in ("shed", "degrade", "requeue", "deadline"):
            counts[kind] = counts.get(kind, 0) + 1
    if counts:
        out.append("  pressure: " + " ".join(
            f"{k}={counts[k]}" for k in sorted(counts)))
    # -- doctor tail decomposition ----------------------------------------
    if run_dir is not None:
        out.extend(format_serving_tail(serving_tail_decomposition(run_dir)))
    return out


def comm_program_table(records):
    """Per-program collective table from ``comm``/``program`` events
    (latest event wins per (stream, program))."""
    progs = {}
    for rec in records:
        data = rec.get("data", {})
        if rec.get("type") == ev.EVENT_COMM and data.get("kind") == "program":
            progs[(str(rec.get("_stream")), str(data.get("program")))] = data
    if not progs:
        return ["  (no comm program events — enable profiling.comm_ledger)"]
    lines = [f"  {'program':<24} {'rank':<10} {'colls':>5} "
             f"{'payload':>10} {'wire/step':>10} {'exposed (overlap)':>18}"
             f"  ops"]
    for (stream, program) in sorted(progs):
        d = progs[(stream, program)]
        ops = d.get("ops", {}) or {}
        ops_s = " ".join(f"{op}:{ops[op].get('count', 0)}"
                         f"(g{ops[op].get('max_group', 1)})"
                         for op in sorted(ops)) or "-"
        ov = d.get("overlap")
        exposed = ("-" if not ov else
                   f"{ov['exposed_wire_seconds'] * 1e3:.3f}ms "
                   f"({ov['overlap_fraction']:.0%})")
        lines.append(
            f"  {program:<24} {stream:<10} "
            f"{d.get('collectives', 0):>5} "
            f"{_fmt_bytes(d.get('payload_bytes')):>10} "
            f"{_fmt_bytes(d.get('wire_bytes')):>10} {exposed:>18}  {ops_s}")
    return lines


def comm_skew_table(records):
    """Per-step cross-rank latency table with a slowest-vs-median skew
    column, from ``comm``/``latency`` events (per-rank ring snapshots at
    the steps_per_print cadence)."""
    by_step = {}
    streams = set()
    for rec in records:
        data = rec.get("data", {})
        if (rec.get("type") == ev.EVENT_COMM
                and data.get("kind") == "latency"
                and rec.get("step") is not None
                and data.get("p50")):
            stream = str(rec.get("_stream"))
            streams.add(stream)
            by_step.setdefault(int(rec["step"]), {})[stream] = float(
                data["p50"])
    if not by_step:
        return ["  (no comm latency events)"]
    streams = sorted(streams)
    head = "  " + f"{'step':>6} " + " ".join(
        f"{('p50[' + s + ']'):>14}" for s in streams) + f" {'skew':>6}"
    lines = [head]
    for step in sorted(by_step):
        row = by_step[step]
        vals = sorted(row.values())
        mid = len(vals) // 2
        median = (vals[mid] if len(vals) % 2
                  else 0.5 * (vals[mid - 1] + vals[mid]))
        skew = (vals[-1] / median) if median > 0 else 1.0
        cells = " ".join(
            (f"{row[s]*1e3:>12.2f}ms" if s in row else f"{'-':>14}")
            for s in streams)
        lines.append(f"  {step:>6} {cells} {skew:>5.2f}x")
    return lines


# measured latency = median over the LAST this-many latency snapshots
# per stream.  "Last snapshot wins" misstated the verdict whenever a
# resized/respawned rank's stale first-life snapshot sorted last
# (cross-life clock skew); the window median shrugs one outlier off.
MEASURED_LATENCY_WINDOW = 5


def _median(values):
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    mid = len(vals) // 2
    return (vals[mid] if len(vals) % 2
            else 0.5 * (vals[mid - 1] + vals[mid]))


def _median_of_window(values, window):
    """Median of the LAST ``window`` positive values (None when none),
    the JAX package's ``attribution.median_of_window``."""
    return _median([float(v) for v in values
                    if v and float(v) > 0.0][-max(int(window), 1):])


def measured_latencies(records, window=MEASURED_LATENCY_WINDOW):
    """{stream: p50 seconds} — the median of each stream's last
    ``window`` ``comm``/``latency`` snapshots (ts order), shared by the
    comm summary, the ``--json`` document, and the attribution
    doctor."""
    by_stream = {}
    for rec in records:                        # records are ts-sorted
        data = rec.get("data", {})
        if (rec.get("type") == ev.EVENT_COMM
                and data.get("kind") == "latency" and data.get("p50")
                and float(data["p50"]) > 0):
            by_stream.setdefault(str(rec.get("_stream")), []).append(
                float(data["p50"]))
    return {stream: _median_of_window(vals, window)
            for stream, vals in by_stream.items()}


_STEPWISE_PROGRAMS = ("fwd_bwd", "apply_update")


def comm_summary(records):
    """Predicted-vs-measured closing lines: the step program's predicted
    wire bytes next to each rank's measured p50 step latency (median of
    the last snapshot window), plus any straggler verdicts."""
    lines = []
    wire = {}
    exposure = {}
    stepwise = {}
    measured = measured_latencies(records)
    for rec in records:
        data = rec.get("data", {})
        if rec.get("type") != ev.EVENT_COMM:
            if (rec.get("type") == ev.EVENT_ANOMALY
                    and data.get("kind") == "straggler"):
                lines.append(f"  STRAGGLER step={rec.get('step')} "
                             f"rank={rec.get('rank')}: "
                             f"{data.get('detail')}")
            continue
        stream = str(rec.get("_stream"))
        if (data.get("kind") == "program"
                and data.get("program") in ("train_step",
                                            "train_step_compressed")):
            wire[stream] = data.get("wire_bytes")
            if data.get("overlap"):
                exposure[stream] = data["overlap"]
        elif (data.get("kind") == "program"
              and data.get("program") in _STEPWISE_PROGRAMS):
            # the port's step-wise phases: one step is their sum (one
            # micro-batch's fwd_bwd)
            stepwise.setdefault(stream, {})[data["program"]] = data
    for stream, progs in stepwise.items():
        if stream in wire:
            continue
        wire[stream] = sum(int(d.get("wire_bytes") or 0)
                           for d in progs.values())
        ovs = [d["overlap"] for d in progs.values() if d.get("overlap")]
        if ovs:
            w = sum(o["wire_seconds"] for o in ovs)
            x = sum(o["exposed_wire_seconds"] for o in ovs)
            exposure[stream] = {"exposed_wire_seconds": x,
                                "overlap_fraction": (1.0 - x / w) if w > 0
                                else 1.0}
    for stream in sorted(set(wire) | set(measured)):
        w, m = wire.get(stream), measured.get(stream)
        ov = exposure.get(stream)
        exposed = ("" if ov is None else
                   f", exposed wire {ov['exposed_wire_seconds']*1e3:.3f}"
                   f"ms (overlap {ov['overlap_fraction']:.0%})")
        lines.append(
            f"  [{stream}] predicted step wire {_fmt_bytes(w)}{exposed}"
            + (f", measured step p50 {m*1e3:.2f}ms" if m else
               ", no measured steps"))
    return lines or ["  (no step program / latency events)"]


def format_comm_section(records):
    out = ["comm programs (per-phase collective receipts):"]
    out.extend(comm_program_table(records))
    out.append("")
    out.append("per-step cross-rank latency (skew = slowest/median):")
    out.extend(comm_skew_table(records))
    out.append("")
    out.append("comm summary:")
    out.extend(comm_summary(records))
    return out


def doctor_verdict(run_dir, grad_accumulation_steps=1):
    """The step-time attribution doctor's verdict for ``run_dir``
    (``profiling/doctor.py``), or ``{"error": ...}`` when the run never
    dumped its programs: the report section says why instead of
    vanishing.  ``grad_accumulation_steps`` (CLI: ``--grad-accum``)
    weights step-wise program sets."""
    try:
        from ..profiling.doctor import doctor_run_dir

        return doctor_run_dir(
            run_dir, grad_accumulation_steps=grad_accumulation_steps)
    except (FileNotFoundError, OSError, ValueError, ImportError) as e:
        return {"error": str(e)}


def format_doctor_section(verdict):
    out = ["step-time attribution (doctor):"]
    if verdict.get("error"):
        out.append(f"  unavailable: {verdict['error']}")
        return out
    from ..profiling.doctor import format_verdict

    out.extend(format_verdict(verdict))
    return out


def generate_report(run_dir, strict=False, comm=False, doctor=False,
                    serving=False, grad_accumulation_steps=1):
    """Full text report for ``run_dir``; returns (text, events)."""
    records = ev.read_events(run_dir, strict=strict)
    problems = []
    for rec in records:
        problems.extend(f"{rec.get('_stream')}#{rec.get('seq')}: {p}"
                        for p in ev.validate_event(rec))
    out = [f"telemetry report: {run_dir}",
           f"  events: {len(records)} across "
           f"{len(set(r.get('_stream') for r in records))} stream(s)"]
    out.append("")
    out.append("timeline:")
    out.extend(format_timeline(records))
    elastic_lines = elastic_timeline(records)
    if elastic_lines:
        out.append("")
        out.append("elastic resize timeline:")
        out.extend(elastic_lines)
    integrity_lines = integrity_summary(records)
    if integrity_lines:
        out.append("")
        out.append("fleet integrity (fingerprint consensus + hang quorum):")
        out.extend(integrity_lines)
    serving_lines = serving_resilience_summary(records)
    if serving_lines:
        out.append("")
        out.append("serving resilience (shed / requeue / evict / drain):")
        out.extend(serving_lines)
    if serving:
        out.append("")
        out.extend(format_serving_section(records, run_dir=run_dir))
    out.append("")
    out.append("step metrics:")
    out.extend(summarize_step_metrics(records))
    if comm:
        out.append("")
        out.extend(format_comm_section(records))
    if doctor:
        out.append("")
        out.extend(format_doctor_section(doctor_verdict(
            run_dir, grad_accumulation_steps=grad_accumulation_steps)))
    out.append("")
    out.append("metrics:")
    out.extend(format_metrics(load_metrics(run_dir)))
    if problems:
        out.append("")
        out.append("schema problems:")
        out.extend(f"  {p}" for p in problems)
    return "\n".join(out) + "\n", records


# version of the ``report --json`` document (bumped on breaking change;
# round 13 turned the bare merged-event list into this structured doc —
# the list lives on under the ``events`` key)
REPORT_JSON_SCHEMA_VERSION = 1


def report_json(run_dir, strict=False, doctor=False,
                grad_accumulation_steps=1):
    """Machine-readable report document: summary / comm / elastic
    sections (+ the doctor verdict with ``doctor=True``) so CI and the
    bench harness consume verdicts without scraping text.  The merged
    event list rides under ``events``."""
    records = ev.read_events(run_dir, strict=strict)
    streams = sorted({str(r.get("_stream")) for r in records})
    steps = [r.get("step") for r in records
             if r.get("type") == ev.EVENT_STEP_METRICS
             and r.get("step") is not None]
    by_type = {}
    for rec in records:
        by_type[str(rec.get("type"))] = by_type.get(
            str(rec.get("type")), 0) + 1
    wire = {}
    stragglers = []
    for rec in records:
        data = rec.get("data", {})
        if (rec.get("type") == ev.EVENT_COMM
                and data.get("kind") == "program"
                and data.get("program") in ("train_step",
                                            "train_step_compressed")):
            wire[str(rec.get("_stream"))] = data.get("wire_bytes")
        elif (rec.get("type") == ev.EVENT_ANOMALY
                and data.get("kind") == "straggler"):
            stragglers.append({"step": rec.get("step"),
                               "rank": rec.get("rank"),
                               "detail": data.get("detail")})
    doc = {
        "report_schema_version": REPORT_JSON_SCHEMA_VERSION,
        "run_dir": str(run_dir),
        "summary": {
            "events": len(records),
            "streams": streams,
            "events_by_type": by_type,
            "step_range": ([min(steps), max(steps)] if steps else None),
        },
        "comm": {
            "step_wire_bytes": wire,
            "measured_p50_seconds": measured_latencies(records),
            "stragglers": stragglers,
        },
        "elastic": [
            {"rank": rec.get("rank"), "step": rec.get("step"),
             **rec.get("data", {})}
            for rec in align_records(records)
            if rec.get("type") == ev.EVENT_ELASTIC],
        "integrity": [
            {"rank": rec.get("rank"), "step": rec.get("step"),
             **rec.get("data", {})}
            for rec in align_records(records)
            if rec.get("type") == ev.EVENT_INTEGRITY
            and rec.get("data", {}).get("verdict") not in (None, "ok",
                                                           "pending")],
        "serving_resilience": [
            {"rank": rec.get("rank"), "step": rec.get("step"),
             **rec.get("data", {})}
            for rec in align_records(records)
            if rec.get("type") == ev.EVENT_SERVING
            and rec.get("data", {}).get("kind")
            in _SERVING_RESILIENCE_KINDS],
        "events": records,
    }
    if doctor:
        doc["doctor"] = doctor_verdict(
            run_dir, grad_accumulation_steps=grad_accumulation_steps)
    return doc


def prometheus_dump(run_dir):
    """Prometheus text for every metrics snapshot under run_dir."""
    return prometheus_text(load_metrics(run_dir))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.telemetry",
        description="DeepSpeed telemetry tools (PyTorch port)")
    sub = parser.add_subparsers(dest="command", required=True)
    rep = sub.add_parser("report",
                         help="timeline + metric summary for one run dir")
    rep.add_argument("run_dir",
                     help="telemetry run directory (holds "
                          "events-rank*.jsonl)")
    rep.add_argument("--prometheus", action="store_true",
                     help="emit a Prometheus text dump instead of the "
                          "human report")
    rep.add_argument("--json", action="store_true", dest="as_json",
                     help="emit the machine-readable report document "
                          "(summary/comm/elastic sections + the merged "
                          "event list under 'events')")
    rep.add_argument("--strict", action="store_true",
                     help="fail on undecodable event lines")
    rep.add_argument("--comm", action="store_true",
                     help="include the communication section: per-program "
                          "collective-bytes table, per-step cross-rank "
                          "skew, straggler verdicts")
    rep.add_argument("--doctor", action="store_true",
                     help="include the step-time attribution doctor "
                          "section (needs the run's programs/ sidecars: "
                          "profiling.program_dump)")
    rep.add_argument("--grad-accum", type=int, default=1,
                     help="micro-batch multiplicity for the doctor's "
                          "step-wise program sets")
    rep.add_argument("--serving", action="store_true",
                     help="include the serving observability section: "
                          "request-trace timeline, occupancy windows, "
                          "SLO attainment, shed/degrade/requeue "
                          "accounting")
    args = parser.parse_args(argv)

    if not os.path.isdir(args.run_dir):
        print(f"error: {args.run_dir} is not a directory", file=sys.stderr)
        return 2
    if args.prometheus:
        sys.stdout.write(prometheus_dump(args.run_dir))
        return 0
    if args.as_json:
        doc = report_json(args.run_dir, strict=args.strict,
                          doctor=args.doctor,
                          grad_accumulation_steps=args.grad_accum)
        json.dump(doc, sys.stdout, indent=1)
        sys.stdout.write("\n")
        return 0
    text, records = generate_report(args.run_dir, strict=args.strict,
                                    comm=args.comm, doctor=args.doctor,
                                    serving=args.serving,
                                    grad_accumulation_steps=args.grad_accum)
    sys.stdout.write(text)
    return 0 if records else 1
