"""Step-time attribution: reconcile the predicted per-step budget with
the measured per-step latency, per rank (port of
``deepspeed_tpu/profiling/attribution.py``; a copy: stdlib only, every
function with its signature).

The engines compose one predicted budget for a step from the comm
ledger's overlap summaries (:mod:`.overlap`) —

- **compute**: the roofline compute seconds of each recorded program,
  weighted by the fused-else-stepwise step multiplicity every comm
  receipt uses (:func:`~.comm.step_program_weights`);
- **exposed_collective**: the collective and point-to-point wire
  seconds the step pays as latency;
- **host_stream**: the exposed host wire (the engine-declared offload
  stream);
- **driver**: host seconds per step, charged once —

and reconcile the sum against the measured per-step latency (the
step-latency ring's p50): the residual is the **unexplained** phase,
``measured == sum(phases)`` by construction, and
``step_unexplained_fraction`` is its share of the measured step (a
model that over-predicts gives a negative one, reported, never clamped).

The port's engines pass as ``driver_seconds`` what the host bracket
(batch fetch to the step's last launch, the blocking fetch excluded)
took beyond the predicted device time, ``max(0, bracket - (compute +
exposed wire))``: eager PyTorch launches every kernel from the host, so
on a device-paced step the enqueue runs under the device's work, where
the JAX package's one program a step makes the enqueue short
(:meth:`~deepspeed_tpu_torch.runtime.engine.DeepSpeedEngine.attribution_receipt`).
"""

from . import comm as comm_prof
from .overlap import KIND_COLLECTIVE, KIND_HOST, KIND_P2P

ATTRIBUTION_SCHEMA_VERSION = 1

# phase names, in presentation order (the doctor table's columns)
PHASE_COMPUTE = "compute"
PHASE_COLLECTIVE = "exposed_collective"
PHASE_HOST = "host_stream"
PHASE_DRIVER = "driver"
PHASE_UNEXPLAINED = "unexplained"
PHASES = (PHASE_COMPUTE, PHASE_COLLECTIVE, PHASE_HOST, PHASE_DRIVER,
          PHASE_UNEXPLAINED)

# measured latency = median over the last this-many latency snapshots
# of a stream (one stale first-life snapshot from a resized/respawned
# rank must not misstate a verdict — the same window the report CLI's
# predicted-vs-measured closing summary uses)
DEFAULT_MEASURED_WINDOW = 5

# flops cross-check: the flops profiler's model flops and the roofline
# disagree "loudly" past this factor (the roofline is bytes-aware, so
# some excess over pure flop time is expected on memory-bound models)
FLOPS_DISAGREEMENT_FACTOR = 2.0


def _median(values):
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    mid = len(vals) // 2
    return (vals[mid] if len(vals) % 2
            else 0.5 * (vals[mid - 1] + vals[mid]))


def median_of_window(values, window=DEFAULT_MEASURED_WINDOW):
    """Median of the LAST ``window`` positive values (None when none):
    the robust "current latency" estimator shared by the report
    summary and the doctor."""
    tail = [float(v) for v in values if v and float(v) > 0.0]
    return _median(tail[-max(int(window), 1):])


# offline staleness guard for latency-rank files: keep only snapshots
# published within this window of the NEWEST one (a resized fleet
# leaves dead ranks' last publishes behind; wall-clock age guards are
# useless for post-run analysis, so freshness is relative)
FLEET_FRESHNESS_SECS = 600.0


def fresh_fleet_snapshots(fleet, window_secs=FLEET_FRESHNESS_SECS):
    """Subset of a ``read_fleet_latencies`` result published within
    ``window_secs`` of the newest snapshot (ts-less snapshots pass —
    older writers).  A run dir accumulates files across lives and
    an elastic fleet shrinks: a rank that died half the run ago must
    not skew the measured evidence the doctor reconciles against."""
    stamps = [float(snap["ts"]) for snap in fleet.values()
              if isinstance(snap, dict) and snap.get("ts") is not None]
    if not stamps:
        return dict(fleet)
    newest = max(stamps)
    return {rank: snap for rank, snap in fleet.items()
            if snap.get("ts") is None
            or newest - float(snap["ts"]) <= window_secs}


def _exposed_by_kind(summary):
    """Per-kind exposed wire seconds of one overlap summary.  Recorded
    summaries carry ``exposed_by_kind``; older sidecars degrade to the
    per-node list (which may be telemetry-truncated — the program
    dump's untruncated summary avoids that)."""
    by_kind = summary.get("exposed_by_kind")
    if by_kind is not None:
        return dict(by_kind)
    out = {}
    for n in summary.get("nodes") or []:
        out[n["kind"]] = (out.get(n["kind"], 0.0)
                          + n["seconds"] - n["hidden_seconds"])
    return out


def program_budget(summary):
    """Device-side phase budget of ONE program from its overlap
    analysis; None when there is no summary to price."""
    if not summary:
        return None
    by_kind = _exposed_by_kind(summary)
    compute = float(summary.get("compute_seconds") or 0.0)
    collective = (float(by_kind.get(KIND_COLLECTIVE, 0.0))
                  + float(by_kind.get(KIND_P2P, 0.0)))
    host = float(by_kind.get(KIND_HOST, 0.0))
    return {
        PHASE_COMPUTE: compute,
        PHASE_COLLECTIVE: collective,
        PHASE_HOST: host,
        "critical_path_seconds":
            float(summary.get("critical_path_seconds") or 0.0),
        "predicted_seconds": compute + collective + host,
    }


def step_budget(entries, grad_accumulation_steps=1, prefer=None,
                driver_seconds=0.0):
    """Predicted budget of ONE optimizer step from a comm-ledger entry
    map (``{name: entry}`` with ``entry["overlap"]`` summaries — the
    live ledger's :meth:`~.comm.CommLedger.entries` or a sidecar
    replay).  Fused-else-stepwise multiplicity via
    :func:`~.comm.step_program_weights`; ``driver_seconds`` is charged
    once per step.  None until a program with an overlap summary is
    available."""
    summaries = {name: e["overlap"] for name, e in (entries or {}).items()
                 if e and e.get("overlap")}
    program, weights = comm_prof.step_program_weights(
        summaries, grad_accumulation_steps, prefer=prefer)
    if program is None:
        return None
    phases = {PHASE_COMPUTE: 0.0, PHASE_COLLECTIVE: 0.0, PHASE_HOST: 0.0}
    critical_path = 0.0
    for name, mult in weights:
        b = program_budget(summaries[name])
        for phase in (PHASE_COMPUTE, PHASE_COLLECTIVE, PHASE_HOST):
            phases[phase] += b[phase] * mult
        critical_path += b["critical_path_seconds"] * mult
    phases[PHASE_DRIVER] = max(float(driver_seconds or 0.0), 0.0)
    return {
        "program": program,
        "phases": phases,
        "critical_path_seconds": critical_path,
        "predicted_step_seconds": sum(phases.values()),
    }


def reconcile(budget, measured_seconds):
    """One reconciled attribution record from a step budget and a
    measured per-step latency.

    ``phases`` (compute / exposed_collective / host_stream / driver /
    unexplained) sum EXACTLY to ``measured_step_seconds`` — the
    unexplained phase is the signed residual, and
    ``step_unexplained_fraction`` is its share of the measured step
    (negative = the model over-predicts).  With ``measured_seconds``
    None (no completed steps yet) the record carries the predicted
    budget with the measured-side fields None."""
    phases = dict(budget["phases"])
    predicted = float(budget["predicted_step_seconds"])
    out = {
        "attribution_schema_version": ATTRIBUTION_SCHEMA_VERSION,
        "program": budget["program"],
        "phases": phases,
        "critical_path_seconds": budget["critical_path_seconds"],
        "predicted_step_seconds": predicted,
        "measured_step_seconds": None,
        "step_unexplained_fraction": None,
    }
    if measured_seconds is None or measured_seconds <= 0:
        phases[PHASE_UNEXPLAINED] = None
        return out
    measured = float(measured_seconds)
    unexplained = measured - predicted
    phases[PHASE_UNEXPLAINED] = unexplained
    out["measured_step_seconds"] = measured
    out["step_unexplained_fraction"] = unexplained / measured
    return out


def flops_cross_check(budget, model_flops, peak_flops_per_sec):
    """Independent check on the roofline compute term: the flops
    profiler's counted model flops at the card's peak vs the roofline's
    compute seconds.  Both figures are reported;
    ``disagrees`` flags a >2x split either way (the roofline is
    bytes-aware, so moderate excess is expected — a 2x split means one
    of the two models is not describing this program)."""
    flops_seconds = (float(model_flops) / float(peak_flops_per_sec)
                     if peak_flops_per_sec else 0.0)
    roofline = float(budget["phases"][PHASE_COMPUTE])
    lo, hi = sorted((flops_seconds, roofline))
    # ratio is None (never inf — the receipt lands in strict-JSON
    # documents) when one model claims zero compute and the other does
    # not: maximal disagreement, no finite factor to quote
    if lo > 0:
        ratio = hi / lo
        disagrees = ratio > FLOPS_DISAGREEMENT_FACTOR
    else:
        ratio = 1.0 if hi == 0 else None
        disagrees = hi > 0
    return {
        "model_flops": int(model_flops),
        "flops_compute_seconds": flops_seconds,
        "roofline_compute_seconds": roofline,
        "ratio": ratio,
        "disagrees": disagrees,
    }


def straggler_explanation(rank_records):
    """Which phase the slowest rank's extra time (vs the fleet median
    measured step) lands in.

    ``rank_records`` is ``{rank: reconciled record}`` (records without
    a measured step are ignored).  The predicted device phases are the
    same program for every rank, so a straggler's extra seconds can
    only sit in the per-rank phases — ``driver`` (slow input pipeline /
    host) or ``unexplained`` (device-side: contention, thermal,
    neighbor); naming which is the diagnosis.  None with fewer than two
    measured ranks (no fleet to straggle behind)."""
    rows = [(str(rank), rec) for rank, rec in rank_records.items()
            if rec.get("measured_step_seconds")]
    rows.sort()
    if len(rows) < 2:
        return None
    median = _median([rec["measured_step_seconds"] for _, rec in rows])
    slowest_rank, slowest = max(rows,
                                key=lambda rr:
                                rr[1]["measured_step_seconds"])
    extra = slowest["measured_step_seconds"] - median
    # per-rank phases vs the fleet's median value of the same phase
    deltas = {}
    for phase in (PHASE_DRIVER, PHASE_UNEXPLAINED):
        fleet = _median([rec["phases"].get(phase) or 0.0
                         for _, rec in rows]) or 0.0
        deltas[phase] = (slowest["phases"].get(phase) or 0.0) - fleet
    attributed = max(deltas, key=lambda p: deltas[p])
    return {
        "slowest_rank": slowest_rank,
        "slowest_seconds": slowest["measured_step_seconds"],
        "median_seconds": median,
        "extra_seconds": extra,
        "attributed_phase": attributed,
        "attributed_seconds": deltas[attributed],
        "phase_deltas": deltas,
    }
