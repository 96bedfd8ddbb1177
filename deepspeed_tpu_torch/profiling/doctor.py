"""Offline step-time doctor: replay a run dir into a reconciled
per-rank attribution verdict (port of
``deepspeed_tpu/profiling/doctor.py``).

``python -m deepspeed_tpu_torch.profiling.doctor <run_dir>`` composes the
artifacts a telemetry-enabled run already left behind —

- ``<run_dir>/programs/`` sidecars (``profiling.program_dump``,
  :mod:`.verify`): each recorded phase's untruncated overlap summary
  (the JAX doctor re-analyses dumped HLO; the port's summary was
  computed from the dispatch stream as the phase ran);
- ``events-rank*.jsonl``: per-rank measured step latency (median of
  the last window of ``comm``/``latency`` snapshots) and the per-rank
  driver seconds from ``attribution`` events;
- ``latency-rank*.json``: the skew-exchange files, as the measured
  fallback for runs whose event streams are gone —

into one fleet-wide verdict: a per-rank phase table (compute / exposed
collective / host stream / driver / **unexplained**), per-rank
predicted-vs-measured drift, and a straggler explanation naming the
phase the slowest rank's extra time sits in.  Exit 0 on a verdict, 2
when the run dir holds no usable artifacts.

**Serving mode** (automatic when the run dir's event stream carries
serving lifecycle traces): the serving records are joined with the
decode program's budget to decompose the TAIL request's end-to-end
latency into queue-wait / prefill / decode-compute / exposed-wire /
driver / unexplained, naming the dominant phase.

Also reachable as ``telemetry report --doctor``.  Host work on static
artifacts only: no torch, no device.
"""

import argparse
import json
import sys

from . import attribution


def _artifact_summaries(run_dir):
    """{name: overlap summary} from the run dir's program sidecars.
    Raises FileNotFoundError/ValueError (usage errors, never
    tracebacks)."""
    from .verify import load_run_programs

    return {name: side["overlap"]
            for name, side in load_run_programs(str(run_dir)).items()
            if side.get("overlap")}


def _measured_and_driver(run_dir, window):
    """(measured {stream: p50 seconds}, driver {stream: seconds},
    flops_checks {stream: dict}) from the run dir's event streams, with
    the latency-rank files as the measured fallback."""
    from ..telemetry import events as ev
    from ..telemetry.report import measured_latencies

    records = ev.read_events(str(run_dir))
    measured = measured_latencies(records, window=window)
    driver = {}
    flops_checks = {}
    for rec in records:
        if rec.get("type") != ev.EVENT_ATTRIBUTION:
            continue
        stream = str(rec.get("_stream"))
        data = rec.get("data", {})
        phases = data.get("phases") or {}
        if phases.get(attribution.PHASE_DRIVER) is not None:
            driver[stream] = float(phases[attribution.PHASE_DRIVER])
        if data.get("flops_check"):
            flops_checks[stream] = data["flops_check"]
    if not measured:
        from . import comm as comm_prof

        # relative staleness guard (fresh_fleet_snapshots): dead ranks
        # from an earlier, larger life must not enter the verdict
        fleet = attribution.fresh_fleet_snapshots(
            comm_prof.read_fleet_latencies(str(run_dir)))
        measured = {f"rank{rank}": float(snap["p50"])
                    for rank, snap in fleet.items()
                    if snap.get("p50") and float(snap["p50"]) > 0}
    return measured, driver, flops_checks


def doctor_run_dir(run_dir, grad_accumulation_steps=1,
                   window=attribution.DEFAULT_MEASURED_WINDOW):
    """The full doctor verdict for one run dir (see module docstring).

    Raises ``FileNotFoundError``/``ValueError`` when the run dir holds
    no program artifacts (the CLI maps both to exit 2)."""
    summaries = _artifact_summaries(run_dir)
    entries = {name: {"overlap": s} for name, s in summaries.items()}
    measured, driver, flops_checks = _measured_and_driver(run_dir, window)
    ranks = {}
    for stream in sorted(measured):
        budget = attribution.step_budget(
            entries, grad_accumulation_steps,
            driver_seconds=driver.get(stream, 0.0))
        if budget is None:
            continue
        rec = attribution.reconcile(budget, measured[stream])
        if stream in flops_checks:
            rec["flops_check"] = flops_checks[stream]
        ranks[stream] = rec
    # measured-less verdict: the budget alone (predicted receipts with
    # no latency evidence — still worth printing, never a silent {})
    budget = attribution.step_budget(entries, grad_accumulation_steps)
    return {
        "run_dir": str(run_dir),
        "programs": sorted(summaries),
        "budget": budget,
        "ranks": ranks,
        "straggler": attribution.straggler_explanation(ranks),
        "serving": serving_tail_decomposition(run_dir, budget),
    }


# ---------------------------------------------------------------------------
# serving mode: request-trace join + tail decomposition
# ---------------------------------------------------------------------------

# the serving tail decomposition's phase names, in render order
SERVING_TAIL_PHASES = ("queue_wait", "prefill", "decode_compute",
                       "exposed_wire", "driver", "unexplained")


def serving_traces(records):
    """trace id -> joined lifecycle view from the schema-versioned
    EVENT_SERVING phase records.  A requeued request (replica death)
    contributes ONE entry — the records share the trace id minted at
    submit — with the LAST life's admit/first_token (the life that
    actually delivered) and the requeue count."""
    from ..telemetry import events as ev

    traces = {}
    for rec in records:
        if rec.get("type") != ev.EVENT_SERVING:
            continue
        data = rec.get("data", {})
        trace = data.get("trace")
        if not trace:
            continue
        t = traces.setdefault(trace, {"trace": trace, "kinds": [],
                                      "requeues": 0})
        kind = data.get("kind")
        t["kinds"].append(kind)
        if kind == "requeue":
            t["requeues"] += 1
        elif kind in ("finish", "deadline", "shed"):
            t["terminal"] = kind
            t[kind] = data
        elif kind in ("submit", "admit", "first_token"):
            t[kind] = data    # last life wins on requeue
        if "request" in data:
            t["request"] = data["request"]
    return traces


def serving_tail_decomposition(run_dir, budget=None):
    """Decompose the tail (highest-latency finished) request's latency
    into queue-wait / prefill / decode-compute / exposed-wire / driver
    / unexplained and name the dominant phase; None when the run dir
    carries no finished serving traces.

    queue-wait and prefill are measured per request (the admit/
    first_token phase records); the decode span (finish minus first
    token, measured) is split by scaling the decode program's
    attribution budget — compute, exposed wire, driver per iteration —
    by the request's decode iteration count; whatever the budget cannot
    cover is **unexplained**."""
    from ..telemetry import events as ev

    try:
        records = ev.read_events(str(run_dir))
    except OSError:
        return None
    traces = serving_traces(records)
    finished = [t for t in traces.values()
                if t.get("terminal") == "finish"
                and t.get("finish", {}).get("latency_seconds") is not None]
    if not finished:
        return None
    tail = max(finished,
               key=lambda t: t["finish"]["latency_seconds"])
    latency = float(tail["finish"]["latency_seconds"])
    queue_wait = float((tail.get("admit") or {}).get("wait_seconds") or 0.0)
    prefill = float(
        (tail.get("first_token") or {}).get("prefill_seconds") or 0.0)
    # measured decode span: finish minus first token (same mono clock)
    decode_span = 0.0
    if tail.get("first_token") and tail["finish"].get("t_mono") is not None \
            and tail["first_token"].get("t_mono") is not None:
        decode_span = max(0.0, float(tail["finish"]["t_mono"])
                          - float(tail["first_token"]["t_mono"]))
    iters = max(0, int(tail["finish"].get("generated_tokens") or 1) - 1)
    bphases = (budget or {}).get("phases") or {}
    decode_compute = min(
        decode_span,
        float(bphases.get(attribution.PHASE_COMPUTE) or 0.0) * iters)
    exposed_wire = \
        float(bphases.get(attribution.PHASE_COLLECTIVE) or 0.0) * iters
    driver = float(bphases.get(attribution.PHASE_DRIVER) or 0.0) * iters
    phases = {
        "queue_wait": queue_wait,
        "prefill": prefill,
        "decode_compute": decode_compute,
        "exposed_wire": exposed_wire,
        "driver": driver,
    }
    phases["unexplained"] = max(
        0.0, latency - sum(phases.values()))
    dominant = max(SERVING_TAIL_PHASES, key=lambda p: phases[p])
    return {
        "trace": tail["trace"],
        "request": tail.get("request"),
        "requeues": tail["requeues"],
        "finish_reason": tail["finish"].get("reason"),
        "generated_tokens": tail["finish"].get("generated_tokens"),
        "latency_seconds": latency,
        "decode_span_seconds": decode_span,
        "phases": phases,
        "dominant_phase": dominant,
        "traces_seen": len(traces),
        "finished_traces": len(finished),
    }


def _ms(v):
    return "-" if v is None else f"{v * 1e3:9.3f}"


def format_verdict(verdict):
    """Human-readable doctor section (shared with ``telemetry report
    --doctor``)."""
    lines = []
    budget = verdict.get("budget")
    if budget is None:
        return ["  (no program with an overlap analysis — enable "
                "profiling.program_dump)"]
    lines.append(
        f"  step program: {budget['program']} — predicted "
        f"{budget['predicted_step_seconds'] * 1e3:.3f} ms/step "
        f"(critical path {budget['critical_path_seconds'] * 1e3:.3f} ms)")
    ranks = verdict.get("ranks") or {}
    if not ranks:
        lines.append("  (no measured step latency in this run dir — "
                     "predicted budget only)")
        return lines
    head = (f"  {'rank':<10} {'measured':>9} {'predicted':>9} "
            + " ".join(f"{p:>17}" for p in attribution.PHASES)
            + f" {'unexpl%':>8}")
    lines.append(head)
    for stream in sorted(ranks):
        rec = ranks[stream]
        frac = rec["step_unexplained_fraction"]
        cells = " ".join(
            f"{_ms(rec['phases'].get(p)):>15}ms" for p in attribution.PHASES)
        lines.append(
            f"  {stream:<10} {_ms(rec['measured_step_seconds'])}"
            f" {_ms(rec['predicted_step_seconds'])} {cells} "
            + ("-" if frac is None else f"{frac:7.1%}"))
    for stream in sorted(ranks):
        check = ranks[stream].get("flops_check")
        if check and check.get("disagrees"):
            factor = ("" if check.get("ratio") is None
                      else f"x{check['ratio']:.1f} ")
            lines.append(
                f"  WARNING [{stream}]: flops profiler and roofline "
                f"disagree {factor}on the compute term "
                f"(flops {check['flops_compute_seconds'] * 1e3:.3f} ms "
                f"vs roofline "
                f"{check['roofline_compute_seconds'] * 1e3:.3f} ms)")
    straggler = verdict.get("straggler")
    if straggler is not None:
        lines.append(
            f"  straggler: rank {straggler['slowest_rank']} runs "
            f"{straggler['extra_seconds'] * 1e3:.3f} ms over the fleet "
            f"median ({straggler['median_seconds'] * 1e3:.3f} ms) — "
            f"extra time attributed to "
            f"{straggler['attributed_phase']} "
            f"({straggler['attributed_seconds'] * 1e3:+.3f} ms vs fleet)")
    lines.extend(format_serving_tail(verdict.get("serving")))
    return lines


def format_serving_tail(tail):
    """Human-readable serving tail-request decomposition (shared with
    ``telemetry report --serving``); [] when the verdict has none."""
    if not tail:
        return []
    req = tail.get("request") or "?"
    lines = [
        f"  serving tail request: trace {tail['trace']} (request {req}, "
        f"{tail['requeues']} requeue(s), "
        f"reason={tail.get('finish_reason')}, "
        f"{tail.get('generated_tokens')} tokens; "
        f"{tail['finished_traces']}/{tail['traces_seen']} traces "
        f"finished)",
        "    latency "
        + f"{tail['latency_seconds'] * 1e3:.3f} ms = "
        + " + ".join(
            f"{p.replace('_', '-')} {tail['phases'][p] * 1e3:.3f}"
            for p in SERVING_TAIL_PHASES)
        + " ms",
        f"    dominant phase: {tail['dominant_phase'].replace('_', '-')}",
    ]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.profiling.doctor",
        description="Reconcile a run dir's predicted step budget "
                    "(program sidecars) against its measured per-rank "
                    "latency (telemetry events) into a per-phase "
                    "attribution verdict.")
    ap.add_argument("run_dir", help="telemetry run directory (holds "
                                    "programs/ sidecars + event streams)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batch multiplicity for step-wise "
                         "program sets (fused step programs ignore it)")
    ap.add_argument("--window", type=int,
                    default=attribution.DEFAULT_MEASURED_WINDOW,
                    help="measured latency = median of the last N "
                         "latency snapshots per rank")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the verdict as JSON")
    args = ap.parse_args(argv)
    try:
        verdict = doctor_run_dir(args.run_dir,
                                 grad_accumulation_steps=args.grad_accum,
                                 window=args.window)
    except (FileNotFoundError, OSError, ValueError) as e:
        print(f"doctor: cannot load run artifacts: {e}", file=sys.stderr)
        return 2
    if args.as_json:
        json.dump(verdict, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
        return 0
    print(f"step-time attribution: {verdict['run_dir']}")
    print("\n".join(format_verdict(verdict)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
