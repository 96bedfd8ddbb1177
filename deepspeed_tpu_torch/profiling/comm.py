"""Communication observability: the per-phase collective ledger and the
per-rank step-latency exchange (port of
``deepspeed_tpu/profiling/comm.py``).

- :class:`CommLedger` — the JAX ledger walks each compiled program's
  optimized HLO for its collectives; the port has no HLO, so it takes
  its records from the collective call sites themselves:
  :class:`~deepspeed_tpu_torch.comm.CommCounter` sees every collective
  the port issues (its verb, payload bytes and group size), and the
  ledger listens to it while an engine phase runs for the first time
  (the training engine's ``fwd_bwd`` micro-batch and its
  ``apply_update`` step).  Each phase becomes one entry with the JAX
  entry fields — ``collectives``, ``payload_bytes``, ``wire_bytes``,
  ``ops[op].{count, payload_bytes, wire_bytes, max_group}`` under the
  HLO op names (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``), ``host_transfers`` and
  ``host_transfer_bytes`` (the offload stream's copies) — emitted as a
  ``comm``/``program`` event and ``comm/program/<name>/*`` gauges.
  While a phase records, a dispatch pricer
  (:class:`~.overlap.DispatchPricer`) also prices what it dispatches,
  and the entry carries the JAX ``overlap`` summary
  (:func:`~.overlap.analyze_dispatch`: roofline compute, the classified
  wire nodes, ``exposed_wire_seconds``, ``overlap_fraction``), its
  ``p2p_transfers`` and ``p2p_transfer_bytes``, and the
  ``exposed_wire_seconds`` and ``overlap_fraction`` gauges;
  :meth:`CommLedger.step_overlap` sums a step's.  With a
  :class:`~.verify.ProgramDumper` attached each recorded phase also
  lands in ``<run_dir>/programs/`` with its untruncated summary.
- **Wire-bytes model** (:func:`predicted_wire_bytes`): per participant,
  ring-algorithm accounting over a group of size *g* — all-gather moves
  ``(g-1)/g`` of its gathered output, reduce-scatter ``(g-1)/g`` of its
  full input, all-reduce twice the all-gather, a permute exactly its
  payload, all-to-all ``(g-1)/g`` of its payload.
- **Per-rank skew exchange** (:func:`publish_rank_latency` /
  :func:`read_fleet_latencies` / :func:`fleet_skew`): each rank
  publishes its step-latency ring's snapshot to
  ``<run_dir>/latency-rank<k>.json`` at the print cadence and reads the
  fleet's back; :func:`fleet_skew` turns the per-rank p50s into a
  slowest-vs-median ratio, which the engine holds to
  ``resilience.straggler_factor``.  The files are the JAX package's, so
  either package reads the other's.
"""

import json
import os
import threading
import time

import torch

from ..resilience.integrity import atomic_publish_json, read_fleet_json_files
from ..utils.logging import logger

# the collective op names (the JAX ledger's HLO mnemonics)
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "collective-permute", "all-to-all")
# the port's counter verbs (comm.counter) -> the op each one is
VERB_OPS = {"psum": "all-reduce", "pmean": "all-reduce",
            "pmax": "all-reduce", "pmin": "all-reduce",
            "all_reduce": "all-reduce", "all_gather": "all-gather",
            "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
            "send": "collective-permute"}

# comm-event kinds (the ``kind`` data key of EVENT_COMM)
KIND_PROGRAM = "program"
KIND_LATENCY = "latency"
KIND_SKEW = "skew"

LATENCY_FILE_PREFIX = "latency-rank"
LATENCY_FILE_SUFFIX = ".json"


def predicted_wire_bytes(op, out_bytes, group):
    """Ring-algorithm wire bytes per participant for one collective.

    ``out_bytes`` is the op's RESULT size; reduce-scatter's logical
    payload is its full input (``out_bytes * group``).  Integer math —
    exact when the payload divides by the group, floor otherwise."""
    g = max(int(group), 1)
    if g == 1:
        return 0
    if op == "all-reduce":
        return 2 * out_bytes * (g - 1) // g
    if op == "all-gather":
        return out_bytes * (g - 1) // g
    if op == "reduce-scatter":
        return out_bytes * (g - 1)
    if op == "collective-permute":
        return out_bytes
    if op == "all-to-all":
        return out_bytes * (g - 1) // g
    return 0


def collective_record(verb, nbytes, group):
    """``{op, out_bytes, group, wire_bytes}`` of one call the counter
    saw, or None for a verb that is no collective (a ``recv``: its
    permute counts at the send).  ``nbytes`` is the counter's buffer
    size: the full input of a reduce-scatter (its result is 1/group of
    it), the result of every other verb."""
    op = VERB_OPS.get(verb)
    if op is None:
        return None
    g = max(int(group), 1)
    out_bytes = int(nbytes) // g if op == "reduce-scatter" else int(nbytes)
    return {"op": op, "out_bytes": out_bytes, "group": g,
            "wire_bytes": predicted_wire_bytes(op, out_bytes, g)}


def collective_summary(ops):
    """Aggregate collective records into one ledger entry::

        {"collectives": N, "payload_bytes": ..., "wire_bytes": ...,
         "ops": {op: {"count", "payload_bytes", "wire_bytes",
                      "max_group"}}}

    ``payload_bytes`` is the logical payload (full input for
    reduce-scatter, the stated result for everything else)."""
    entry = {"collectives": 0, "payload_bytes": 0, "wire_bytes": 0,
             "ops": {}}
    for rec in ops:
        payload = rec["out_bytes"]
        if rec["op"] == "reduce-scatter":
            payload = rec["out_bytes"] * rec["group"]
        bucket = entry["ops"].setdefault(
            rec["op"], {"count": 0, "payload_bytes": 0, "wire_bytes": 0,
                        "max_group": 0})
        bucket["count"] += 1
        bucket["payload_bytes"] += payload
        bucket["wire_bytes"] += rec["wire_bytes"]
        bucket["max_group"] = max(bucket["max_group"], rec["group"])
        entry["collectives"] += 1
        entry["payload_bytes"] += payload
        entry["wire_bytes"] += rec["wire_bytes"]
    return entry


# the serving engine's decode step: the "step" of a serve the way
# train_step is the step of a training run
SERVE_DECODE_PROGRAM = "serve_decode"


def step_program_weights(available, grad_accumulation_steps=1,
                         prefer=None):
    """``(program_label, [(name, multiplicity), ...])`` pricing ONE
    optimizer step over the recorded program set ``available``: a fused
    program (``train_step``, ``train_step_compressed`` or
    ``serve_decode``; ``prefer`` first) is the step where present, else
    the step-wise programs weighted by the micro-batch multiplicity
    (``fwd_bwd``·acc + ``accum``·(acc-1) + ``apply_update`` +
    ``cast_params``).  ``(None, [])`` when nothing is priced yet."""
    fused_order = ("train_step", "train_step_compressed",
                   SERVE_DECODE_PROGRAM)
    if prefer is not None:
        fused_order = (prefer,) + tuple(f for f in fused_order
                                        if f != prefer)
    for fused in fused_order:
        if fused in available:
            return fused, [(fused, 1)]
    acc = max(int(grad_accumulation_steps), 1)
    weights = [(name, mult) for name, mult in
               (("fwd_bwd", acc), ("accum", acc - 1),
                ("apply_update", 1), ("cast_params", 1))
               if mult > 0 and name in available]
    return ("stepwise", weights) if weights else (None, [])


# ---------------------------------------------------------------------------
# CommLedger: per-phase collective accounting
# ---------------------------------------------------------------------------

class CommLedger:
    """Per-engine ledger of the collectives each phase issues and of the
    phase's overlap summary.

    :meth:`begin` / :meth:`end` bracket the FIRST run of a phase: in
    between, every collective the port's ``comm`` module issues in this
    process is recorded (a listener on its counter), and a
    :class:`~.overlap.DispatchPricer` prices the phase's ops and places
    its collectives among them; :meth:`end` turns them into the phase's
    entry and emits it.  A phase already recorded costs nothing.
    ``device`` is the engine's (the pricer prices its ops only)."""

    def __init__(self, enabled=True, telemetry=None, mesh_axes=None,
                 device=None):
        self.enabled = bool(enabled)
        self.telemetry = telemetry
        # {axis: size} recorded into every program event
        self.mesh_axes = dict(mesh_axes or {})
        self.device = torch.device(device) if device is not None else None
        # optional callable -> {"host_state_wire_bytes",
        # "host_stream_schedule", "collective_schedule", "device_kind"}:
        # the engine's program_verify_context, read when a phase ends
        self.overlap_context_fn = None
        # optional ProgramDumper: each recorded phase also lands on disk
        self.dumper = None
        self._lock = threading.Lock()
        self._entries = {}
        self._open = None

    def recording(self, name):
        """Whether ``begin(name)`` would record (an enabled ledger, a
        phase not yet recorded, none open)."""
        return (self.enabled and self._open is None
                and str(name) not in self._entries)

    def begin(self, name):
        if not self.recording(name):
            return False
        from .. import comm
        from .overlap import DispatchPricer

        records = []

        def listen(verb, nbytes, group):
            rec = collective_record(verb, nbytes, group)
            if rec is not None:
                records.append(rec)

        pricer = DispatchPricer(self.device.type if self.device is not None
                                else "cpu")
        self._open = (str(name), records, listen, pricer)
        comm.counter.listeners.append(listen)
        pricer.start()
        return True

    def end(self, name, host_transfers=0, host_transfer_bytes=0):
        """Close the phase ``name`` opened by :meth:`begin` and record it."""
        if self._open is None or self._open[0] != str(name):
            return None
        from .. import comm

        _, records, listen, pricer = self._open
        self._open = None
        pricer.stop()
        comm.counter.listeners.remove(listen)
        return self.record(name, records, host_transfers,
                           host_transfer_bytes, dispatch=pricer.records())

    def _context(self):
        if self.overlap_context_fn is None:
            return {}
        try:
            return self.overlap_context_fn() or {}
        except Exception as e:   # observability never takes a step down
            logger.debug("comm ledger: overlap context unavailable: %s", e)
            return {}

    def _overlap_summary(self, name, dispatch, ctx):
        """The untruncated overlap summary of one recorded phase (JAX
        ``comm.py:289``), with the engine's declared schedules gated to
        the programs they belong to; None on any failure."""
        from . import overlap as overlap_prof

        try:
            is_update = str(name) in overlap_prof.UPDATE_PROGRAMS
            is_exchange = str(name) in overlap_prof.EXCHANGE_PROGRAMS
            n_devices = 1
            for size in self.mesh_axes.values():
                n_devices *= size
            return overlap_prof.analyze_dispatch(
                dispatch, total_devices=n_devices,
                device_kind=ctx.get("device_kind") or "",
                declared_host_wire_bytes=(
                    int(ctx.get("host_state_wire_bytes") or 0)
                    if is_update else 0),
                declared_host_stream=(ctx.get("host_stream_schedule")
                                      if is_update else None),
                declared_collective_schedule=(
                    ctx.get("collective_schedule") if is_exchange
                    else None),
                max_nodes=None)
        except Exception as e:   # pragma: no cover - fail-soft by design
            logger.debug("comm ledger: overlap analysis failed for %r: "
                         "%s", name, e)
            return None

    def record(self, name, ops, host_transfers=0, host_transfer_bytes=0,
               dispatch=None):
        """Record one phase's collective records (``collective_record``
        dicts), its host transfers and, given the pricer's ``dispatch``
        records, its overlap summary."""
        entry = collective_summary(ops)
        entry["host_transfers"] = int(host_transfers)
        entry["host_transfer_bytes"] = int(host_transfer_bytes)
        full = None
        ctx = {}
        if dispatch is not None:
            ctx = self._context()
            full = self._overlap_summary(name, dispatch, ctx)
        if full is not None:
            for field in ("p2p_transfers", "p2p_transfer_bytes"):
                entry[field] = full["hlo_transfer_summary"][field]
            # events and gauges carry the first 32 nodes (the JAX cap);
            # the totals and buckets cover every node
            entry["overlap"] = dict(
                full, nodes=full["nodes"][:32],
                nodes_truncated=max(len(full["nodes"]) - 32, 0))
        with self._lock:
            self._entries[str(name)] = json.loads(json.dumps(entry))
            n_programs = len(self._entries)
        tel = self.telemetry
        if tel is not None and getattr(tel, "enabled", False):
            from ..telemetry import events as TEL

            tel.emit(TEL.EVENT_COMM, kind=KIND_PROGRAM, program=str(name),
                     mesh=self.mesh_axes, **entry)
            for field in ("collectives", "payload_bytes", "wire_bytes",
                          "host_transfer_bytes"):
                tel.gauge(f"comm/program/{name}/{field}").set(
                    float(entry[field]))
            if full is not None:
                tel.gauge(f"comm/program/{name}/exposed_wire_seconds").set(
                    float(full["exposed_wire_seconds"]))
                tel.gauge(f"comm/program/{name}/overlap_fraction").set(
                    float(full["overlap_fraction"]))
            tel.gauge("comm/programs").set(float(n_programs))
        if self.dumper is not None and full is not None:
            self.dumper.dump(name, entry, full, ctx)
        return entry

    def entry(self, name):
        with self._lock:
            e = self._entries.get(str(name))
        return json.loads(json.dumps(e)) if e else None

    def entries(self):
        with self._lock:
            names = list(self._entries)
        return {n: self.entry(n) for n in names}

    def _names(self, with_overlap=False):
        """Recorded program names (``with_overlap``: those carrying an
        overlap summary), for :func:`step_program_weights`."""
        with self._lock:
            return {n for n, e in self._entries.items()
                    if e is not None
                    and (not with_overlap or e.get("overlap"))}

    def overlap_entries(self):
        """``{name: {"overlap": summary}}`` without the per-node lists:
        what the attribution step budget reads, at the print cadence."""
        out = {}
        with self._lock:
            for name, e in self._entries.items():
                if e is not None and e.get("overlap"):
                    slim = {k: v for k, v in e["overlap"].items()
                            if k not in ("nodes", "op_bytes")}
                    out[name] = {"overlap": json.loads(json.dumps(slim))}
        return out

    def wire_bytes(self, name):
        e = self.entry(name)
        return e["wire_bytes"] if e else None

    def step_entry(self, grad_accumulation_steps=1, prefer=None):
        """Aggregate ``{program, collectives, payload_bytes,
        wire_bytes}`` for ONE optimizer step (the step-wise phases
        weighted by their multiplicity, :func:`step_program_weights`).
        None when nothing has been recorded yet."""
        program, weights = step_program_weights(
            self._names(), grad_accumulation_steps, prefer=prefer)
        if program is None:
            return None
        totals = {"program": program, "collectives": 0,
                  "payload_bytes": 0, "wire_bytes": 0}
        for name, mult in weights:
            e = self.entry(name)
            for field in ("collectives", "payload_bytes", "wire_bytes"):
                totals[field] += e[field] * mult
        return totals

    def step_wire_bytes(self, grad_accumulation_steps=1, prefer=None):
        e = self.step_entry(grad_accumulation_steps, prefer=prefer)
        return e["wire_bytes"] if e else None

    def step_overlap(self, grad_accumulation_steps=1, prefer=None):
        """``{program, wire_seconds, exposed_wire_seconds,
        overlap_fraction}`` for ONE optimizer step from the recorded
        phases' overlap summaries (the resolution of
        :meth:`step_entry`).  None until a phase with a summary has
        been recorded."""
        program, weights = step_program_weights(
            self._names(with_overlap=True), grad_accumulation_steps,
            prefer=prefer)
        if program is None:
            return None
        entries = self.overlap_entries()
        wire = exposed = 0.0
        for name, mult in weights:
            ov = entries[name]["overlap"]
            wire += ov["wire_seconds"] * mult
            exposed += ov["exposed_wire_seconds"] * mult
        return {"program": program, "wire_seconds": wire,
                "exposed_wire_seconds": exposed,
                "overlap_fraction": (1.0 - exposed / wire) if wire > 0
                else 1.0}


# ---------------------------------------------------------------------------
# Per-rank latency exchange (file-based; print-cadence only)
# ---------------------------------------------------------------------------

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
