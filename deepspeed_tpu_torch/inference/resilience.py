"""Serving-replica health plane: weight-fingerprint consensus, a
freshness-based hang quorum, and bounded SIGTERM drain (port of
``deepspeed_tpu/inference/resilience.py``) — the training fleet's
integrity machinery pointed at inference replicas.

A serving fleet is N independent single-card engines loaded with the
SAME weights, exchanging state through the shared run dir exactly like
training ranks do (``resilience/integrity.py``):

- **heartbeats** — every decode iteration calls
  :meth:`ServingHealth.beat` into the existing
  :class:`~deepspeed_tpu_torch.resilience.integrity.FleetHeartbeat`
  (throttled atomic ``heartbeat-rank<k>.json`` publish, O(1) host
  work).  The verdict function is swapped for
  :func:`serving_hang_quorum`: replicas decode *independent* request
  streams, so their iteration counters are incomparable and the
  training quorum's "majority at the head step" precondition would
  never hold — serving liveness is judged purely on beat freshness.
- **weight fingerprints** — serving weights are static, so the bit-sum
  checksum (:func:`~deepspeed_tpu_torch.resilience.fingerprint.fingerprint`
  over the weight tree's leaves in the JAX tree's order, equal to the
  JAX ``ServingHealth.fingerprint_device`` bit for bit) has exactly ONE
  correct value per fleet life.  Every replica publishes its
  fingerprint under the fixed step key :data:`SERVING_FINGERPRINT_STEP`
  on the ``steps_per_print`` cadence;
  :func:`~deepspeed_tpu_torch.resilience.integrity.fingerprint_consensus`
  votes on that single step, so a bitflipped replica is named by
  majority no matter how far apart the replicas' decode counters
  drift.  The fingerprint is RE-computed each cadence (a mid-serve
  flip must not hide behind a cached load-time value) and its scalar
  rides the decode loop's existing next-token fetch — **zero added
  host syncs**.
- **escalation** — a conviction mirrors training: the verdict file is
  committed first-writer-wins, telemetry flushes, and the replica
  raises :class:`~deepspeed_tpu_torch.resilience.constants.FleetIntegrityError`
  (exit code 87), so the elastic supervisor blocklists the slot and
  resizes the fleet.

``publish_weight_fingerprint`` / ``read_fleet_weight_fingerprints`` /
``note_weight_fingerprint`` run at the print cadence only.
"""

import logging
import os
import signal
import threading
import time

from ..resilience import integrity as integ
from ..resilience.constants import (EXIT_INTEGRITY_EVICT,
                                    FleetIntegrityError,
                                    TrainingDivergedError)
from ..resilience.fingerprint import fingerprint
from ..telemetry import events as TEL
from ..utils.params import tree_leaves

logger = logging.getLogger(__name__)

# the single step key every replica's weight fingerprint publishes
# under: weights are static for the life of the fleet, so there is
# exactly one fingerprint per life — a fixed key lets the training
# consensus vote across replicas whose decode counters never align
SERVING_FINGERPRINT_STEP = 0


# ---------------------------------------------------------------------------
# fingerprint exchange (serving wrappers, print-cadence only)
# ---------------------------------------------------------------------------

def publish_weight_fingerprint(run_dir, rank, value):
    """Atomically publish this replica's weight fingerprint under the
    fixed serving step key.  Print-cadence only by contract.
    Re-publishing refreshes the file timestamp, so staleness
    filters see a live replica.  Returns the path, or None on
    failure."""
    history = {SERVING_FINGERPRINT_STEP: integ.canonical_fingerprint(value)}
    return integ.publish_rank_fingerprint(run_dir, rank, history,
                                          step=SERVING_FINGERPRINT_STEP)


def read_fleet_weight_fingerprints(run_dir, fleet_size,
                                   max_age_secs=None):
    """The fleet's published weight-fingerprint histories (``{rank:
    {step: fp}}``).  Print-cadence only by contract."""
    return integ.read_fleet_fingerprints(run_dir, world_size=fleet_size,
                                         max_age_secs=max_age_secs)


# ---------------------------------------------------------------------------
# hang quorum over incomparable decode counters
# ---------------------------------------------------------------------------

def serving_hang_quorum(fleet, self_rank, fleet_size, peer_timeout_secs,
                        now=None):
    """Freshness-majority hang verdict for a serving fleet, or None.

    Same signature and verdict shape as
    :func:`~deepspeed_tpu_torch.resilience.integrity.hang_quorum`, but
    liveness is judged purely on heartbeat freshness: replicas decode
    independent request streams, so a slower replica's lower iteration
    counter says nothing about health — only a beat that stopped
    refreshing does.  A rank is the suspect when its beat is stale by
    more than ``peer_timeout_secs`` while a strict majority of the
    fleet (this rank included) is fresh; a healthy-but-slow replica
    keeps publishing fresh beats and is never named.  This rank
    abstains when its own beat is stale (it might be the wedged one)
    and never names itself.  Wall-clock caveat as in the training
    quorum: multi-host fleets need clocks synchronized to well within
    the timeout."""
    if now is None:
        now = time.time()
    if len(fleet) < 2 or self_rank not in fleet:
        return None
    timeout = float(peer_timeout_secs)
    fresh = [r for r, info in fleet.items()
             if now - info["ts"] <= timeout]
    if self_rank not in fresh:
        return None
    if len(fresh) * 2 <= int(fleet_size):
        return None
    suspects = [(now - info["ts"], r) for r, info in fleet.items()
                if r != self_rank and now - info["ts"] > timeout]
    if not suspects:
        return None
    stalled, suspect = max(suspects)
    head = max(info["step"] for info in fleet.values())
    return {"suspect": suspect, "stalled_secs": stalled,
            "suspect_step": fleet[suspect]["step"], "head_step": head,
            "leaders": len(fresh), "fleet": len(fleet)}


# ---------------------------------------------------------------------------
# the per-replica health plane
# ---------------------------------------------------------------------------

class ServingHealth:
    """One serving replica's half of the fleet health exchange.

    Attach to an :class:`~deepspeed_tpu_torch.inference.engine.
    InferenceEngine` via ``engine.attach_health(health)``: the engine
    then beats the heartbeat every decode iteration and, on its existing
    ``steps_per_print`` cadence, folds the re-computed weight
    fingerprint into the next-token fetch and hands the host scalar to
    :meth:`note_weight_fingerprint` — publish, read, vote, escalate,
    all off the per-token path."""

    def __init__(self, engine, run_dir, rank, fleet_size,
                 peer_timeout_secs=30.0, poll_interval=None,
                 action="evict", max_age_secs=600.0, exit_fn=None):
        self.engine = engine
        self.run_dir = str(run_dir)
        self.rank = int(rank)
        self.fleet_size = max(1, int(fleet_size))
        self.action = action
        self.max_age_secs = max_age_secs
        self.violations = 0
        self.last_verdict = None
        self._fingerprint_off = False
        self.heartbeat = integ.FleetHeartbeat(
            run_dir, rank, fleet_size, peer_timeout_secs,
            poll_interval=poll_interval, exit_fn=exit_fn,
            on_fire=self._on_hang_fire, action=action,
            quorum_fn=serving_hang_quorum)

    # -- lifecycle -----------------------------------------------------
    def start(self):
        self.heartbeat.start()
        return self

    def stop(self):
        self.heartbeat.stop()

    def beat(self, iteration):
        """Per-decode-iteration liveness tick (throttled O(1) publish —
        not a print-cadence call, like the training beat)."""
        self.heartbeat.beat(int(iteration))

    def _on_hang_fire(self, verdict):
        """Monitor-thread hook right before the respawnable eviction
        exit: narrate the verdict and flush telemetry (the exit skips
        atexit)."""
        tel = getattr(self.engine, "telemetry", None)
        if tel is None or not tel.enabled:
            return
        tel.emit(TEL.EVENT_INTEGRITY, verdict="hang",
                 kind=integ.KIND_HANG, suspects=[verdict["suspect"]],
                 stalled_secs=verdict["stalled_secs"],
                 fresh=verdict["leaders"], fleet=verdict["fleet"])
        tel.emit(TEL.EVENT_SERVING, kind="evict",
                 suspect=verdict["suspect"], fault=integ.KIND_HANG)
        tel.flush(reason="serving_hang_evict")

    # -- weight fingerprint --------------------------------------------
    def fingerprint_device(self):
        """Dispatch the weight checksum; returns the 0-d int64 device
        scalar (or None once it has failed on this replica).  NOT
        fetched here — the engine folds it into the decode loop's
        existing next-token fetch so the health plane adds zero host
        syncs."""
        if self._fingerprint_off:
            return None
        try:
            return fingerprint(tree_leaves(self.engine.params)[1])
        except Exception as e:  # noqa: BLE001 — observability only
            logger.error(
                "serving weight-fingerprint failed (%s); disabling the "
                "fingerprint exchange on this replica", e)
            self._fingerprint_off = True
            return None

    def note_weight_fingerprint(self, value):
        """Publish this replica's weight fingerprint, read the fleet,
        vote, and escalate.  Print-cadence only by contract — host
        arithmetic + run-dir file I/O on an
        already-fetched scalar, zero added syncs.

        An ``outlier`` verdict convicts by fleet majority: the verdict
        file is committed (first writer wins), telemetry flushes, and
        :class:`FleetIntegrityError` carries the respawnable exit code
        87 so the launcher's elastic supervisor evicts the suspect's
        slot and resizes.  EVERY replica that sees the verdict raises
        (the training semantic): the fleet must not straddle a
        teardown, and the launcher replaces it wholesale."""
        if value is None:
            return None
        publish_weight_fingerprint(self.run_dir, self.rank, value)
        fleet = read_fleet_weight_fingerprints(
            self.run_dir, self.fleet_size, max_age_secs=self.max_age_secs)
        verdict = integ.fingerprint_consensus(fleet, self.fleet_size)
        self.last_verdict = verdict
        tel = getattr(self.engine, "telemetry", None)
        tel_on = tel is not None and tel.enabled
        if tel_on:
            tel.emit(TEL.EVENT_INTEGRITY,
                     verdict=verdict["verdict"],
                     kind="weight_fingerprint",
                     suspects=verdict["suspects"],
                     fingerprint=integ.canonical_fingerprint(value),
                     majority_fingerprint=verdict["fingerprint"],
                     voters=verdict["voters"])
        if verdict["verdict"] in (integ.VERDICT_OK, integ.VERDICT_PENDING):
            return verdict
        self.violations += 1
        if self.action != "evict":
            logger.error(
                "serving integrity verdict %s (suspects %s) — "
                "integrity_action=warn, continuing",
                verdict["verdict"], verdict["suspects"])
            return verdict
        self.heartbeat.stop()
        if verdict["verdict"] == integ.VERDICT_NO_MAJORITY:
            msg = (f"serving fleet integrity: NO MAJORITY among "
                   f"{verdict['voters']} replica(s) — nobody can say "
                   "whose weights are right; poisoning the fleet")
            if tel_on:
                tel.flush(reason="serving_integrity_no_majority")
            raise TrainingDivergedError(msg)
        suspect = verdict["suspects"][0]
        detail = (f"weight fingerprint of replica(s) "
                  f"{verdict['suspects']} disagrees with the majority "
                  f"of {verdict['voters']} voter(s) "
                  f"(majority {verdict['fingerprint']})")
        integ.write_verdict(self.run_dir, integ.KIND_SDC, suspect,
                            detail, rank=self.rank,
                            step=SERVING_FINGERPRINT_STEP)
        if tel_on:
            tel.emit(TEL.EVENT_SERVING, kind="evict", suspect=suspect,
                     fault=integ.KIND_SDC)
            tel.flush(reason="serving_integrity_evict")
        raise FleetIntegrityError(
            f"serving fleet integrity: {detail}; exiting "
            f"{EXIT_INTEGRITY_EVICT} for eviction resize",
            suspect=suspect, kind=integ.KIND_SDC)

    def sample(self):
        """Off-hot-path integrity sample for a PARKED replica (its
        partition is drained but the fleet is still serving): recompute
        the fingerprint, block on the fetch — there is no decode fetch
        to ride — and vote.  A bitflip that lands after a replica
        finishes its own work is still convicted by the fleet."""
        dev = self.fingerprint_device()
        if dev is None:
            return None
        return self.note_weight_fingerprint(int(dev))


# ---------------------------------------------------------------------------
# SIGTERM drain (satellite: preempted replicas exit respawnable)
# ---------------------------------------------------------------------------

def drain_deadline_secs(grace=None):
    """Bounded-drain deadline under the ``DS_TERM_DRAIN_DEADLINE_SECS``
    contract (checkpoint/manager.py): an explicit value wins, ``<= 0``
    disables the bound, a non-numeric value degrades to the default —
    90% of the kill grace (``DS_TERM_GRACE_SECS``, default 30s) — with
    a warning, never an abort (this runs inside the SIGTERM
    handler)."""
    if grace is None:
        try:
            grace = float(os.environ.get("DS_TERM_GRACE_SECS", "30"))
        except ValueError:
            grace = 30.0
    raw = os.environ.get("DS_TERM_DRAIN_DEADLINE_SECS", "")
    try:
        return float(raw) if raw else grace * 0.9
    except ValueError:
        logger.warning(
            f"DS_TERM_DRAIN_DEADLINE_SECS={raw!r} is not a number; "
            "using the default (90% of the kill grace)")
        return grace * 0.9


def arm_serving_preemption(engine, signum=signal.SIGTERM, exit_fn=None):
    """Install a preemption handler that drains the serving engine
    instead of dropping its batch on the floor: stop admission, finish
    the in-flight decodes up to the bounded drain deadline, flush
    telemetry (``engine.close(reason="preempt_drain")``), then re-raise
    the signal under its default disposition so the launcher reads an
    ordinary preemption death — respawnable, and with an elastic
    supervisor armed, a resize trigger.  ``engine`` is duck-typed
    (anything with ``close(reason=...)``), so launcher tests can drive
    the contract with a stdlib stand-in.  Returns the installed
    handler."""
    fired = threading.Event()

    def _handler(sig, frame):
        if fired.is_set():          # second signal: die immediately
            signal.signal(sig, signal.SIG_DFL)
            os.kill(os.getpid(), sig)
            return
        fired.set()
        logger.warning(
            f"signal {sig}: draining serving engine (deadline "
            f"{drain_deadline_secs():.1f}s) before exiting respawnable")
        try:
            engine.close(reason="preempt_drain")
        except Exception as e:  # noqa: BLE001 — still exit respawnable
            logger.error("serving preemption drain failed: %s", e)
        if exit_fn is not None:
            exit_fn(128 + sig)
            return
        signal.signal(sig, signal.SIG_DFL)
        os.kill(os.getpid(), sig)

    signal.signal(signum, _handler)
    return _handler
