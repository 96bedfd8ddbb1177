"""Fleet integrity plane: state-fingerprint consensus + hang quorum
(port of ``deepspeed_tpu/resilience/integrity.py``; the files it reads
and writes are the JAX package's, so either package's launcher reads
the other's verdicts).

Every robustness layer before this one reacts to *loud* failures — a
crash, a watchdog 85, a SIGTERM.  At fleet scale the run-eating
failures are *silent*:

- **SDC / replica desync** — a bit-flipped master on one host quietly
  desyncs the data-parallel replicas.  In pure-dp every replica's
  (master, optimizer) state must agree **bit-exactly** after every
  step, so a cheap on-device checksum published per rank turns "silently
  wrong since step 40k" into a majority vote: the one rank whose
  fingerprint disagrees is the suspect.
- **a single hung rank** — one wedged host stalls every peer inside a
  collective until each peer's *local* watchdog independently times
  out (N timeouts, N blind respawns).  Ranks instead publish heartbeat
  files; healthy ranks notice a peer that stopped entering steps while
  a majority kept going, reach a quorum, and exit with ONE respawnable
  eviction code — one resize, not N timeouts.

Both verdicts converge on the same recovery contract: a verdict file
(:data:`VERDICT_FILE`) naming the suspect, an exit with
:data:`~deepspeed_tpu.resilience.constants.EXIT_INTEGRITY_EVICT`, and
the launcher's elastic supervisor rolling every rank back to the
latest committed checkpoint and resizing with the suspect's devices
charged against the elastic budget.  No-majority splits and repeated
evictions escalate to the poison code instead (there is no healthy
majority left to trust).

All exchange rides the shared run dir with the same atomic
tmp+``os.replace`` file pattern as the ``latency-rank*.json`` skew
exchange: no collectives, no device access, and the fingerprint
itself rides a fetch the engine makes anyway — zero new host syncs
(the engine's :mod:`~deepspeed_tpu_torch.resilience.fingerprint`
computes it on the card; the publish/read APIs run at the print
cadence only).

Consensus model: the vote compares *per-process* fingerprints, so it
applies where each process's addressable state is replica-identical
across the fleet — pure data parallelism (each process holds a full
replica, or the same union of local ZeRO shards).  Meshes that shard
state *across* processes get per-process fingerprints that legitimately
differ; localization there needs per-shard fingerprints (future work)
and the plane should run in ``integrity_action="warn"`` mode.

Stdlib-only on purpose: the launcher imports this module to read
verdicts and clear fleet state without touching the card.
"""

import json
import logging
import os
import threading
import time
import uuid

from .constants import EXIT_INTEGRITY_EVICT

logger = logging.getLogger(__name__)

INTEGRITY_FILE_PREFIX = "integrity-rank"
INTEGRITY_FILE_SUFFIX = ".json"
HEARTBEAT_FILE_PREFIX = "heartbeat-rank"
HEARTBEAT_FILE_SUFFIX = ".json"
#: the supervisor-facing verdict artifact (first writer wins)
VERDICT_FILE = "integrity-verdict.json"
#: a consumed verdict, renamed (not deleted) by the first launcher to
#: act on it — sibling nodes' launchers sharing the run dir read it as
#: a fallback so the node that owns the suspect's slot still aims its
#: resize (startswith(VERDICT_FILE) keeps it inside clear_fleet_state's
#: full-clear match set)
VERDICT_CONSUMED_FILE = VERDICT_FILE + ".consumed"

# consensus verdicts
VERDICT_OK = "ok"                    # quorum agreed bit-exactly
VERDICT_OUTLIER = "outlier"          # majority agreed, suspects named
VERDICT_NO_MAJORITY = "no_majority"  # split with no strict majority
VERDICT_PENDING = "pending"          # no step has quorum participation

# verdict kinds (what detected the suspect)
KIND_SDC = "sdc_outlier"
KIND_HANG = "hang_quorum"

INTEGRITY_ACTIONS = ("evict", "warn")


def atomic_publish_json(path, payload, log_context="integrity"):
    """tmp + ``os.replace``: readers never see a torn file.  Fail-soft
    (returns None on OSError) — a full disk must not take training
    down.  THE shared-run-dir publish primitive: the latency
    exchange (:mod:`~deepspeed_tpu_torch.profiling.comm`) delegates here so
    the two exchanges cannot drift."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except OSError as e:
        logger.debug("%s: publish to %s failed: %s", log_context, path, e)
        return None
    return path


def read_fleet_json_files(run_dir, prefix, suffix, world_size=None,
                          max_age_secs=None, require_key="rank",
                          rank_from_name=False):
    """{rank: payload} over every parseable ``<prefix><k><suffix>``
    under ``run_dir`` — torn/foreign files and payloads missing
    ``require_key`` skipped, integer ranks outside ``[0, world_size)``
    dropped (files left by a previous, larger fleet in the same dir are
    definitionally not part of this run), payloads older than
    ``max_age_secs`` dropped.

    ``rank_from_name=True`` keeps the published ``rank`` value as-is
    and falls back to the filename digits (as a string) when a legacy
    writer omitted it — the latency exchange's oldest contract.
    The default parses ``rank`` as an int and drops unparseable
    files."""
    out = {}
    try:
        names = sorted(os.listdir(str(run_dir)))
    except OSError:
        return out
    now = time.time()
    for name in names:
        if not (name.startswith(prefix) and name.endswith(suffix)):
            continue
        try:
            with open(os.path.join(str(run_dir), name),
                      encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(payload, dict) or require_key not in payload:
            continue
        if max_age_secs is not None and payload.get("ts") is not None:
            try:
                stale = now - float(payload["ts"]) > max_age_secs
            except (TypeError, ValueError):
                # foreign/corrupt ts: skip the file, never crash the
                # voting rank's step loop over shared-run-dir debris
                continue
            if stale:
                continue
        if rank_from_name:
            rank = payload.get("rank",
                               name[len(prefix):-len(suffix)])
        else:
            try:
                rank = int(payload["rank"])
            except (KeyError, TypeError, ValueError):
                continue
        if (world_size is not None and isinstance(rank, int)
                and not 0 <= rank < world_size):
            continue
        out[rank] = payload
    return out


# ---------------------------------------------------------------------------
# fingerprint exchange (print-cadence only)
# ---------------------------------------------------------------------------

def fingerprint_filename(rank):
    return f"{INTEGRITY_FILE_PREFIX}{rank}{INTEGRITY_FILE_SUFFIX}"


def canonical_fingerprint(value):
    """Canonical wire form of a fingerprint: 8 hex digits of the uint32
    checksum.  String compare == bit-exact compare."""
    return f"{int(value) & 0xFFFFFFFF:08x}"


def publish_rank_fingerprint(run_dir, rank, history, step=None):
    """Atomically publish one rank's fingerprint history (``{step:
    canonical_fp}`` for the recent window) to
    ``<run_dir>/integrity-rank<k>.json``.  Print-cadence only by
    contract.  Returns the path, or None on failure."""
    payload = {"rank": int(rank), "ts": time.time(),
               "fingerprints": {str(s): fp for s, fp in history.items()}}
    if step is not None:
        payload["step"] = int(step)
    return atomic_publish_json(
        os.path.join(str(run_dir), fingerprint_filename(rank)), payload)


def read_fleet_fingerprints(run_dir, world_size=None, max_age_secs=None):
    """{rank: {step(int): canonical_fp}} over every parseable
    ``integrity-rank*.json`` under ``run_dir``.  Print-cadence only by
    contract."""
    fleet = {}
    raw = read_fleet_json_files(run_dir, INTEGRITY_FILE_PREFIX,
                                INTEGRITY_FILE_SUFFIX,
                                world_size=world_size,
                                max_age_secs=max_age_secs)
    for rank, payload in raw.items():
        fps = payload.get("fingerprints")
        if not isinstance(fps, dict):
            continue
        hist = {}
        for s, fp in fps.items():
            try:
                hist[int(s)] = str(fp)
            except (TypeError, ValueError):
                continue
        fleet[rank] = hist
    return fleet


def fingerprint_consensus(fleet, fleet_size, min_quorum=None):
    """Majority vote over the fleet's published fingerprint histories.

    For every step any rank published (newest first), the ranks that
    published that step vote; a step only counts when at least
    ``min_quorum`` ranks (default: a strict majority of ``fleet_size``)
    participated.  In pure-dp the replicas must agree **bit-exactly**,
    so:

    - all voters agree at every quorum step         -> ``ok``
    - a strict FLEET majority agrees, someone disagrees -> ``outlier``
      (the disagreeing ranks are SDC/desync suspects; corruption
      propagates, so scanning the whole window catches a suspect whose
      publishes lag the fleet head.  Conviction needs the majority
      fingerprint held by >= ``min_quorum`` ranks — a plurality of the
      step's voters alone must not evict a peer the unpublished rest
      of the fleet may agree with; such steps are skipped)
    - voters tied with no strict majority among them, and no bloc can
      reach fleet quorum even with every unpublished rank joining it
      -> ``no_majority`` (provably unrecoverable by eviction: nobody
      can say who is right).  A tie a lagging publisher could still
      break is skipped, not poisoned
    - no step reached quorum                        -> ``pending``

    Returns ``{"verdict", "step", "suspects", "fingerprint", "voters"}``
    (suspects sorted; fingerprint = the majority value at the verdict
    step, None for pending/no_majority)."""
    if min_quorum is None:
        min_quorum = int(fleet_size) // 2 + 1
    min_quorum = max(2, int(min_quorum))
    steps = sorted({s for hist in fleet.values() for s in hist},
                   reverse=True)
    newest_ok = None
    for step in steps:
        votes = {rank: hist[step] for rank, hist in fleet.items()
                 if step in hist}
        if len(votes) < min_quorum:
            continue
        counts = {}
        for fp in votes.values():
            counts[fp] = counts.get(fp, 0) + 1
        majority_fp, majority_n = max(counts.items(), key=lambda kv: kv[1])
        if majority_n * 2 <= len(votes):
            # tied among this step's VOTERS.  Only provably split (the
            # unrecoverable poison) when even every unpublished rank
            # joining the largest bloc could not reach fleet quorum —
            # otherwise a lagging publisher may still break the tie,
            # and poisoning 2-2-of-5 would tear down a run that one
            # more publish could have saved by eviction.  Undecidable:
            # keep scanning
            if majority_n + (int(fleet_size) - len(votes)) < min_quorum:
                return {"verdict": VERDICT_NO_MAJORITY, "step": step,
                        "suspects": sorted(votes), "fingerprint": None,
                        "voters": len(votes)}
            continue
        if majority_n < min_quorum:
            # a plurality of the step's VOTERS but not a strict majority
            # of the FLEET (lagging publishers): convicting here would
            # let 2 of 5 ranks evict a healthy peer.  Not provably split
            # either — the step is undecidable, keep scanning
            continue
        suspects = sorted(r for r, fp in votes.items()
                          if fp != majority_fp)
        if suspects:
            return {"verdict": VERDICT_OUTLIER, "step": step,
                    "suspects": suspects, "fingerprint": majority_fp,
                    "voters": len(votes)}
        if newest_ok is None:
            newest_ok = {"verdict": VERDICT_OK, "step": step,
                         "suspects": [], "fingerprint": majority_fp,
                         "voters": len(votes)}
    return newest_ok or {"verdict": VERDICT_PENDING, "step": None,
                         "suspects": [], "fingerprint": None,
                         "voters": 0}


# ---------------------------------------------------------------------------
# heartbeat exchange + hang quorum
# ---------------------------------------------------------------------------

def heartbeat_filename(rank):
    return f"{HEARTBEAT_FILE_PREFIX}{rank}{HEARTBEAT_FILE_SUFFIX}"


def publish_rank_heartbeat(run_dir, rank, step):
    """Atomically publish one rank's step-entry beat: {rank, step, ts}.
    ``step`` is the optimizer step the rank is ENTERING — a rank hung
    before the step region never publishes it, which is exactly the
    lag the quorum discriminates on."""
    return atomic_publish_json(
        os.path.join(str(run_dir), heartbeat_filename(rank)),
        {"rank": int(rank), "step": int(step), "ts": time.time()})


def read_fleet_heartbeats(run_dir, world_size=None):
    """{rank: {"step", "ts"}} over every parseable
    ``heartbeat-rank*.json`` under ``run_dir``."""
    out = {}
    for rank, payload in read_fleet_json_files(
            run_dir, HEARTBEAT_FILE_PREFIX, HEARTBEAT_FILE_SUFFIX,
            world_size=world_size).items():
        try:
            out[rank] = {"step": int(payload["step"]),
                         "ts": float(payload["ts"])}
        except (KeyError, TypeError, ValueError):
            continue
    return out


def hang_quorum(fleet, self_rank, fleet_size, peer_timeout_secs,
                now=None):
    """Hang verdict from the fleet's heartbeat files, or None.

    A rank is the hang suspect when its published step LAGS the fleet
    head and its beat is stale by more than ``peer_timeout_secs``,
    while a strict majority of the fleet (including this rank) has
    entered the head step.  Peers blocked *inside* a collective behind
    the hung rank are stale too — but they are AT the head step, which
    is the discriminator: the victim never entered it.

    This rank abstains when it is not itself at the head step (it might
    be the hung one — its local watchdog owns that verdict) and never
    names itself.

    Staleness compares the PUBLISHER's wall-clock ``ts`` against the
    observer's clock, so a multi-host fleet needs clocks synchronized
    to well within ``peer_timeout_secs`` (NTP easily clears the
    multi-second timeouts this is meant for); a host whose clock lags
    by more than the timeout would read as stale whenever it is
    momentarily one step behind.  The launcher-supervised single-node
    fleet shares one clock and is immune."""
    if now is None:
        now = time.time()
    if len(fleet) < 2 or self_rank not in fleet:
        return None
    head = max(info["step"] for info in fleet.values())
    leaders = [r for r, info in fleet.items() if info["step"] == head]
    if self_rank not in leaders:
        return None
    if len(leaders) * 2 <= int(fleet_size):
        return None
    suspects = [(now - info["ts"], r) for r, info in fleet.items()
                if r != self_rank and info["step"] < head
                and now - info["ts"] > float(peer_timeout_secs)]
    if not suspects:
        return None
    stalled, suspect = max(suspects)
    return {"suspect": suspect, "stalled_secs": stalled,
            "suspect_step": fleet[suspect]["step"], "head_step": head,
            "leaders": len(leaders), "fleet": len(fleet)}


# ---------------------------------------------------------------------------
# verdict file (engine -> supervisor) + fleet-state lifecycle
# ---------------------------------------------------------------------------

def write_verdict(run_dir, kind, suspect, detail, rank=None, step=None,
                  **extra):
    """Record the eviction verdict for the supervisor — FIRST writer
    wins (``open(..., 'x')``): every healthy rank that reaches the same
    verdict races to write it, and the launcher needs exactly one.
    Returns the path (existing or new), or None when the dir is
    unwritable."""
    path = os.path.join(str(run_dir), VERDICT_FILE)
    payload = dict(extra, kind=str(kind), suspect=int(suspect),
                   detail=str(detail), ts=time.time())
    if rank is not None:
        payload["rank"] = int(rank)
    if step is not None:
        payload["step"] = int(step)
    # fully write a PER-WRITER tmp, then os.link it to the verdict
    # path: link fails atomically when the file exists (first writer
    # wins) and only ever publishes complete JSON — a writer killed
    # mid-dump with open(path, 'x') would leave a torn verdict that
    # silently suppresses every other accuser's.  The suffix carries a
    # uuid, not just the pid: accusers on DIFFERENT nodes share the
    # run dir and can share a pid, and two writers on one tmp path
    # would truncate each other and link a torn verdict
    tmp = path + f".w{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
        except FileExistsError:
            return path
        finally:
            os.remove(tmp)
    except OSError as e:
        logger.error("integrity: verdict write to %s failed: %s", path, e)
        return None
    return path


def _load_verdict(path):
    try:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict):
        return None
    try:
        payload["suspect"] = int(payload["suspect"])
    except (KeyError, TypeError, ValueError):
        # shared-run-dir debris (foreign writer, other schema version):
        # a "verdict" the supervisor cannot aim is not a verdict — and
        # it must never TypeError the launcher monitor loop, the one
        # process that has to outlive everything
        return None
    return payload


def read_verdict(run_dir, include_consumed=False):
    """The committed verdict dict, or None (absent/torn/unaimable —
    ``suspect`` is validated as an int so a malformed file reads as no
    verdict, never as a crash in the consumer).  With
    ``include_consumed``, fall back to the consumed marker a sibling
    node's launcher left behind (dedup is the caller's job: the payload
    ``ts`` identifies one verdict across both names)."""
    names = ((VERDICT_FILE, VERDICT_CONSUMED_FILE) if include_consumed
             else (VERDICT_FILE,))
    for name in names:
        payload = _load_verdict(os.path.join(str(run_dir), name))
        if payload is not None:
            return payload
    return None


def mark_verdict_consumed(run_dir):
    """Atomically rename the committed verdict to the consumed marker
    instead of deleting it: deletion would race sibling nodes' monitor
    polls in a shared run dir, and the node that actually owns the
    suspect's slot would resize blind.  Frees ``VERDICT_FILE`` for the
    next life's first-writer-wins commit.  Fail-soft (None when there
    is nothing to rename or the dir is unwritable)."""
    src = os.path.join(str(run_dir), VERDICT_FILE)
    dst = os.path.join(str(run_dir), VERDICT_CONSUMED_FILE)
    try:
        os.replace(src, dst)
    except OSError:
        return None
    return dst


def clear_fleet_state(run_dir, rank=None, keep_consumed=False):
    """Remove every integrity artifact (fingerprints, heartbeats, the
    consumed verdict) from ``run_dir``.  The launcher calls this before
    respawning a resized fleet: a new life must not vote against the
    previous life's stale files, and a rolled-back fleet recomputes the
    abandoned timeline's fingerprints.  Returns the number of files
    removed.

    With ``rank`` given, remove only THAT rank's fingerprint/heartbeat
    files (+ their publish ``.tmp``), leaving peers' state and any
    verdict intact — the targeted form for an ordinary single-rank
    respawn: the dead life's stale beat would otherwise read as "step
    lags the head, beat stale" through the backoff + re-init window and
    the hang quorum would falsely convict the new life.

    ``keep_consumed`` preserves the :data:`VERDICT_CONSUMED_FILE`
    marker (the resize-path clear: sibling nodes' launchers sharing the
    run dir may not have consumed the verdict yet, and each launcher
    dedups by the payload ``ts`` so the lingering marker is inert to
    this one).  The launcher's START-of-run clear uses the default and
    scrubs it with everything else."""
    removed = 0
    try:
        names = os.listdir(str(run_dir))
    except OSError:
        return removed
    if rank is not None:
        mine = (fingerprint_filename(rank), heartbeat_filename(rank))
        targets = set(mine) | {m + ".tmp" for m in mine}
    for name in names:
        if rank is not None:
            if name not in targets:
                continue
        elif keep_consumed and name == VERDICT_CONSUMED_FILE:
            continue
        else:
            # startswith covers the verdict's per-writer .w<pid> tmps
            # (a writer killed mid-commit leaves one behind)
            is_state = name.startswith(VERDICT_FILE) or any(
                name.startswith(p) and name.endswith(s)
                for p, s in ((INTEGRITY_FILE_PREFIX,
                              INTEGRITY_FILE_SUFFIX),
                             (HEARTBEAT_FILE_PREFIX,
                              HEARTBEAT_FILE_SUFFIX)))
            # the atomic-publish .tmp of either family is state too
            if not is_state and not (
                    (name.startswith(INTEGRITY_FILE_PREFIX)
                     or name.startswith(HEARTBEAT_FILE_PREFIX))
                    and name.endswith(".tmp")):
                continue
        try:
            os.remove(os.path.join(str(run_dir), name))
            removed += 1
        except OSError:
            pass
    return removed


# ---------------------------------------------------------------------------
# engine-facing plumbing
# ---------------------------------------------------------------------------

class IntegrityPlane:
    """One rank's host-side half of the fingerprint consensus.

    Holds the recent fingerprint history (the window published in this
    rank's file), publishes at the print cadence, reads the fleet back,
    and votes.  Host arithmetic + tiny run-dir file I/O only — the
    device-side checksum is
    :func:`~deepspeed_tpu_torch.resilience.fingerprint.state_fingerprint`,
    whose scalar rides a fetch the engine makes anyway."""

    def __init__(self, run_dir, rank, fleet_size, window=8,
                 action="evict", max_age_secs=600.0):
        assert action in INTEGRITY_ACTIONS, (
            f"integrity action {action!r} not one of {INTEGRITY_ACTIONS}")
        self.run_dir = str(run_dir)
        self.rank = int(rank)
        self.fleet_size = max(1, int(fleet_size))
        self.window = max(1, int(window))
        self.action = action
        self.max_age_secs = max_age_secs
        self.history = {}          # step -> canonical fp (recent window)
        self.last_verdict = None

    def note_fingerprint(self, step, value):
        """Record + publish this rank's step fingerprint, read the
        fleet, and return the consensus verdict dict (see
        :func:`fingerprint_consensus`).  Print-cadence only by
        contract."""
        self.history[int(step)] = canonical_fingerprint(value)
        for s in sorted(self.history)[:-self.window]:
            del self.history[s]
        publish_rank_fingerprint(self.run_dir, self.rank, self.history,
                                 step=step)
        fleet = read_fleet_fingerprints(self.run_dir,
                                        world_size=self.fleet_size,
                                        max_age_secs=self.max_age_secs)
        verdict = fingerprint_consensus(fleet, self.fleet_size)
        self.last_verdict = verdict
        return verdict

    def record_eviction_verdict(self, kind, suspect, detail, step=None):
        """Publish the supervisor-facing verdict file (first writer
        wins)."""
        return write_verdict(self.run_dir, kind, suspect, detail,
                             rank=self.rank, step=step)

    def reset_history(self):
        """Drop this rank's fingerprint history AND its published file
        — called after an in-process rollback restore: the abandoned
        timeline's fingerprints must not stay published for peers to
        vote against while the healed replica replays (the window file
        would otherwise only be replaced at the next print cadence,
        and a mixed stale/replayed window could convict a rank the
        rollback already fixed)."""
        self.history.clear()
        self.last_verdict = None
        base = os.path.join(self.run_dir, fingerprint_filename(self.rank))
        for path in (base, base + ".tmp"):
            try:
                os.remove(path)
            except OSError:
                pass


class FleetHeartbeat:
    """One rank's heartbeat publisher + peer-staleness monitor.

    ``beat(step)`` is called from the engine's step loop when it ENTERS
    an optimizer step (throttled file write, O(1) host work, no device
    access).  A daemon thread re-reads the fleet's beats; when the hang
    quorum names a stale peer it records the verdict, runs ``on_fire``
    (telemetry flush — the exit skips atexit), and exits the process
    with the respawnable eviction code so the launcher resizes ONCE
    instead of N local watchdogs timing out independently.

    Like the step watchdog, the monitor only arms after this rank's
    FIRST beat (initial compilation legitimately outlasts any sane peer
    timeout), and ``pause()`` disarms it across known-long gaps
    (rollback restore, final synchronous save)."""

    def __init__(self, run_dir, rank, fleet_size, peer_timeout_secs,
                 poll_interval=None, min_publish_secs=0.2, exit_fn=None,
                 on_fire=None, action="evict", quorum_fn=None,
                 verdict_kind=KIND_HANG):
        assert peer_timeout_secs > 0, "peer timeout must be > 0"
        assert action in INTEGRITY_ACTIONS, (
            f"integrity action {action!r} not one of {INTEGRITY_ACTIONS}")
        self.run_dir = str(run_dir)
        self.rank = int(rank)
        self.fleet_size = int(fleet_size)
        self.action = action
        self.peer_timeout_secs = float(peer_timeout_secs)
        self.poll_interval = float(
            poll_interval if poll_interval is not None
            else min(1.0, self.peer_timeout_secs / 4))
        self.min_publish_secs = float(min_publish_secs)
        self._exit_fn = exit_fn if exit_fn is not None else (
            lambda code: os._exit(code))
        self._on_fire = on_fire      # optional (verdict) -> None
        self._armed = False
        self._last_publish = 0.0
        self._last_step = None
        self._last_published_step = None
        # beat() (main thread) and the monitor's paused-republish share
        # one tmp path; two concurrent writers would truncate each
        # other's half-written file and os.replace could promote torn
        # JSON — atomic_publish_json is only atomic per single writer
        self._publish_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.fired = False
        self.last_verdict = None
        # the verdict function over the fleet's heartbeat map.  Default:
        # the training quorum (step-position + staleness).  A serving
        # fleet decodes independent request streams whose iteration
        # counters are incomparable, so it substitutes a freshness-
        # majority quorum (inference/resilience.serving_hang_quorum)
        # with the same (fleet, self_rank, fleet_size, timeout)
        # signature and verdict-dict shape.
        self._quorum_fn = quorum_fn if quorum_fn is not None \
            else hang_quorum
        self._verdict_kind = verdict_kind

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="ds-fleet-heartbeat")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def pause(self):
        """Disarm until the next :meth:`beat` — a restore or a final
        synchronous save must not read as a peer hang.  A paused rank
        abstains from voting AND the monitor thread keeps republishing
        its last beat with a fresh timestamp (peer conviction happens
        on the peers' side: going silent for longer than their timeout
        would get this rank evicted for a routine long save)."""
        self._armed = False

    def beat(self, step):
        """Entering optimizer step ``step``: throttled atomic publish.
        O(1) host work + at most one tiny file write per
        ``min_publish_secs``; no device access.  The throttle is purely
        time-based — publishing every step would put a JSON write +
        rename on the hot path of sub-``min_publish_secs`` steps.  A throttled
        step advance is NOT lost: the monitor thread catches the
        published beat up within one ``poll_interval`` (see
        :meth:`_run`), so the published step never lags the true
        position longer than ``peer_timeout_secs / 4`` — without that
        catch-up, a long step FOLLOWING a sub-throttle one would leave
        this rank published one step behind the head with a growing-
        stale timestamp, the exact shape the quorum convicts, and a
        healthy rank blocked behind a genuinely hung peer could be
        named instead of the peer."""
        now = time.monotonic()
        self._last_step = step
        if now - self._last_publish >= self.min_publish_secs:
            with self._publish_lock:
                publish_rank_heartbeat(self.run_dir, self.rank, step)
            self._last_publish = now
            self._last_published_step = step
        self._armed = True

    # ------------------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.poll_interval):
            if self.fired:
                continue
            if not self._armed:
                # paused for a known-long gap (rollback restore, final
                # synchronous save): keep THIS rank's beat fresh so
                # peers that advanced to the head never convict us for
                # the pause — conviction happens on THEIR side, so
                # disarming our own vote alone would not protect us.
                # Abstain from voting meanwhile.  (Before the first
                # beat, _last_step is None: an unpublished rank is not
                # in the fleet map and cannot be convicted.)
                if self._last_step is not None:
                    with self._publish_lock:
                        publish_rank_heartbeat(self.run_dir, self.rank,
                                               self._last_step)
                    self._last_published_step = self._last_step
                continue
            if self._last_published_step != self._last_step:
                # beat()'s time throttle swallowed a step-entry publish
                # — catch up OFF the hot path.  Only real main-thread
                # PROGRESS triggers a fresh publish here: a rank wedged
                # mid-step makes none, so its timestamp still goes
                # stale and a genuine hang is never masked.
                step = self._last_step
                with self._publish_lock:
                    publish_rank_heartbeat(self.run_dir, self.rank, step)
                self._last_publish = time.monotonic()
                self._last_published_step = step
            fleet = read_fleet_heartbeats(self.run_dir,
                                          world_size=self.fleet_size)
            verdict = self._quorum_fn(fleet, self.rank, self.fleet_size,
                                      self.peer_timeout_secs)
            if verdict is None:
                continue
            self.fired = True
            self.last_verdict = verdict
            detail = (
                f"rank {verdict['suspect']} stalled "
                f"{verdict['stalled_secs']:.1f}s at step "
                f"{verdict['suspect_step']} while {verdict['leaders']}/"
                f"{verdict['fleet']} rank(s) reached step "
                f"{verdict['head_step']} (peer timeout "
                f"{self.peer_timeout_secs:.1f}s)")
            if self.action != "evict":
                # integrity_action="warn" is the operator's explicit
                # opt-out of automated eviction (documented contract:
                # telemetry only) — no verdict file, no exit.  ``fired``
                # latches so a long stall warns once per life, not once
                # per poll
                logger.warning(
                    "fleet heartbeat: hang quorum — %s; "
                    "integrity_action='warn': telemetry only, not "
                    "evicting", detail)
                if self._on_fire is not None:
                    try:
                        self._on_fire(verdict)
                    except Exception as e:  # noqa: BLE001 — warn path
                        logger.error("heartbeat on_fire hook failed: %s",
                                     e)
                continue
            write_verdict(self.run_dir, self._verdict_kind,
                          verdict["suspect"], detail, rank=self.rank,
                          step=verdict["head_step"])
            logger.error(
                "fleet heartbeat: hang quorum — %s; exiting %d "
                "(respawnable eviction) instead of blocking in the "
                "collective until the local watchdog fires", detail,
                EXIT_INTEGRITY_EVICT)
            if self._on_fire is not None:
                try:
                    self._on_fire(verdict)
                except Exception as e:  # noqa: BLE001 — exiting anyway
                    logger.error("heartbeat on_fire hook failed: %s", e)
            self._exit_fn(EXIT_INTEGRITY_EVICT)
            return
