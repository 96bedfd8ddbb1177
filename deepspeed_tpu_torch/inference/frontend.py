"""Multi-replica serving front-end: routing, load shedding, graceful
degradation, and requeue-with-backoff around dead replicas (port of
``deepspeed_tpu/inference/frontend.py``).

The front-end owns request-level robustness; the per-replica
:class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine` owns
decode.  One router, N engines in one process (replicas may share one
card and one param dict: serving never writes the params; each has its
own KV pool):

- **admission** — round-robin over live replicas.  With
  ``inference.max_queue_depth`` set, a submit arriving at a full fleet
  queue is SHED with :class:`ServingOverloadError` — a typed verdict
  the caller can retry on, instead of an unbounded queue whose tail
  latency quietly blows every deadline.  Past
  ``inference.degrade_queue_depth`` the front-end first degrades:
  new requests' ``max_new_tokens`` cap drops to
  ``inference.degraded_max_new_tokens``, trading answer length for
  admission rate before any request is refused.
- **requeue** — :meth:`mark_dead` reclaims a dead replica's
  unfinished requests: each is reset to a pristine queued state
  (``Request.reset_for_requeue`` — the KV cache died with the
  replica, so prefill recomputes) and re-dispatched to a surviving
  replica after an exponential per-request backoff.  Greedy decode is
  deterministic, so the re-served tokens are bit-identical to what
  the dead replica would have produced — the property the
  kill-at-every-iteration sweep test pins.
- **exactly-once** — results are keyed by request id and harvested
  once; a finished result is never re-served (``reset_for_requeue``
  refuses), and a requeued request completes on exactly one surviving
  replica.
"""

import logging
import time
from collections import deque

from ..telemetry import events as TEL
from .observability import (SERVING_TRACE_SCHEMA_VERSION, latency_receipt,
                            mint_trace_id)
from .scheduler import FINISHED, REASON_DEADLINE

logger = logging.getLogger(__name__)


class ServingOverloadError(RuntimeError):
    """Typed load-shed verdict: the fleet queue is at
    ``inference.max_queue_depth`` and this request was refused AT
    SUBMIT — nothing was queued, nothing must be cleaned up.  Carries
    the observed depth so callers can implement informed backoff."""

    def __init__(self, message, queue_depth=None, max_queue_depth=None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.max_queue_depth = max_queue_depth


class ServingFrontend:
    """Route requests over a fleet of in-process serving replicas with
    shedding, degradation, deadlines, and dead-replica requeue."""

    def __init__(self, replicas, telemetry=None,
                 requeue_backoff_secs=0.0):
        assert replicas, "a serving front-end needs at least one replica"
        self.replicas = list(replicas)
        self.icfg = self.replicas[0].inference_config
        self._alive = [True] * len(self.replicas)
        self._telemetry = (telemetry if telemetry is not None
                           else self.replicas[0].telemetry)
        self.requeue_backoff_secs = float(requeue_backoff_secs)
        # fleet-gauge export cadence: the replicas' steps_per_print, so
        # front-end gauges land at the same rhythm as engine samples
        self.steps_per_print = self.replicas[0].steps_per_print
        self._steps = 0
        self._owner = {}        # rid -> replica index (unfinished only)
        self._completed = {}    # rid -> result dict (delivered once)
        self._delivered = {}    # rid -> the finished Request behind it
        self._backlog = deque()  # (ready_at, request) awaiting re-dispatch
        self._next_request_id = 0
        self._rr = 0
        self.shed_total = 0
        self.degraded_total = 0
        self.requeued_total = 0
        self.deadline_total = 0
        self._recoveries = []    # (death_t, pending rid set, [latency])

    # -- state views ---------------------------------------------------
    def live_replicas(self):
        return [i for i, up in enumerate(self._alive) if up]

    def queue_depth(self):
        """Fleet-wide admission debt: every queued-but-not-decoding
        request, including the requeue backlog (those re-enter a
        replica queue as soon as their backoff expires)."""
        return (sum(self.replicas[i].scheduler.queue_depth
                    for i in self.live_replicas())
                + len(self._backlog))

    def _emit(self, kind, **data):
        if self._telemetry is not None and self._telemetry.enabled:
            self._telemetry.emit(TEL.EVENT_SERVING, kind=kind,
                                 schema=SERVING_TRACE_SCHEMA_VERSION,
                                 t_mono=time.monotonic(), **data)

    def _pick_replica(self):
        live = self.live_replicas()
        if not live:
            raise RuntimeError(
                "serving front-end: no live replicas left to route to")
        self._rr += 1
        return live[self._rr % len(live)]

    # -- admission ------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, request_id=None,
               deadline_ms=None):
        """Admit one request to the fleet; returns its id.  Sheds with
        :class:`ServingOverloadError` at ``max_queue_depth``; degrades
        the generation cap past ``degrade_queue_depth``.  The lifecycle
        trace id is minted HERE, before the shed decision, so a refused
        request still leaves a (trace, shed) record — a load-shed storm
        is attributable per request, not just a counter."""
        if request_id is None:
            request_id = f"req-{self._next_request_id}"
            self._next_request_id += 1
        trace_id = mint_trace_id()
        depth = self.queue_depth()
        self._emit("submit", trace=trace_id, request=request_id,
                   queue_depth=depth)
        if self.icfg.max_queue_depth \
                and depth >= self.icfg.max_queue_depth:
            self.shed_total += 1
            self._emit("shed", trace=trace_id, request=request_id,
                       queue_depth=depth,
                       max_queue_depth=self.icfg.max_queue_depth)
            raise ServingOverloadError(
                f"fleet queue depth {depth} at inference.max_queue_depth "
                f"({self.icfg.max_queue_depth}): shedding this request",
                queue_depth=depth,
                max_queue_depth=self.icfg.max_queue_depth)
        cap = (int(max_new_tokens) if max_new_tokens is not None
               else self.icfg.max_new_tokens)
        if self.icfg.degrade_queue_depth \
                and depth >= self.icfg.degrade_queue_depth \
                and cap > self.icfg.degraded_max_new_tokens:
            cap = self.icfg.degraded_max_new_tokens
            self.degraded_total += 1
            self._emit("degrade", trace=trace_id, request=request_id,
                       queue_depth=depth, capped_to=cap)
        idx = self._pick_replica()
        self.replicas[idx].submit(prompt, max_new_tokens=cap,
                                  request_id=request_id,
                                  deadline_ms=deadline_ms,
                                  trace_id=trace_id)
        self._owner[request_id] = idx
        return request_id

    # -- replica failure ------------------------------------------------
    def mark_dead(self, idx):
        """Declare replica ``idx`` dead and reclaim its unfinished
        requests into the requeue backlog.  Results the dead replica
        already finished (materialized in router memory) are delivered,
        not recomputed; everything else is reset — generated tokens
        discarded, the dead allocator's block grant cleared, never
        released into a survivor's pool — and re-dispatched after an
        exponential per-request backoff.  Returns the requeued ids."""
        if not self._alive[idx]:
            return []
        self._alive[idx] = False
        engine = self.replicas[idx]
        self._harvest(idx)
        now = time.monotonic()
        moved = []
        for rid, owner in list(self._owner.items()):
            if owner != idx:
                continue
            request = engine.request(rid)
            # release the dead engine's bookkeeping cleanly (in-process
            # replicas share the test's address space; a real dead
            # process needs no cleanup) so its allocator stays
            # conserved, then reset the request for a fresh life
            engine.scheduler.abort(request)
            engine.forget(rid)
            request.reset_for_requeue()
            delay = (self.requeue_backoff_secs
                     * (2 ** (request.requeues - 1)))
            self._backlog.append((now + delay, request))
            del self._owner[rid]
            moved.append(rid)
            self._emit("requeue", trace=request.trace_id, request=rid,
                       replica=idx, requeues=request.requeues,
                       backoff_secs=delay)
        self.requeued_total += len(moved)
        if moved:
            self._recoveries.append([now, set(moved), None])
        logger.warning(
            "serving front-end: replica %d dead, %d request(s) "
            "requeued onto %d survivor(s)", idx, len(moved),
            len(self.live_replicas()))
        return moved

    def _dispatch_backlog(self):
        now = time.monotonic()
        held = []
        while self._backlog:
            ready_at, request = self._backlog.popleft()
            if ready_at > now:
                held.append((ready_at, request))
                continue
            idx = self._pick_replica()
            self.replicas[idx].resubmit(request)
            self._owner[request.request_id] = idx
        self._backlog.extend(held)

    # -- the serve loop -------------------------------------------------
    def _harvest(self, idx):
        engine = self.replicas[idx]
        for rid, owner in list(self._owner.items()):
            if owner != idx:
                continue
            request = engine.request(rid)
            if request is None or request.state != FINISHED:
                continue
            if request.finish_reason == REASON_DEADLINE:
                self.deadline_total += 1
            self._completed[rid] = request.result()
            self._delivered[rid] = request
            del self._owner[rid]
            for rec in self._recoveries:
                rec[1].discard(rid)
                if not rec[1] and rec[2] is None:
                    rec[2] = time.monotonic() - rec[0]

    def export_serving_gauges(self):
        """Standing fleet gauges a scrape can alert on (shed/degrade
        were events only): queue depth including the requeue backlog,
        and the live-replica count.  Called only under a
        ``steps_per_print`` guard."""
        if self._telemetry is None or not self._telemetry.enabled:
            return
        self._telemetry.gauge("serving/queue_depth").set(
            float(self.queue_depth()))
        self._telemetry.gauge("serving/live_replicas").set(
            float(len(self.live_replicas())))

    def step(self):
        """One front-end iteration: re-dispatch expired backlog, step
        every live replica (an engine that RAISES is declared dead and
        its work requeued), harvest finished results."""
        self._dispatch_backlog()
        for idx in self.live_replicas():
            try:
                self.replicas[idx].step()
            except Exception as e:  # noqa: BLE001 — replica fault
                logger.error(
                    "serving front-end: replica %d raised mid-step "
                    "(%s); declaring it dead and requeuing", idx, e)
                self.mark_dead(idx)
                continue
            self._harvest(idx)
        self._steps += 1
        if self._steps % self.steps_per_print == 0:
            self.export_serving_gauges()

    def run(self, max_steps=100000):
        """Drain the fleet: iterate until every submitted request has a
        result; returns ``{request_id: result}``."""
        steps = 0
        while self._owner or self._backlog:
            steps += 1
            assert steps <= max_steps, (
                f"serving front-end failed to drain within {max_steps} "
                f"steps ({len(self._owner)} in flight, "
                f"{len(self._backlog)} backlogged)")
            if self._backlog and not self._owner:
                # everything is waiting out a backoff window — idle the
                # loop briefly instead of spinning the replicas hot
                time.sleep(0.001)
            self.step()
        return dict(self._completed)

    def results(self):
        return dict(self._completed)

    # -- receipts -------------------------------------------------------
    def resilience_receipt(self):
        """The requeue/shed/deadline/recovery counters."""
        latencies = [rec[2] for rec in self._recoveries
                     if rec[2] is not None]
        return {
            "completed_requests": len(self._completed),
            "requeued_requests": self.requeued_total,
            "shed_requests": self.shed_total,
            "degraded_requests": self.degraded_total,
            "deadline_expired": self.deadline_total,
            "dead_replicas": sum(1 for up in self._alive if not up),
            "recovery_latency_seconds": (max(latencies) if latencies
                                         else None),
        }

    def serving_receipt(self):
        """:meth:`resilience_receipt` plus the fleet's latency over every
        delivered request (:func:`~deepspeed_tpu_torch.inference.observability.latency_receipt`:
        TTFT and decode-only per-token p50/p99, goodput of the delivered
        tokens under ``inference.slo``), pooled across the replicas; a
        requeued request counts once, with its TTFT from its first
        submit."""
        receipt = self.resilience_receipt()
        receipt.update(latency_receipt(
            self._delivered.values(), self.icfg.slo_ttft_ms,
            self.icfg.slo_per_token_ms))
        return receipt
