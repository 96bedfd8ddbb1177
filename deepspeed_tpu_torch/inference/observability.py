"""Serving observability plane: request-lifecycle tracing, SLO/goodput
accounting, and continuous-batching efficiency receipts (port of
``deepspeed_tpu/inference/observability.py``: the same phase table,
schema version and records, so a run dir reads alike in either
package).

Three layers, all riding the engine's EXISTING sync structure (the
serve loop's next-token fetch stays the only per-iteration host sync —
the card test counts syncs with the full plane armed):

1. **Request-lifecycle tracing.**  A trace id is minted once at submit
   (``ServingFrontend.submit`` for fleet serving, ``engine.submit`` for
   a bare engine) and threaded through admission, prefill, first token,
   the decode windows, requeue, and the terminal state.  The id
   survives ``Request.reset_for_requeue``, so a replica-death re-serve
   is ONE joined trace across replicas in the event stream.  Every
   phase record is a schema-versioned EVENT_SERVING event carrying
   ``trace``/``schema``/``t_mono`` (monotonic clock — orderable within
   a process, joinable by the doctor).

2. **Batching/KV efficiency metrics**, sampled ONLY at the
   steps_per_print cadence: batch-slot occupancy, token-budget
   utilization, padding-waste fraction per prefill bucket, the
   ``BlockAllocator`` pool occupancy + high-water mark, queue depth and
   admission-wait histograms.  Per-iteration bookkeeping is O(active)
   host arithmetic folded into loops the engine already runs.

3. **SLO + goodput.**  The ``inference.slo`` block (``ttft_ms``,
   ``per_token_ms``) defines what counts: *goodput* is tokens from
   SLO-meeting fetches vs raw throughput, attainment is the met
   fraction.  The high-rate per-token stream feeds the O(1) P²
   streaming quantile estimator (``telemetry.registry.quantiles``) —
   the algorithm-R reservoir histogram stays for the low-rate
   admission-wait stream.  With no SLO configured every token counts
   as good (goodput == raw throughput, attainment 1.0).

The cadence exporter :meth:`ServingObservability.export_serving_window`
runs only inside the ``steps_per_print`` guard.  :func:`latency_receipt`
(the port's) keeps TTFT and the decode-only per-token latencies apart,
where the engine receipt's ``per_token_*`` pools a request's first
token (its TTFT) with its decode tokens.
"""

import itertools
import os
import time

from ..telemetry import events as TEL

# version stamp every serving phase record carries; bump when a kind's
# payload shape changes (the golden-schema test pins the current table)
SERVING_TRACE_SCHEMA_VERSION = 1

# kind -> required payload keys for the schema-versioned lifecycle
# records (on TOP of EVENT_SERVING's baseline ``kind`` key).  The
# golden-schema test validates emitted records against this table, so a
# dropped key is a test failure, not a silently-thinned artifact.
SERVING_PHASE_KEYS = {
    "submit": ("trace", "request", "schema", "t_mono", "queue_depth"),
    "admit": ("trace", "request", "schema", "t_mono", "wait_seconds",
              "prompt_tokens", "bucket", "blocks", "slot", "queue_depth"),
    "first_token": ("trace", "request", "schema", "t_mono",
                    "ttft_seconds", "prefill_seconds", "bucket"),
    "decode_window": ("schema", "t_mono", "iterations", "tokens",
                      "active_traces", "batch_occupancy",
                      "token_budget_utilization", "kv_used_blocks",
                      "kv_used_peak"),
    "slo": ("schema", "t_mono", "window_tokens", "goodput_tokens",
            "slo_attainment", "goodput_tokens_per_second",
            "tokens_per_second"),
    "finish": ("trace", "request", "schema", "t_mono", "reason",
               "generated_tokens", "latency_seconds"),
    "deadline": ("trace", "request", "schema", "t_mono",
                 "generated_tokens"),
    "requeue": ("trace", "request", "schema", "t_mono", "replica",
                "requeues", "backoff_secs"),
    "shed": ("trace", "request", "schema", "t_mono", "queue_depth",
             "max_queue_depth"),
}

_TRACE_COUNTER = itertools.count()


def mint_trace_id():
    """A process-unique lifecycle trace id.  Minted ONCE per request at
    submit; requeues and replica hops reuse it (that is the point)."""
    return f"trace-{os.getpid()}-{next(_TRACE_COUNTER)}"


class ServingObservability:
    """Per-engine serving observability state.

    Constructed unconditionally by the engine (every method is cheap
    host arithmetic and internally no-ops event/metric emission when
    telemetry is disabled).  The engine calls three hooks:

    - :meth:`note_prefill` — after the prefill's first-token fetch;
    - :meth:`note_decode` — after the decode iteration's batched fetch
      (O(active) arithmetic on scalars the loop already holds);
    - :meth:`export_serving_window` — ONLY from the steps_per_print
      cadence block.
    """

    def __init__(self, engine):
        self.engine = engine
        self.telemetry = engine.telemetry
        icfg = engine.inference_config
        self.icfg = icfg
        self._slo_ttft = icfg.slo_ttft_ms / 1e3       # 0 = disabled
        self._slo_tok = icfg.slo_per_token_ms / 1e3   # 0 = disabled
        # padding waste per prefill bucket: prompt tokens vs padded
        # width actually computed (cumulative over the run)
        self._bucket_prompt = {b: 0 for b in icfg.prefill_buckets}
        self._bucket_padded = {b: 0 for b in icfg.prefill_buckets}
        # decode-window accumulators (reset at every cadence export)
        self._win_start = time.monotonic()
        self._win_iterations = 0
        self._win_tokens = 0
        self._win_good_tokens = 0
        self._win_active_sum = 0
        self._win_reserved_sum = 0
        self._win_traces = set()
        # run-cumulative accumulators (the bench receipt)
        self._run_start = self._win_start
        self._cum_iterations = 0
        self._cum_tokens = 0
        self._cum_good_tokens = 0
        self._cum_active_sum = 0
        self._cum_reserved_sum = 0

    # -- helpers --------------------------------------------------------
    def _emit(self, kind, **data):
        if self.telemetry.enabled:
            self.telemetry.emit(
                TEL.EVENT_SERVING, step=self.engine.decode_iterations,
                kind=kind, schema=SERVING_TRACE_SCHEMA_VERSION,
                t_mono=time.monotonic(), **data)

    def slo_enabled(self):
        return bool(self._slo_ttft or self._slo_tok)

    # -- lifecycle hooks ------------------------------------------------
    def note_submit(self, request, queue_depth):
        """Submit-time phase record — the trace's first event."""
        self._emit("submit", trace=request.trace_id,
                   request=request.request_id, queue_depth=queue_depth)

    def note_prefill(self, request, now, prefill_seconds):
        """Post-prefill accounting: the admit + first_token phase
        records, the admission-wait histogram, the per-token quantile
        observation for the TTFT token, the bucket padding-waste
        accumulators, and the TTFT leg of the SLO."""
        sched = self.engine.scheduler
        wait = (request.admitted_at - request.submitted
                if request.admitted_at is not None else 0.0)
        ttft = now - request.submitted
        self._bucket_prompt[request.bucket] += len(request.prompt)
        self._bucket_padded[request.bucket] += request.bucket
        self._cum_tokens += 1
        self._win_tokens += 1
        good = not self._slo_ttft or ttft <= self._slo_ttft
        if good:
            self._cum_good_tokens += 1
            self._win_good_tokens += 1
        self._win_traces.add(request.trace_id)
        if not self.telemetry.enabled:
            return
        self._emit("admit", trace=request.trace_id,
                   request=request.request_id, wait_seconds=wait,
                   prompt_tokens=len(request.prompt),
                   bucket=request.bucket, blocks=len(request.blocks),
                   slot=request.slot, queue_depth=sched.queue_depth)
        self._emit("first_token", trace=request.trace_id,
                   request=request.request_id, ttft_seconds=ttft,
                   prefill_seconds=prefill_seconds, bucket=request.bucket)
        self.telemetry.counter("serving/admitted").inc()
        self.telemetry.histogram(
            "serving/admission_wait_seconds").observe(wait)
        self.telemetry.quantiles(
            "serving/per_token_seconds").observe(ttft)

    def note_decode(self, before, latency):
        """Per-iteration accounting on already-fetched scalars: window
        occupancy/budget sums, the per-token P² observations, and the
        per-token SLO leg.  O(active) host arithmetic, zero syncs."""
        n = len(before)
        self._win_iterations += 1
        self._cum_iterations += 1
        self._win_tokens += n
        self._cum_tokens += n
        self._win_active_sum += n
        self._cum_active_sum += n
        reserved = self.engine.scheduler.reserved_tokens()
        self._win_reserved_sum += reserved
        self._cum_reserved_sum += reserved
        if not self._slo_tok or latency <= self._slo_tok:
            self._win_good_tokens += n
            self._cum_good_tokens += n
        q = self.telemetry.quantiles("serving/per_token_seconds")
        for request in before:
            self._win_traces.add(request.trace_id)
            q.observe(latency)

    def note_finish(self, request):
        self._emit(
            "finish", trace=request.trace_id, request=request.request_id,
            reason=request.finish_reason,
            generated_tokens=len(request.generated),
            latency_seconds=(request.finished_at - request.submitted
                             if request.finished_at is not None else None),
            queue_depth=self.engine.scheduler.queue_depth)
        if self.telemetry.enabled:
            self.telemetry.counter("serving/finished").inc()

    def note_deadline(self, request):
        self._emit("deadline", trace=request.trace_id,
                   request=request.request_id,
                   generated_tokens=len(request.generated),
                   queue_depth=self.engine.scheduler.queue_depth)
        if self.telemetry.enabled:
            self.telemetry.counter("serving/deadline_expired").inc()

    # -- padding waste --------------------------------------------------
    def padding_waste_by_bucket(self):
        """bucket -> wasted fraction of prefill compute (padded width
        beyond the prompt), cumulative over the run; buckets never used
        report None."""
        out = {}
        for b in self.icfg.prefill_buckets:
            padded = self._bucket_padded[b]
            out[b] = (1.0 - self._bucket_prompt[b] / padded
                      if padded else None)
        return out

    def padding_waste_fraction(self):
        padded = sum(self._bucket_padded.values())
        if not padded:
            return None
        return 1.0 - sum(self._bucket_prompt.values()) / padded

    # -- the cadence exporter (print-cadence only) ----------------------
    def export_serving_window(self):
        """Close the current decode window: emit the ``decode_window``
        + ``slo`` phase records, set the occupancy/goodput gauges, and
        reset the window accumulators.  Called ONLY from inside a
        ``steps_per_print`` guard."""
        if not self.telemetry.enabled:
            self._reset_window()
            return
        now = time.monotonic()
        window = max(now - self._win_start, 1e-9)
        icfg = self.icfg
        iters = self._win_iterations
        occupancy = (self._win_active_sum
                     / (iters * icfg.max_batch_slots) if iters else 0.0)
        budget_util = (self._win_reserved_sum
                       / (iters * icfg.token_budget) if iters else 0.0)
        allocator = self.engine.allocator
        self._emit("decode_window", iterations=iters,
                   tokens=self._win_tokens,
                   active_traces=sorted(self._win_traces),
                   batch_occupancy=occupancy,
                   token_budget_utilization=budget_util,
                   kv_used_blocks=allocator.used_blocks,
                   kv_used_peak=allocator.used_peak)
        attainment = (self._win_good_tokens / self._win_tokens
                      if self._win_tokens else 1.0)
        self._emit("slo", window_tokens=self._win_tokens,
                   goodput_tokens=self._win_good_tokens,
                   slo_attainment=attainment,
                   goodput_tokens_per_second=self._win_good_tokens / window,
                   tokens_per_second=self._win_tokens / window)
        gauge = self.telemetry.gauge
        gauge("serving/batch_occupancy").set(occupancy)
        gauge("serving/token_budget_utilization").set(budget_util)
        gauge("serving/kv_used_blocks").set(float(allocator.used_blocks))
        gauge("serving/kv_used_peak").set(float(allocator.used_peak))
        gauge("serving/slo_attainment").set(attainment)
        gauge("serving/goodput_tokens_per_second").set(
            self._win_good_tokens / window)
        waste = self.padding_waste_fraction()
        if waste is not None:
            gauge("serving/padding_waste_fraction").set(waste)
        self._reset_window(now)

    def _reset_window(self, now=None):
        self._win_start = now if now is not None else time.monotonic()
        self._win_iterations = 0
        self._win_tokens = 0
        self._win_good_tokens = 0
        self._win_active_sum = 0
        self._win_reserved_sum = 0
        self._win_traces = set()

    # -- the bench receipt ----------------------------------------------
    def receipt(self):
        """Run-cumulative occupancy/SLO receipt — merged into
        ``engine.serving_receipt()``."""
        icfg = self.icfg
        iters = self._cum_iterations
        wall = max(time.monotonic() - self._run_start, 1e-9)
        return {
            "batch_occupancy_mean": (
                self._cum_active_sum / (iters * icfg.max_batch_slots)
                if iters else None),
            "token_budget_utilization": (
                self._cum_reserved_sum / (iters * icfg.token_budget)
                if iters else None),
            "kv_block_occupancy_peak": (
                self.engine.allocator.used_peak
                / self.engine.allocator.capacity),
            "padding_waste_fraction": self.padding_waste_fraction(),
            "goodput_tokens": self._cum_good_tokens,
            "goodput_tokens_per_second": self._cum_good_tokens / wall,
            "slo_attainment": (self._cum_good_tokens / self._cum_tokens
                               if self._cum_tokens else 1.0),
            "slo_enabled": self.slo_enabled(),
        }


def _pct(vals, p):
    """The serving receipts' percentile of sorted ``vals`` (None if
    empty), the JAX engine's ``serving_receipt`` rule."""
    if not vals:
        return None
    return float(vals[min(len(vals) - 1, int(p * len(vals)))])


def latency_receipt(requests, slo_ttft_ms=0.0, slo_per_token_ms=0.0):
    """TTFT and decode-only per-token latency over ``requests`` (their
    delivered tokens), and goodput under the SLO.

    A request's ``step_times[0]`` is its TTFT (submit to first token; a
    requeued request's clock keeps running from its first submit) and
    each later entry the decode iteration that made a token.  The engine
    receipt's ``per_token_*`` pools both; here they are two streams.  A
    token is good when its time meets its leg of the SLO (the TTFT leg
    for the first token, the per-token leg for the rest; a target of 0
    is no target), as :class:`ServingObservability` counts it."""
    ttfts = sorted(r.step_times[0] for r in requests if r.step_times)
    decode = sorted(t for r in requests for t in r.step_times[1:])
    slo_ttft, slo_tok = slo_ttft_ms / 1e3, slo_per_token_ms / 1e3
    good = (sum(1 for t in ttfts if not slo_ttft or t <= slo_ttft)
            + sum(1 for t in decode if not slo_tok or t <= slo_tok))
    tokens = len(ttfts) + len(decode)
    return {
        "ttft_p50_seconds": _pct(ttfts, 0.50),
        "ttft_p99_seconds": _pct(ttfts, 0.99),
        "decode_per_token_p50_seconds": _pct(decode, 0.50),
        "decode_per_token_p99_seconds": _pct(decode, 0.99),
        "delivered_tokens": tokens,
        "delivered_goodput_tokens": good,
        "delivered_slo_attainment": good / tokens if tokens else 1.0,
    }
