"""Continuous-batching scheduler: Orca-style iteration-level admission
over the paged KV cache (port of ``deepspeed_tpu/inference/scheduler.py``).

Pure host bookkeeping, unchanged from the JAX package: the scheduler
decides who runs; the engine launches the prefill and decode steps.
Per engine iteration:

1. finished slots (generation cap or EOS) release their blocks and free
   their slot, mid-batch, without draining the other sequences;
2. queued requests admit in FIFO order while a slot is free, the token
   budget holds, and the allocator can grant the request's whole
   worst-case block span (prefill bucket and prompt+generation cap), so
   decode can never run out of blocks;
3. every active slot advances one token through the fixed-width decode.

The token budget is the Orca admission knob: the sum of each active
request's worst case (prompt + remaining generation) stays under
``inference.token_budget``.
"""

import time
from collections import deque

from .kv_cache import NULL_BLOCK

# request lifecycle
QUEUED = "queued"
ACTIVE = "active"
FINISHED = "finished"

# finish reasons
REASON_EOS = "eos"
REASON_LENGTH = "max_new_tokens"
REASON_DEADLINE = "deadline"


class Request:
    """One generation request and its measured lifecycle.

    Timing fields are host wall-clock (``time.monotonic``): ``submitted``
    at entry, ``first_token_at`` when prefill emits (TTFT), ``step_times``
    one per generated token (the per-token latency record the serving
    bench quotes p50/p99 from).  ``deadline_at`` is an absolute
    monotonic expiry (None = no deadline): the scheduler's deadline
    sweep finishes an expired request with ``reason="deadline"`` and
    the partial tokens it generated so far."""

    __slots__ = ("request_id", "prompt", "max_new_tokens", "state",
                 "generated", "blocks", "slot", "bucket", "submitted",
                 "first_token_at", "finished_at", "finish_reason",
                 "step_times", "deadline_at", "requeues", "trace_id",
                 "admitted_at", "_cached_summary")

    def __init__(self, request_id, prompt, max_new_tokens,
                 deadline_at=None, trace_id=None):
        assert len(prompt) > 0, "empty prompt"
        self.request_id = request_id
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.state = QUEUED
        self.generated = []
        self.blocks = []
        self.slot = None
        self.bucket = None
        self.submitted = time.monotonic()
        self.first_token_at = None
        self.finished_at = None
        self.finish_reason = None
        self.step_times = []
        self.deadline_at = deadline_at
        self.requeues = 0
        # the lifecycle trace id: minted once at submit and PRESERVED
        # across reset_for_requeue, so a replica-death re-serve joins
        # into one trace in the event stream
        self.trace_id = trace_id
        self.admitted_at = None
        self._cached_summary = None

    def reset_for_requeue(self):
        """Return the request to a pristine QUEUED state for re-serving
        on another replica after its original replica died.  The KV
        cache died with the replica, so everything derived from serving
        — generated tokens, block grant, slot/bucket assignment, timing
        — is discarded; prefill recomputes it all, and greedy decode
        determinism makes the re-served tokens bit-identical.  The
        block list is just CLEARED, never released: the grant belonged
        to the dead replica's allocator (a live allocator must never be
        handed another pool's block ids — the leak class the
        blocks-conserved invariant test pins)."""
        assert self.state != FINISHED, (
            f"request {self.request_id!r} already finished; a completed "
            "result is never re-served (exactly-once)")
        self.state = QUEUED
        self.generated = []
        self.blocks = []
        self.slot = None
        self.bucket = None
        self.first_token_at = None
        self.finished_at = None
        self.finish_reason = None
        self.step_times = []
        self.requeues += 1
        self.admitted_at = None
        self._cached_summary = None

    @property
    def context_len(self):
        return len(self.prompt) + len(self.generated)

    def worst_case_tokens(self):
        return len(self.prompt) + self.max_new_tokens

    def result(self):
        """The request's latency summary.  Computed once and cached when
        the request is FINISHED (``step_times`` only grows while ACTIVE,
        so the cache can never go stale; ``reset_for_requeue``
        invalidates it) — report-cadence sampling of a large in-flight
        set used to re-sort ``step_times`` on every call."""
        if self._cached_summary is not None:
            return self._cached_summary
        lat = sorted(self.step_times)

        def pct(p):
            if not lat:
                return None
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        summary = {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "tokens": list(self.generated),
            "finish_reason": self.finish_reason,
            "requeues": self.requeues,
            "ttft_seconds": (self.first_token_at - self.submitted
                             if self.first_token_at is not None else None),
            "admission_wait_seconds": (
                self.admitted_at - self.submitted
                if self.admitted_at is not None else None),
            "latency_seconds": (self.finished_at - self.submitted
                                if self.finished_at is not None else None),
            "per_token_p50_seconds": pct(0.50),
            "per_token_p99_seconds": pct(0.99),
        }
        if self.state == FINISHED:
            self._cached_summary = summary
        return summary


class ContinuousBatchScheduler:
    """Slot/block/budget bookkeeping for one
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`."""

    def __init__(self, icfg, allocator):
        self.icfg = icfg
        self.allocator = allocator
        self.waiting = deque()
        self.slots = [None] * icfg.max_batch_slots
        self.admitted_total = 0
        self.finished_total = 0

    # -- state views ---------------------------------------------------
    @property
    def queue_depth(self):
        return len(self.waiting)

    def active_requests(self):
        return [r for r in self.slots if r is not None]

    @property
    def active_count(self):
        return sum(1 for r in self.slots if r is not None)

    def reserved_tokens(self):
        """Worst-case token debt of the active set (the budget term)."""
        return sum(r.worst_case_tokens() for r in self.slots
                   if r is not None)

    def idle(self):
        return not self.waiting and self.active_count == 0

    # -- admission ------------------------------------------------------
    def submit(self, request):
        icfg = self.icfg
        assert not request.blocks and request.slot is None, (
            f"request {request.request_id!r} submitted while still "
            "holding a block grant/slot — a requeued request must go "
            "through reset_for_requeue() first (a stale grant would be "
            "silently overwritten at admission and leak from its pool)")
        if request.worst_case_tokens() > icfg.max_seq_len:
            raise ValueError(
                f"request {request.request_id!r}: prompt "
                f"({len(request.prompt)}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds inference.max_seq_len "
                f"({icfg.max_seq_len})")
        if request.worst_case_tokens() > icfg.token_budget:
            # try_admit() can NEVER seat this request — even an empty
            # batch leaves the budget short — and FIFO admission means
            # it would park at the queue head starving everything
            # behind it forever.  Loud at submit time, not a hang
            raise ValueError(
                f"request {request.request_id!r}: prompt "
                f"({len(request.prompt)}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds "
                f"inference.token_budget ({icfg.token_budget}); this "
                "request could never be admitted (raise token_budget "
                "or shorten the request)")
        icfg.bucket_for(len(request.prompt))  # reject over-long prompts
        self.waiting.append(request)

    def _blocks_needed(self, request, bucket):
        bs = self.icfg.kv_block_size
        span = max(bucket, request.worst_case_tokens())
        return -(-span // bs)  # ceil

    def try_admit(self):
        """Admit the queue head if a slot, the token budget, and the
        block pool all allow it; None otherwise (FIFO — no overtaking,
        so admission latency stays predictable under load)."""
        if not self.waiting:
            return None
        free_slots = [i for i, r in enumerate(self.slots) if r is None]
        if not free_slots:
            return None
        request = self.waiting[0]
        if self.reserved_tokens() + request.worst_case_tokens() \
                > self.icfg.token_budget:
            return None
        bucket = self.icfg.bucket_for(len(request.prompt))
        blocks = self.allocator.allocate(self._blocks_needed(request,
                                                             bucket))
        if blocks is None:
            return None
        try:
            self.waiting.popleft()
            request.state = ACTIVE
            request.slot = free_slots[0]
            request.bucket = bucket
            request.blocks = blocks
            request.admitted_at = time.monotonic()
            self.slots[request.slot] = request
            self.admitted_total += 1
        except BaseException:
            # every early exit past the allocator grant MUST return the
            # blocks to the pool — a raise here would otherwise strand
            # the grant forever (the allocator has no owner to reclaim
            # from; the blocks-conserved invariant test pins this)
            self.allocator.release(blocks)
            if request.slot is not None \
                    and self.slots[request.slot] is request:
                self.slots[request.slot] = None
            request.blocks = []
            request.slot = None
            request.bucket = None
            if request.state == ACTIVE:
                request.state = QUEUED
            raise
        return request

    def block_table_row(self, request):
        """The request's block table padded to the fixed
        ``max_blocks_per_seq`` width with the null block."""
        width = self.icfg.max_blocks_per_seq
        row = list(request.blocks)[:width]
        return row + [NULL_BLOCK] * (width - len(row))

    # -- recycling ------------------------------------------------------
    def finish(self, request, reason):
        """Release the request's slot and blocks mid-batch (the
        continuous-batching move: siblings keep decoding)."""
        assert self.slots[request.slot] is request
        self.slots[request.slot] = None
        self.allocator.release(request.blocks)
        request.blocks = []
        request.state = FINISHED
        request.finish_reason = reason
        request.finished_at = time.monotonic()
        self.finished_total += 1

    def _finish_queued(self, request, reason):
        """Finish a request that never got a slot (expired while
        waiting): no blocks or slot to release, just the lifecycle
        bookkeeping."""
        request.state = FINISHED
        request.finish_reason = reason
        request.finished_at = time.monotonic()
        self.finished_total += 1

    def abort(self, request):
        """Forcibly release whatever the request holds — slot, block
        grant, queue position — WITHOUT finishing it (state returns to
        QUEUED, generated tokens are dropped by the caller's
        ``reset_for_requeue``).  The failure-recovery primitive: a
        prefill that raised after admission, or a replica front-end
        reclaiming a dead engine's in-flight work, must leave the
        allocator conserved (free == initial on idle) or every fault
        permanently shrinks the KV pool."""
        if request.state == ACTIVE:
            assert self.slots[request.slot] is request
            self.slots[request.slot] = None
            self.allocator.release(request.blocks)
        elif request.state == QUEUED:
            try:
                self.waiting.remove(request)
            except ValueError:
                pass
        request.blocks = []
        request.slot = None
        request.bucket = None
        request.state = QUEUED
        request.admitted_at = None

    def sweep_finished(self, eos_token_id):
        """Mark every slot that hit its cap or emitted EOS; returns the
        finished requests."""
        done = []
        for request in list(self.slots):
            if request is None:
                continue
            if (eos_token_id >= 0 and request.generated
                    and request.generated[-1] == eos_token_id):
                self.finish(request, REASON_EOS)
                done.append(request)
            elif len(request.generated) >= request.max_new_tokens:
                self.finish(request, REASON_LENGTH)
                done.append(request)
        return done

    def sweep_deadlines(self, now=None):
        """Finish every request — active OR still queued — whose
        wall-clock deadline has passed, with ``reason="deadline"`` and
        whatever tokens it generated so far.  Active slots and their
        block grants recycle mid-batch exactly like an EOS finish, so
        the queue head behind a stuck-slow batch gets the freed
        capacity the very next admission pass."""
        now = time.monotonic() if now is None else now
        done = []
        for request in list(self.slots):
            if request is None or request.deadline_at is None:
                continue
            if now >= request.deadline_at:
                self.finish(request, REASON_DEADLINE)
                done.append(request)
        for request in [r for r in self.waiting
                        if r.deadline_at is not None
                        and now >= r.deadline_at]:
            self.waiting.remove(request)
            self._finish_queued(request, REASON_DEADLINE)
            done.append(request)
        return done
