"""InferenceEngine: continuous-batching serving over a paged KV cache
(port of ``deepspeed_tpu/inference/engine.py``).

One prefill per admitted request, at the smallest declared bucket that
fits its prompt, then one fixed-width decode step per engine iteration
over every active slot.  Both write the KV cache in place.  Prefill
attention runs on the Hopper flash-attention kernel when the engine is
on CUDA.  The only host syncs are the token fetches the serve loop needs
anyway: one per prefill and one per decode iteration.  The per-call
index inputs (token ids, block tables, context lengths) go to the device
through pinned staging buffers with asynchronous copies.

Telemetry and the serving observability plane (JAX ``:94-150``,
``:226-364``): a ``telemetry`` block opens the run dir's event stream;
each request's lifecycle (submit, admit, first token, finish or
deadline) is a schema-versioned ``serving`` record under one trace id,
and the ``steps_per_print`` cadence adds the queue, decode-window and
SLO records and the occupancy gauges
(:class:`~deepspeed_tpu_torch.inference.observability.ServingObservability`),
all host arithmetic on numbers the loop already fetched.  Shedding and
degradation act in the front-end
(:class:`~deepspeed_tpu_torch.inference.frontend.ServingFrontend`).

The health plane (JAX ``:287-320``, ``:386-396``, ``:577-585``,
``:627-637``; :mod:`~deepspeed_tpu_torch.inference.resilience`):
``attach_health(ServingHealth(...))`` beats the fleet heartbeat at every
decode iteration and, on the ``steps_per_print`` cadence, folds the
recomputed weight fingerprint into that iteration's next-token fetch,
so it adds no host sync; the host scalar then goes to the vote.

The memory ledger (JAX ``:103-130``; the ``profiling`` block,
:mod:`~deepspeed_tpu_torch.profiling.memory`) measures the decode step's
and each prefill bucket's first call, and ``serving_receipt`` counts
the entry points recorded (``programs_compiled``).  The comm ledger
(JAX ``:100-110``, ``:496-540``) records the first decode iteration as
the ``serve_decode`` program, with its overlap summary (the roofline
compute of what it dispatches: :mod:`~deepspeed_tpu_torch.profiling.overlap`);
``comm_receipt``, ``overlap_receipt`` and ``attribution_receipt`` price
one decode iteration, and ``profiling.program_dump`` writes the program
to the run dir's ``programs/`` for the doctor.  Each iteration's wall
time (host preparation, launches and the token fetch) feeds a latency
ring, the measured side of the attribution, and its host bracket (up to
the last launch) the driver phase, charged as in the training engine:
what the bracket took beyond the predicted device time.  The print
cadence adds the ``comm``/``latency`` snapshot, the
``serving/attribution/*`` gauges and an ``attribution`` record, host
arithmetic only.  Not ported: the DSP6xx program verification (ROADMAP
A12 step 6).
"""

import logging
import time

import torch

from ..ops.transformer.flash_attention import flash_attention_fwd
from ..profiling.comm import SERVE_DECODE_PROGRAM, CommLedger
from ..profiling.config import DeepSpeedProfilingConfig
from ..profiling.memory import MemoryLedger
from ..profiling.step_profiler import StepLatencyRing
from ..profiling.verify import ProgramDumper
from ..runtime import constants as C
from ..telemetry import events as TEL
from ..telemetry.config import DeepSpeedTelemetryConfig
from ..telemetry.manager import TelemetryManager
from ..utils.device import resolve_device
from ..utils.distributed import fleet_identity
from ..utils.params import params_from_numpy, tree_leaves
from .config import DeepSpeedInferenceConfig
from .kv_cache import BlockAllocator, init_kv_cache
from .model import build_decode, build_prefill
from .observability import (ServingObservability, latency_receipt,
                            mint_trace_id)
from .resilience import drain_deadline_secs
from .scheduler import ContinuousBatchScheduler, Request

logger = logging.getLogger(__name__)

# the decode step's ledger name (the JAX package's)
DECODE_PROGRAM = SERVE_DECODE_PROGRAM


def prefill_program_name(bucket):
    """The ledger name of a prefill bucket's entry point."""
    return f"serve_prefill_{int(bucket)}"


class InferenceEngine:
    """Serve a GPT-2 family model with continuous batching.

    ``model`` is a :class:`~deepspeed_tpu_torch.models.gpt2.GPT2LMHead`
    (or anything exposing ``.config`` with the same geometry fields);
    ``params`` its param dict, with numpy or tensor leaves (use
    :func:`~deepspeed_tpu_torch.module_inject.ingest_gpt2_model` for an
    HF checkpoint); a dict of tensors already on ``device`` in the
    serve dtype is used as it is, so replicas on one card can share one.
    ``config`` is the usual DeepSpeed config dict; the ``inference``
    block's keys are checked against the known ones.  ``device=None``
    serves on CUDA and raises without it."""

    def __init__(self, model, params, config=None, device=None):
        param_dict = dict(config or {})
        self.inference_config = DeepSpeedInferenceConfig(param_dict)
        icfg = self.inference_config
        self._validate_config(param_dict)
        self.device = resolve_device(device, "InferenceEngine")
        self.model = model
        mc = model.config
        if mc.max_position_embeddings < icfg.max_seq_len:
            raise ValueError(
                f"inference.max_seq_len ({icfg.max_seq_len}) exceeds the "
                f"model's max_position_embeddings "
                f"({mc.max_position_embeddings})")
        self.steps_per_print = int(param_dict.get(
            C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT))
        serve_dtype = (torch.bfloat16 if icfg.weights_dtype == "bfloat16"
                       else None)
        self.params = params_from_numpy(params, self.device, serve_dtype)
        self._k_cache, self._v_cache = init_kv_cache(
            mc.num_layers, icfg.kv_blocks, icfg.kv_block_size,
            mc.num_heads, mc.hidden_size // mc.num_heads,
            dtype=serve_dtype or torch.float32, device=self.device)
        self.allocator = BlockAllocator(icfg.kv_blocks)
        self.scheduler = ContinuousBatchScheduler(icfg, self.allocator)
        self._decode = build_decode(mc, icfg)
        self._prefills = {bucket: build_prefill(mc, icfg, bucket)
                          for bucket in icfg.prefill_buckets}
        # host staging buffers for the per-call index inputs (pinned on
        # CUDA, so the copies to the device do not block) and their
        # device twins.  A host buffer is rewritten only after the token
        # fetch that ends the call which read it, so its copy is done.
        n, width = icfg.max_batch_slots, icfg.max_blocks_per_seq
        self._host, self._dev = {}, {}
        for name, shape in (("ids", (1, icfg.prefill_buckets[-1])),
                            ("table", (width,)), ("tables", (n, width)),
                            ("ctx_lens", (n,)), ("tokens", (n,))):
            self._host[name] = torch.zeros(
                shape, dtype=torch.int64,
                pin_memory=self.device.type == "cuda")
            self._dev[name] = torch.zeros(shape, dtype=torch.int64,
                                          device=self.device)
        self.telemetry_config = DeepSpeedTelemetryConfig(param_dict)
        # a replica of a launcher fleet writes its own rank's files
        self.telemetry = TelemetryManager(self.telemetry_config,
                                          rank=fleet_identity()[0],
                                          device=self.device)
        profiling_config = DeepSpeedProfilingConfig(param_dict)
        self.memory_ledger = MemoryLedger(
            enabled=profiling_config.memory_ledger_enabled(
                self.telemetry.enabled),
            telemetry=self.telemetry, device=self.device)
        ledger_on = profiling_config.comm_ledger_enabled(
            self.telemetry.enabled)
        dump_on = (profiling_config.program_dump_enabled(ledger_on)
                   and bool(self.telemetry.run_dir))
        self.comm_ledger = CommLedger(
            enabled=ledger_on or dump_on, telemetry=self.telemetry,
            device=self.device)
        self.comm_ledger.overlap_context_fn = self.program_verify_context
        if dump_on:
            self.comm_ledger.dumper = ProgramDumper(
                self.telemetry.run_dir, rank=fleet_identity()[0])
        # each decode iteration's wall time and its host bracket (the
        # attribution's measured side and driver phase)
        self._step_latencies = StepLatencyRing()
        self._driver_latencies = StepLatencyRing()
        self._decode = self.memory_ledger.wrap(DECODE_PROGRAM, self._decode)
        self._prefills = {
            bucket: self.memory_ledger.wrap(prefill_program_name(bucket), fn)
            for bucket, fn in self._prefills.items()}
        self.decode_iterations = 0
        # the serving observability plane: lifecycle tracing, occupancy
        # windows, SLO/goodput accounting.  Always built — every hook is
        # host arithmetic that emits nothing with telemetry off, and the
        # receipt needs the accumulators either way
        self.observability = ServingObservability(self)
        self.generated_tokens = 0
        self._results = {}
        self._next_request_id = 0
        self._draining = False
        self._closed = False
        self._health = None
        self._pending_fingerprint = None
        self.telemetry.emit(TEL.EVENT_RUN_START, world_size=1,
                            mode="serving",
                            max_batch_slots=icfg.max_batch_slots,
                            kv_blocks=icfg.kv_blocks,
                            prefill_buckets=list(icfg.prefill_buckets))
        logger.info(
            "InferenceEngine on %s: %d layers, %d slots, %d KV blocks x %d "
            "tokens, prefill buckets %s, weights %s", self.device,
            mc.num_layers, icfg.max_batch_slots, icfg.kv_blocks,
            icfg.kv_block_size, list(icfg.prefill_buckets),
            icfg.weights_dtype)

    @classmethod
    def from_hf_gpt2(cls, hf_params, model_config, config=None, device=None):
        """Serve an HF GPT-2 checkpoint's param tree: weight surgery
        through ``module_inject``, then the standard constructor (which
        applies the configured serve dtype)."""
        from ..models.gpt2 import GPT2LMHead
        from ..module_inject import ingest_gpt2_model

        return cls(GPT2LMHead(model_config), ingest_gpt2_model(hf_params),
                   config=config, device=device)

    @staticmethod
    def _validate_config(param_dict):
        """Unknown keys in the ``inference`` block (and its ``slo``
        sub-block) and in the ``telemetry`` block warn, or raise under
        ``strict_config``.  Shedding and degradation
        (``max_queue_depth``, ``degrade_queue_depth``,
        ``degraded_max_new_tokens``) act in the
        :class:`~deepspeed_tpu_torch.inference.frontend.ServingFrontend`,
        the ``slo`` targets in the goodput accounting."""
        strict = bool(param_dict.get(C.STRICT_CONFIG,
                                     C.STRICT_CONFIG_DEFAULT))
        inf = param_dict.get(C.INFERENCE) or {}
        issues = [f"unknown key '{C.INFERENCE}.{k}'"
                  for k in inf if k not in C.INFERENCE_KEYS]
        slo = inf.get(C.INFERENCE_SLO) or {}
        issues += [f"unknown key '{C.INFERENCE}.{C.INFERENCE_SLO}.{k}'"
                   for k in slo if k not in C.INFERENCE_SLO_KEYS]
        tel = param_dict.get(C.TELEMETRY) or {}
        issues += [f"unknown key '{C.TELEMETRY}.{k}'" for k in tel
                   if k not in C.SECTION_KEYS[C.TELEMETRY]]
        for issue in issues:
            logger.warning("InferenceEngine config: %s", issue)
        if strict and issues:
            raise ValueError("strict_config: rejected configuration: "
                             + "; ".join(issues))

    # ------------------------------------------------------------------
    # request front-end
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, request_id=None,
               deadline_ms=None, trace_id=None):
        """Queue one generation request; returns its id.  Rejects (by
        raising) prompts longer than the largest prefill bucket and
        requests whose worst case exceeds ``max_seq_len`` — at
        submission, never mid-serve.  ``deadline_ms`` overrides the
        configured ``inference.request_deadline_ms`` for this request
        (0 = no deadline).  ``trace_id`` joins this request into a
        lifecycle trace a front-end minted; None mints one here."""
        if self._draining:
            raise RuntimeError(
                "InferenceEngine is draining (close()/SIGTERM): "
                "admission is stopped; route this request elsewhere")
        if request_id is None:
            request_id = f"req-{self._next_request_id}"
            self._next_request_id += 1
        minted_here = trace_id is None
        if minted_here:
            trace_id = mint_trace_id()
        ms = (deadline_ms if deadline_ms is not None
              else self.inference_config.request_deadline_ms)
        request = Request(
            request_id, prompt,
            max_new_tokens if max_new_tokens is not None
            else self.inference_config.max_new_tokens,
            deadline_at=(time.monotonic() + ms / 1000.0 if ms else None),
            trace_id=trace_id)
        self.scheduler.submit(request)
        self._results[request_id] = request
        if minted_here:
            # a front-end that minted the trace already wrote its submit
            # record (before its shed decision); a bare submit starts
            # the trace here
            self.observability.note_submit(request,
                                           self.scheduler.queue_depth)
        return request_id

    def resubmit(self, request):
        """Admit a requeued :class:`Request` (already through
        ``reset_for_requeue``): same validation as :meth:`submit`, but
        the request object — id, prompt and requeue count — survives."""
        if self._draining:
            raise RuntimeError(
                "InferenceEngine is draining (close()/SIGTERM): "
                "admission is stopped; route this request elsewhere")
        self.scheduler.submit(request)
        self._results[request.request_id] = request
        return request.request_id

    def request(self, request_id):
        """The live :class:`Request` behind an id (None if unknown)."""
        return self._results.get(request_id)

    def forget(self, request_id):
        """Drop a request from this engine's result map (it moved to
        another replica; keeping it would double-count it here)."""
        self._results.pop(request_id, None)

    # ------------------------------------------------------------------
    # the serve loop
    # ------------------------------------------------------------------
    def _host_view(self, name):
        """The host staging buffer ``name``, zeroed, as a numpy array."""
        view = self._host[name].numpy()
        view[...] = 0
        return view

    def _to_device(self, name, columns=None):
        """Queue the copy of host staging buffer ``name`` (its first
        ``columns`` columns) to its device twin, with no host sync."""
        host, dev = self._host[name], self._dev[name]
        if columns is not None:
            host, dev = host[..., :columns], dev[..., :columns]
        return dev.copy_(host, non_blocking=True)

    @torch.no_grad()
    def _run_prefill(self, request):
        sched = self.scheduler
        t_pre = time.monotonic()
        self._host_view("ids")[0, :len(request.prompt)] = request.prompt
        self._host_view("table")[:] = sched.block_table_row(request)
        first = self._prefills[request.bucket](
            self.params, self._k_cache, self._v_cache,
            self._to_device("ids", request.bucket), len(request.prompt),
            self._to_device("table"))
        token = int(first)  # the prefill's one host sync
        now = time.monotonic()
        request.first_token_at = now
        request.step_times.append(now - request.submitted)
        request.generated.append(token)
        self.generated_tokens += 1
        # admit + first_token records, the admission-wait histogram, the
        # TTFT leg of the SLO, the bucket padding-waste accumulators
        self.observability.note_prefill(request, now, now - t_pre)

    @torch.no_grad()
    def _decode_once(self):
        """One continuous-batch decode iteration over the active slots,
        with one host sync: the next-token fetch.  With a health plane
        attached, the cadence iterations fold the recomputed weight
        fingerprint into that same fetch."""
        sched = self.scheduler
        t_prep = time.monotonic()
        tables = self._host_view("tables")
        ctx_lens = self._host_view("ctx_lens")
        tokens = self._host_view("tokens")
        before = []
        for request in sched.slots:
            if request is None:
                continue
            tables[request.slot] = sched.block_table_row(request)
            # position of the token being decoded = current context - 1
            # (the last generated token is the decode input)
            ctx_lens[request.slot] = request.context_len - 1
            tokens[request.slot] = request.generated[-1]
            before.append(request)
        fp_dev = None
        if self._health is not None:
            # liveness tick for ENTERING this iteration (throttled O(1)
            # publish; a wedged decode never refreshes it again)
            self._health.beat(self.decode_iterations + 1)
            if (self.decode_iterations + 1) % self.steps_per_print == 0:
                fp_dev = self._health.fingerprint_device()
        t0 = time.monotonic()
        self.comm_ledger.begin(DECODE_PROGRAM)
        next_dev = self._decode(self.params, self._k_cache, self._v_cache,
                                self._to_device("tables"),
                                self._to_device("ctx_lens"),
                                self._to_device("tokens"))
        if fp_dev is not None:
            # the fingerprint (below 2^32) rides the token fetch
            next_dev = torch.cat([next_dev.to(torch.int64).reshape(-1),
                                  fp_dev.reshape(1)])
        self.comm_ledger.end(DECODE_PROGRAM)
        self._driver_latencies.record(time.monotonic() - t_prep)
        next_tokens = next_dev.tolist()  # the iteration's one host sync
        if fp_dev is not None:
            self._pending_fingerprint = next_tokens.pop()
        now = time.monotonic()
        self._step_latencies.record(now - t_prep)
        self.decode_iterations += 1
        for request in before:
            request.generated.append(int(next_tokens[request.slot]))
            request.step_times.append(now - t0)
            self.generated_tokens += 1
        # O(active) host arithmetic on numbers this loop already holds
        # (window sums, per-token P² observations, the per-token SLO
        # leg): no sync
        self.observability.note_decode(before, now - t0)

    def _sample_telemetry(self):
        """Print-cadence sampling (JAX ``engine.py:341-364``): queue and
        occupancy gauges, one ``queue`` record, the observability
        window's ``decode_window`` and ``slo`` records, the decode
        latency snapshot (the doctor's measured side) and the
        attribution gauges and record — host arithmetic on fetched
        numbers, no sync."""
        if not self.telemetry.enabled:
            return
        sched = self.scheduler
        self.telemetry.gauge("serving/queue_depth").set(
            float(sched.queue_depth))
        self.telemetry.gauge("serving/active_slots").set(
            float(sched.active_count))
        self.telemetry.gauge("serving/free_blocks").set(
            float(self.allocator.free_blocks))
        self.telemetry.gauge("serving/generated_tokens").set(
            float(self.generated_tokens))
        self.telemetry.emit(
            TEL.EVENT_SERVING, step=self.decode_iterations, kind="queue",
            queue_depth=sched.queue_depth, active=sched.active_count,
            free_blocks=self.allocator.free_blocks,
            reserved_tokens=sched.reserved_tokens())
        self.observability.export_serving_window()
        snap = self._step_latencies.latency_snapshot()
        if snap["n"]:
            from ..profiling import comm as comm_prof

            for key in ("last", "mean", "p50", "p95", "max"):
                self.telemetry.gauge(
                    f"comm/latency/{key}_secs").set(snap[key])
            self.telemetry.emit(TEL.EVENT_COMM, step=self.decode_iterations,
                                kind=comm_prof.KIND_LATENCY, **snap)
        receipt = self.attribution_receipt()
        if receipt is not None:
            self.telemetry.gauge(
                "serving/attribution/predicted_step_seconds").set(
                    float(receipt["predicted_step_seconds"]))
            if receipt["measured_step_seconds"] is not None:
                for phase, val in receipt["phases"].items():
                    if val is not None:
                        self.telemetry.gauge(
                            f"serving/attribution/{phase}_seconds").set(
                                float(val))
                self.telemetry.gauge(
                    "serving/attribution/measured_step_seconds").set(
                        float(receipt["measured_step_seconds"]))
                self.telemetry.emit(TEL.EVENT_ATTRIBUTION,
                                    step=self.decode_iterations, **receipt)

    def _sample_integrity(self):
        """Print-cadence health sample (JAX ``engine.py:386-396``): hand
        the fingerprint the decode fetch already brought back to the
        health plane — publish, fleet read, majority vote.  Raises
        :class:`~deepspeed_tpu_torch.resilience.constants.FleetIntegrityError`
        (exit code 87) when the vote convicts a replica."""
        if self._health is None or self._pending_fingerprint is None:
            return
        value, self._pending_fingerprint = self._pending_fingerprint, None
        self._health.note_weight_fingerprint(value)

    def _sweep_finished(self):
        """The scheduler's sweep of finished slots, each with its
        ``finish`` record."""
        done = self.scheduler.sweep_finished(
            self.inference_config.eos_token_id)
        for request in done:
            self.observability.note_finish(request)
        return done

    def step(self):
        """One engine iteration: expire deadlines, recycle finished
        slots, admit from the queue (each admission prefills
        immediately), then advance every active slot one token.
        Returns the requests finished DURING this iteration."""
        sched = self.scheduler
        finished = sched.sweep_deadlines()
        for request in finished:
            self.observability.note_deadline(request)
        finished.extend(self._sweep_finished())
        while not self._draining:
            request = sched.try_admit()
            if request is None:
                break
            try:
                self._run_prefill(request)
            except BaseException:
                # a prefill that raises after admission must not strand
                # the slot + block grant it was just handed: release
                # everything and surface the fault
                sched.abort(request)
                raise
        # a prefill can already satisfy a request (max_new_tokens=1, or
        # the prefill token IS eos): sweep before decoding, else the
        # slot advances one token past its contract
        finished.extend(self._sweep_finished())
        if sched.active_count:
            self._decode_once()
            if self.decode_iterations % self.steps_per_print == 0:
                logger.info("decode iteration %d: %d active, %d queued, "
                            "%d free blocks", self.decode_iterations,
                            sched.active_count, sched.queue_depth,
                            self.allocator.free_blocks)
        if (self.decode_iterations
                and self.decode_iterations % self.steps_per_print == 0):
            self._sample_telemetry()
            self._sample_integrity()
        return finished

    def run(self):
        """Drain the queue: iterate until every submitted request has
        finished; returns ``{request_id: result dict}`` (tokens, finish
        reason, TTFT, per-token p50/p99)."""
        while not self.scheduler.idle():
            self.step()
        # final sweep: the last decode's tokens may have finished slots
        self._sweep_finished()
        self._sample_telemetry()
        return {rid: r.result() for rid, r in self._results.items()}

    # ------------------------------------------------------------------
    # receipts
    # ------------------------------------------------------------------
    def comm_receipt(self):
        """Collective receipt of ONE decode iteration (count, payload and
        wire bytes; JAX ``engine.py:496``); None until the first decode
        was recorded or with the ledger off."""
        return self.comm_ledger.step_entry(1, prefer=DECODE_PROGRAM)

    def overlap_receipt(self):
        """Exposed-wire verdict of the decode program; None until it is
        recorded."""
        return self.comm_ledger.step_overlap(1, prefer=DECODE_PROGRAM)

    def attribution_receipt(self):
        """Reconciled budget of one decode iteration (compute, exposed
        wire, host driver) beside the measured p50 of the iteration's
        wall time (JAX ``engine.py:507``).  The driver phase is the host
        bracket's min over the window beyond the predicted device time,
        as in :meth:`~deepspeed_tpu_torch.runtime.engine.DeepSpeedEngine.attribution_receipt`:
        a host-paced decode shows it large."""
        from ..profiling import attribution as attr_prof

        if not self.comm_ledger.enabled:
            return None
        entries = self.comm_ledger.overlap_entries()
        budget = attr_prof.step_budget(entries, 1, prefer=DECODE_PROGRAM)
        if budget is None:
            return None
        vals = self._driver_latencies.recent()
        bracket = float(min(vals)) if vals else 0.0
        budget = attr_prof.step_budget(
            entries, 1, prefer=DECODE_PROGRAM,
            driver_seconds=max(0.0, bracket
                               - budget["predicted_step_seconds"]))
        snap = self._step_latencies.latency_snapshot()
        receipt = attr_prof.reconcile(budget,
                                      snap["p50"] if snap["n"] else None)
        receipt["driver_bracket_seconds"] = bracket
        return receipt

    def program_verify_context(self):
        """The context of the ``programs/`` sidecars (JAX
        ``engine.py:523``): one replica (a 1-wide data axis), the
        weights' bytes, no host stream and no bucketed exchange."""
        return {
            "mesh_axes": {"data": 1},
            "data_axis": "data",
            "param_bytes": int(sum(t.numel() * t.element_size()
                                   for t in tree_leaves(self.params)[1])),
            "host_state_wire_bytes": None,
            "host_stream_schedule": None,
            "collective_schedule": None,
            "device_kind": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda"
                            else self.device.type),
        }

    def serving_receipt(self):
        """Aggregate serve metrics over every finished request, the
        observability plane's occupancy/SLO receipt (goodput re-based
        onto the throughput's wall clock, as in JAX), the port's
        TTFT p99 and decode-only per-token p50/p99
        (:func:`~deepspeed_tpu_torch.inference.observability.latency_receipt`:
        ``per_token_*`` pools each request's TTFT with its decode
        tokens), and ``flash_fwd_launches``: the flash kernel's launch
        counter (all launches in this process since the counter was last
        reset)."""
        finished = [r for r in self._results.values()
                    if r.state == "finished"]
        lats = sorted(t for r in finished for t in r.step_times)
        ttfts = sorted(r.first_token_at - r.submitted for r in finished
                       if r.first_token_at is not None)

        def pct(vals, p):
            if not vals:
                return None
            return float(vals[min(len(vals) - 1, int(p * len(vals)))])

        wall = None
        if finished:
            start = min(r.submitted for r in finished)
            end = max(r.finished_at for r in finished)
            wall = max(end - start, 1e-9)
        receipt = {
            "requests": len(finished),
            "generated_tokens": self.generated_tokens,
            "decode_iterations": self.decode_iterations,
            "per_token_p50_seconds": pct(lats, 0.50),
            "per_token_p99_seconds": pct(lats, 0.99),
            "ttft_p50_seconds": pct(ttfts, 0.50),
            "tokens_per_second_per_chip": (
                self.generated_tokens / wall if wall else None),
            "flash_fwd_launches": flash_attention_fwd.launches,
            "programs_compiled": len(self.memory_ledger.entries()),
        }
        obs = self.observability.receipt()
        receipt.update(obs)
        receipt["goodput_tokens_per_second"] = (
            obs["goodput_tokens"] / wall if wall else None)
        split = latency_receipt(finished)
        receipt.update(
            ttft_p99_seconds=split["ttft_p99_seconds"],
            decode_per_token_p50_seconds=split[
                "decode_per_token_p50_seconds"],
            decode_per_token_p99_seconds=split[
                "decode_per_token_p99_seconds"])
        return receipt

    # ------------------------------------------------------------------
    # health plane and shutdown
    # ------------------------------------------------------------------
    def attach_health(self, health):
        """Arm the serving health plane (a
        :class:`~deepspeed_tpu_torch.inference.resilience.ServingHealth`:
        heartbeats per decode iteration and the weight-fingerprint
        consensus on the print cadence) and start its peer monitor.
        Adds no host sync: the fingerprint rides the decode loop's
        next-token fetch."""
        self._health = health
        health.start()
        return health

    def drain(self, deadline_secs=None):
        """Stop admission and finish the in-flight decodes up to a
        bounded deadline (``DS_TERM_DRAIN_DEADLINE_SECS`` contract;
        ``<= 0`` drains unbounded).  Queued-but-unadmitted requests
        stay queued for a router to requeue elsewhere.  Returns the
        requests that finished during the drain."""
        self._draining = True
        if deadline_secs is None:
            deadline_secs = drain_deadline_secs()
        deadline = (time.monotonic() + float(deadline_secs)
                    if deadline_secs and float(deadline_secs) > 0
                    else None)
        self.telemetry.emit(
            TEL.EVENT_SERVING, step=self.decode_iterations, kind="drain",
            active=self.scheduler.active_count,
            queued=self.scheduler.queue_depth,
            deadline_secs=(float(deadline_secs)
                           if deadline is not None else None))
        drained = []
        while self.scheduler.active_count:
            if deadline is not None and time.monotonic() >= deadline:
                logger.warning(
                    "serving drain hit the %.1fs deadline with %d "
                    "request(s) still decoding; abandoning them",
                    float(deadline_secs), self.scheduler.active_count)
                break
            drained.extend(self.step())
        drained.extend(self._sweep_finished())
        return drained

    def close(self, reason="serve_done"):
        """Stop admission, drain the in-flight decodes up to the bounded
        deadline, stop the health plane, then flush and close telemetry (whose close writes the
        ``run_end`` event).  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.scheduler.active_count:
            self.drain()
        self._draining = True
        if self._health is not None:
            self._health.stop()
        self.telemetry.close(reason=reason)
