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

Not ported in this slice (the JAX engine's observability and resilience
planes): memory/comm ledgers, program dumps and verification, the
comm/overlap/attribution receipts, telemetry, serving observability,
the health plane and the front-end.
"""

import logging
import os
import time

import torch

from ..ops.transformer.flash_attention import flash_attention_fwd
from ..runtime import constants as C
from ..utils.params import params_from_numpy
from .config import DeepSpeedInferenceConfig
from .kv_cache import BlockAllocator, init_kv_cache
from .model import build_decode, build_prefill
from .scheduler import ContinuousBatchScheduler, Request

logger = logging.getLogger(__name__)


def resolve_device(device):
    """``None`` means the card: ``cuda``, or an error when there is none.
    The engine never drops to the CPU on its own; pass ``"cpu"`` to ask."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceEngine runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to serve on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def drain_deadline_secs():
    """Bounded-drain deadline under the ``DS_TERM_DRAIN_DEADLINE_SECS``
    contract (port of ``inference/resilience.py:328``): an explicit value
    wins, ``<= 0`` disables the bound, otherwise 90% of the kill grace
    (``DS_TERM_GRACE_SECS``, default 30 s)."""
    try:
        grace = float(os.environ.get("DS_TERM_GRACE_SECS", "30"))
    except ValueError:
        grace = 30.0
    raw = os.environ.get("DS_TERM_DRAIN_DEADLINE_SECS", "")
    try:
        return float(raw) if raw else grace * 0.9
    except ValueError:
        logger.warning("DS_TERM_DRAIN_DEADLINE_SECS=%r is not a number; "
                       "using the default (90%% of the kill grace)", raw)
        return grace * 0.9


class InferenceEngine:
    """Serve a GPT-2 family model with continuous batching.

    ``model`` is a :class:`~deepspeed_tpu_torch.models.gpt2.GPT2LMHead`
    (or anything exposing ``.config`` with the same geometry fields);
    ``params`` its param dict, with numpy or tensor leaves (use
    :func:`~deepspeed_tpu_torch.module_inject.ingest_gpt2_model` for an
    HF checkpoint).  ``config`` is the usual DeepSpeed config dict; the
    ``inference`` block's keys are checked against the known ones.
    ``device=None`` serves on CUDA and raises without it."""

    def __init__(self, model, params, config=None, device=None):
        param_dict = dict(config or {})
        self.inference_config = DeepSpeedInferenceConfig(param_dict)
        icfg = self.inference_config
        self._validate_config(param_dict, icfg)
        self.device = resolve_device(device)
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
        self.decode_iterations = 0
        self.generated_tokens = 0
        self._results = {}
        self._next_request_id = 0
        self._draining = False
        self._closed = False
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
    def _validate_config(param_dict, icfg):
        """Unknown keys in the ``inference`` block (and its ``slo``
        sub-block) warn, or raise under ``strict_config``.  So do the
        knobs of features this engine does not serve yet, each on when
        its knob is non-zero: load shedding and degradation (the JAX
        package's ``inference/frontend.py``; ``degraded_max_new_tokens``
        acts only under ``degrade_queue_depth``) and SLO goodput
        (``inference/observability.py``).  ROADMAP A12 ports them."""
        strict = bool(param_dict.get(C.STRICT_CONFIG,
                                     C.STRICT_CONFIG_DEFAULT))
        inf = param_dict.get(C.INFERENCE) or {}
        issues = [f"unknown key '{C.INFERENCE}.{k}'"
                  for k in inf if k not in C.INFERENCE_KEYS]
        slo = inf.get(C.INFERENCE_SLO) or {}
        issues += [f"unknown key '{C.INFERENCE}.{C.INFERENCE_SLO}.{k}'"
                   for k in slo if k not in C.INFERENCE_SLO_KEYS]
        slo_key = f"{C.INFERENCE_SLO}."
        for key, value, feature in (
                (C.INFERENCE_MAX_QUEUE_DEPTH, icfg.max_queue_depth,
                 "load shedding"),
                (C.INFERENCE_DEGRADE_QUEUE_DEPTH, icfg.degrade_queue_depth,
                 "graceful degradation"),
                (slo_key + C.INFERENCE_SLO_TTFT_MS, icfg.slo_ttft_ms,
                 "SLO goodput"),
                (slo_key + C.INFERENCE_SLO_PER_TOKEN_MS,
                 icfg.slo_per_token_ms, "SLO goodput")):
            if value:
                issues.append(
                    f"'{C.INFERENCE}.{key}' = {value} asks for {feature}, "
                    "which this engine does not implement yet (ROADMAP "
                    "A12, serving remainder); the setting has no effect")
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
        (0 = no deadline); ``trace_id`` is carried on the request."""
        if self._draining:
            raise RuntimeError(
                "InferenceEngine is draining (close()/SIGTERM): "
                "admission is stopped; route this request elsewhere")
        if request_id is None:
            request_id = f"req-{self._next_request_id}"
            self._next_request_id += 1
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

    @torch.no_grad()
    def _decode_once(self):
        """One continuous-batch decode iteration over the active slots,
        with one host sync: the next-token fetch."""
        sched = self.scheduler
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
        t0 = time.monotonic()
        next_dev = self._decode(self.params, self._k_cache, self._v_cache,
                                self._to_device("tables"),
                                self._to_device("ctx_lens"),
                                self._to_device("tokens"))
        next_tokens = next_dev.tolist()  # the iteration's one host sync
        now = time.monotonic()
        self.decode_iterations += 1
        for request in before:
            request.generated.append(int(next_tokens[request.slot]))
            request.step_times.append(now - t0)
            self.generated_tokens += 1

    def step(self):
        """One engine iteration: expire deadlines, recycle finished
        slots, admit from the queue (each admission prefills
        immediately), then advance every active slot one token.
        Returns the requests finished DURING this iteration."""
        sched = self.scheduler
        eos = self.inference_config.eos_token_id
        finished = sched.sweep_deadlines()
        finished.extend(sched.sweep_finished(eos))
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
        finished.extend(sched.sweep_finished(eos))
        if sched.active_count:
            self._decode_once()
            if self.decode_iterations % self.steps_per_print == 0:
                logger.info("decode iteration %d: %d active, %d queued, "
                            "%d free blocks", self.decode_iterations,
                            sched.active_count, sched.queue_depth,
                            self.allocator.free_blocks)
        return finished

    def run(self):
        """Drain the queue: iterate until every submitted request has
        finished; returns ``{request_id: result dict}`` (tokens, finish
        reason, TTFT, per-token p50/p99)."""
        while not self.scheduler.idle():
            self.step()
        # final sweep: the last decode's tokens may have finished slots
        self.scheduler.sweep_finished(self.inference_config.eos_token_id)
        return {rid: r.result() for rid, r in self._results.items()}

    # ------------------------------------------------------------------
    # receipts
    # ------------------------------------------------------------------
    def serving_receipt(self):
        """Aggregate serve metrics over every finished request, plus
        ``flash_fwd_launches``: the flash kernel's launch counter (all
        launches in this process since the counter was last reset)."""
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
        return {
            "requests": len(finished),
            "generated_tokens": self.generated_tokens,
            "decode_iterations": self.decode_iterations,
            "per_token_p50_seconds": pct(lats, 0.50),
            "per_token_p99_seconds": pct(lats, 0.99),
            "ttft_p50_seconds": pct(ttfts, 0.50),
            "tokens_per_second_per_chip": (
                self.generated_tokens / wall if wall else None),
            "flash_fwd_launches": flash_attention_fwd.launches,
        }

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
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
        drained = []
        while self.scheduler.active_count:
            if deadline is not None and time.monotonic() >= deadline:
                logger.warning(
                    "serving drain hit the %.1fs deadline with %d "
                    "request(s) still decoding; abandoning them",
                    float(deadline_secs), self.scheduler.active_count)
                break
            drained.extend(self.step())
        drained.extend(self.scheduler.sweep_finished(
            self.inference_config.eos_token_id))
        return drained

    def close(self):
        """Stop admission and drain the in-flight decodes up to the
        bounded deadline.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.scheduler.active_count:
            self.drain()
        self._draining = True
