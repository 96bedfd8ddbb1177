"""The port's multi-replica serving front-end
(``deepspeed_tpu_torch/inference/frontend.py``) against the JAX
package's, two replicas in each, on the CPU (the JAX
``tests/unit/test_serving_frontend.py:270-447`` on both packages).

- Round robin: every request completes on the replica it was routed to,
  with tokens equal to the JAX front-end's and to the port's naive
  reference, and both replicas serve.
- Shedding: a burst at ``max_queue_depth`` sheds the same request ids
  with :class:`ServingOverloadError` in both packages; degradation past
  ``degrade_queue_depth`` caps the same requests to the same lengths.
- Requeue: a replica marked dead after k front-end iterations (k = 0, 2,
  4) has its in-flight requests re-served exactly once on the survivor,
  with tokens equal to the unkilled run's and to the JAX front-end's
  under the same kill; the dead replica's allocator stays conserved.
- A replica that raises mid-step is evicted; a result finished before a
  death is delivered, not recomputed; a front-end with no live replica
  refuses loudly; an expired deadline is counted.

The JAX replicas are built once (each compiles its prefill and decode
programs) and serve every JAX scenario through a fresh front-end, with
request ids unique per scenario.
"""

import time

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import ServingFrontend as JFrontend
from deepspeed_tpu.inference import ServingOverloadError as JOverload
from deepspeed_tpu_torch.inference import (InferenceEngine,
                                           ServingFrontend,
                                           ServingOverloadError,
                                           reference_generate)
from deepspeed_tpu_torch.inference.scheduler import FINISHED
from deepspeed_tpu_torch.utils.params import params_from_numpy

from .test_torch_inference import models, seeded_prompts  # noqa: F401
from .test_torch_inference import serve_config

# one config for every scenario, JAX and port: shedding at 8 queued,
# degradation to 2 tokens from 6 queued (the round-robin scenarios queue
# at most 5)
FLEET = dict(max_queue_depth=8, degrade_queue_depth=6,
             degraded_max_new_tokens=2)
KILL_STEPS = (0, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_fleet(models, n=2, **overrides):
    _, model, params = models
    config = serve_config(**dict(FLEET, **overrides))
    return [InferenceEngine(model, params, config=config, device="cpu")
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_fleet(models):
    jmodel, _, params = models
    return [JEngine(jmodel, jax.tree_util.tree_map(np.asarray, params),
                    config=serve_config(**FLEET)) for _ in range(2)]


def serve(frontend_cls, replicas, prompts, prefix, max_new_tokens=4,
          kill_after=None):
    """Submit ``prompts`` (ids ``prefix``-i), mark replica 0 dead after
    ``kill_after`` front-end iterations (None: never), run to the end.
    Returns ({index: tokens}, the front-end)."""
    fe = frontend_cls(replicas)
    rids = [fe.submit(p, max_new_tokens=max_new_tokens,
                      request_id=f"{prefix}-{i}")
            for i, p in enumerate(prompts)]
    if kill_after is not None:
        for _ in range(kill_after):
            fe.step()
        fe.mark_dead(0)
    results = fe.run()
    assert set(results) == set(rids), "lost or duplicated work"
    return {i: results[r]["tokens"] for i, r in enumerate(rids)}, fe


def test_round_robin_completion_and_parity(models, jax_fleet):
    _, model, params = models
    prompts = seeded_prompts(5, seed=51)
    replicas = port_fleet(models)
    tokens, fe = serve(ServingFrontend, replicas, prompts, "rr")
    jtokens, _ = serve(JFrontend, jax_fleet, prompts, "rr")
    assert tokens == jtokens
    for i, p in enumerate(prompts):
        assert tokens[i] == reference_generate(
            model, params_from_numpy(params, "cpu"), p, 4)
    assert all(e.generated_tokens > 0 for e in replicas)
    assert fe.resilience_receipt()["completed_requests"] == 5


def burst(frontend_cls, overload_cls, replicas, prompts, prefix):
    """Submit every prompt without stepping; returns (shed indices,
    admitted {index: id}, the front-end)."""
    fe = frontend_cls(replicas)
    shed, admitted = [], {}
    for i, p in enumerate(prompts):
        try:
            admitted[i] = fe.submit(p, max_new_tokens=6,
                                    request_id=f"{prefix}-{i}")
        except overload_cls as e:
            assert e.max_queue_depth == 8 and e.queue_depth == 8
            shed.append(i)
    return shed, admitted, fe


def test_shedding_and_degradation_match_the_jax_front_end(models,
                                                          jax_fleet):
    """12 submits at once on two replicas: the first 6 get their full
    cap, the next 2 are degraded to 2 tokens, the last 4 are shed — the
    same ids and lengths in both packages; the admitted finish."""
    prompts = seeded_prompts(12, seed=52)
    out = {}
    for name, cls, overload, replicas in (
            ("port", ServingFrontend, ServingOverloadError,
             port_fleet(models)),
            ("jax", JFrontend, JOverload, jax_fleet)):
        shed, admitted, fe = burst(cls, overload, replicas, prompts, "shed")
        results = fe.run()
        out[name] = (shed, {i: results[r]["tokens"]
                            for i, r in admitted.items()},
                     fe.resilience_receipt())
    assert out["port"][0] == out["jax"][0] == [8, 9, 10, 11]
    assert out["port"][1] == out["jax"][1]
    assert [len(out["port"][1][i]) for i in range(8)] == [6] * 6 + [2, 2]
    for key in ("shed_requests", "degraded_requests", "completed_requests"):
        assert out["port"][2][key] == out["jax"][2][key]


@pytest.fixture(scope="module")
def unkilled(models):
    prompts = seeded_prompts(4, seed=61)
    tokens, _ = serve(ServingFrontend, port_fleet(models), prompts, "ref",
                      max_new_tokens=8)
    return prompts, tokens


@pytest.mark.parametrize("k", KILL_STEPS)
def test_dead_replica_requeue_is_token_identical(models, jax_fleet,
                                                 unkilled, k):
    """Replica 0 dies after k iterations: its in-flight requests are
    re-served once on the survivor; the tokens equal the unkilled run's
    and the JAX front-end's under the same kill."""
    prompts, reference = unkilled
    replicas = port_fleet(models)
    tokens, fe = serve(ServingFrontend, replicas, prompts, f"k{k}",
                       max_new_tokens=8, kill_after=k)
    jtokens, jfe = serve(JFrontend, jax_fleet, prompts, f"k{k}",
                         max_new_tokens=8, kill_after=k)
    assert tokens == reference, f"k={k}: a requeued request diverged"
    assert tokens == jtokens
    receipt, jreceipt = fe.resilience_receipt(), jfe.resilience_receipt()
    assert receipt["requeued_requests"] == jreceipt["requeued_requests"] > 0
    assert receipt["dead_replicas"] == 1
    assert receipt["recovery_latency_seconds"] is not None
    # the dead replica's aborts returned every grant to its own pool
    assert replicas[0].allocator.free_blocks \
        == replicas[0].inference_config.kv_blocks - 1
    assert all(r.requeues <= 1 for r in fe._delivered.values())


def test_replica_that_raises_mid_step_is_evicted(models):
    _, model, params = models
    replicas = port_fleet(models)
    fe = ServingFrontend(replicas)
    prompts = seeded_prompts(4, seed=55)
    rids = [fe.submit(p, max_new_tokens=4) for p in prompts]
    fe.step()

    def explode():
        raise RuntimeError("chaos: replica wedged")

    replicas[0].step = explode
    results = fe.run()
    assert set(results) == set(rids)
    assert fe.live_replicas() == [1]
    for rid, p in zip(rids, prompts):
        assert results[rid]["tokens"] == reference_generate(
            model, params_from_numpy(params, "cpu"), p, 4)


def test_finished_results_survive_the_death_unrecomputed(models):
    fe = ServingFrontend(port_fleet(models))
    rids = [fe.submit(p, max_new_tokens=2)
            for p in seeded_prompts(2, seed=56)]
    while fe._owner:
        fe.step()
    delivered = {rid: list(fe.results()[rid]["tokens"]) for rid in rids}
    fe.mark_dead(0)
    assert fe.requeued_total == 0          # nothing was in flight
    assert {rid: r["tokens"] for rid, r in fe.results().items()} \
        == delivered


def test_no_live_replicas_is_loud(models):
    fe = ServingFrontend(port_fleet(models, n=1))
    fe.mark_dead(0)
    with pytest.raises(RuntimeError, match="no live replicas"):
        fe.submit(seeded_prompts(1, seed=57)[0], max_new_tokens=2)


def test_deadline_counted_in_receipt(models):
    fe = ServingFrontend(port_fleet(models, n=1))
    fe.submit(seeded_prompts(1, seed=58)[0], max_new_tokens=8,
              deadline_ms=1)
    fe.step()
    time.sleep(0.01)
    results = fe.run()
    assert fe.resilience_receipt()["deadline_expired"] == 1
    assert next(iter(results.values()))["finish_reason"] == "deadline"


def test_fleet_serving_receipt_splits_ttft_from_decode(models):
    """The port's pooled fleet receipt: TTFT and decode-only per-token
    quantiles over the delivered requests (a requeued one counted once),
    and an impossible per-token target leaves only the first tokens in
    goodput."""
    prompts = seeded_prompts(4, seed=62)
    _, fe = serve(ServingFrontend,
                  port_fleet(models, slo={"per_token_ms": 1e-4}), prompts,
                  "slo", kill_after=2)
    receipt = fe.serving_receipt()
    assert receipt["completed_requests"] == 4
    assert receipt["delivered_tokens"] == 16
    assert receipt["delivered_goodput_tokens"] == 4
    assert receipt["delivered_slo_attainment"] == 0.25
    requests = list(fe._delivered.values())
    decode = sorted(t for r in requests for t in r.step_times[1:])
    ttfts = sorted(r.step_times[0] for r in requests)
    assert receipt["decode_per_token_p99_seconds"] == decode[
        min(len(decode) - 1, int(0.99 * len(decode)))]
    assert receipt["ttft_p99_seconds"] == ttfts[-1]
    assert all(r.state == FINISHED for r in requests)
