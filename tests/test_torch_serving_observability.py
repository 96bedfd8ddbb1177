"""The port's serving observability plane
(``deepspeed_tpu_torch/inference/observability.py``) against the JAX
package's, on the CPU (the JAX
``tests/unit/test_serving_observability.py:113-300`` on both packages).

- P² streaming quantiles: convergence on a heavy tail, exact below five
  observations, the count-weighted merge across windows.
- The lifecycle records of a two-replica serve with one replica death,
  in each package: every record carries the JAX ``SERVING_PHASE_KEYS``
  and passes the JAX ``validate_event``; a requeued request is one
  joined trace (one submit, two lives, one finish); each request's
  sequence of record kinds is the JAX run's; the decode-window and SLO
  records come at the cadence; each package's report renders the
  other's serving run dir.
- The receipts: the deterministic occupancy, budget, KV and padding
  fields are equal to the JAX engine's on the same run; without an SLO
  goodput is raw throughput; an impossible SLO zeroes it; the port's
  TTFT and decode-only per-token quantiles are separate streams.
- The front-end's fleet gauges at the print cadence.
"""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import SERVING_PHASE_KEYS as J_PHASE_KEYS
from deepspeed_tpu.inference import SERVING_TRACE_SCHEMA_VERSION as J_SCHEMA
from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import ServingFrontend as JFrontend
from deepspeed_tpu.telemetry import events as jev
from deepspeed_tpu.telemetry import report as jreport
from deepspeed_tpu_torch.inference import (SERVING_PHASE_KEYS,
                                           SERVING_TRACE_SCHEMA_VERSION,
                                           BlockAllocator, InferenceEngine,
                                           ServingFrontend, latency_receipt)
from deepspeed_tpu_torch.telemetry import report as treport
from deepspeed_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                    P2Quantile,
                                                    StreamingQuantiles)

from .test_torch_inference import models, seeded_prompts  # noqa: F401
from .test_torch_inference import serve_config

# the receipt fields that depend on the schedule alone, not on clocks
DETERMINISTIC = ("requests", "generated_tokens", "decode_iterations",
                 "batch_occupancy_mean", "token_budget_utilization",
                 "kv_block_occupancy_peak", "padding_waste_fraction",
                 "slo_enabled")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- P²
@pytest.mark.parametrize("p,tol", [(0.5, 0.05), (0.9, 0.05), (0.99, 0.10)])
def test_p2_converges_on_a_heavy_tail(p, tol):
    samples = np.random.default_rng(7).lognormal(-7.0, 1.0, size=20000)
    est = P2Quantile(p)
    for s in samples:
        est.observe(float(s))
    assert est.count == len(samples)
    assert est.value == pytest.approx(float(np.quantile(samples, p)),
                                      rel=tol)


def test_p2_exact_until_five_and_merges_by_count():
    est = P2Quantile(0.5)
    for v in (3.0, 1.0, 2.0):
        est.observe(v)
    assert est.value == 2.0
    big, small = P2Quantile(0.5), P2Quantile(0.5)
    rng = np.random.default_rng(3)
    for _ in range(9900):
        big.observe(1.0 + rng.normal() * 0.01)
    for _ in range(100):
        small.observe(100.0 + rng.normal())
    assert P2Quantile.merged_estimate(0.5, [big, small]) == pytest.approx(
        1.0, abs=0.1)
    assert P2Quantile.merged_estimate(0.5, [P2Quantile(0.5)]) == 0.0


def test_streaming_quantiles_snapshot_shape():
    reg = MetricsRegistry()
    q = reg.quantiles("serving/per_token_seconds")
    assert isinstance(q, StreamingQuantiles)
    for v in (0.001, 0.002, 0.004):
        q.observe(v)
    snap = q.snapshot()
    assert snap["kind"] == "quantiles" and snap["count"] == 3
    assert snap["sum"] == pytest.approx(0.007)
    assert snap["min"] == 0.001 and snap["max"] == 0.004
    assert {"mean", "p50", "p90", "p99"} <= set(snap)
    assert reg.quantiles("serving/per_token_seconds") is q


# ------------------------------------------- the joined-trace serve run
def requeue_config(run_dir):
    config = serve_config(slo={"ttft_ms": 60000, "per_token_ms": 60000})
    config["steps_per_print"] = 2
    config["telemetry"] = {"enabled": True, "run_dir": str(run_dir)}
    return config


@pytest.fixture(scope="module")
def requeue_runs(models, tmp_path_factory):
    """A two-replica serve with replica 0 dead after 2 iterations, in
    both packages: {package: (results, serving payloads, run dir,
    replica 1's receipt)}."""
    jmodel, model, params = models
    out = {}
    for name in ("jax", "port"):
        run_dir = tmp_path_factory.mktemp(f"serve_{name}")
        if name == "jax":
            replicas = [JEngine(jmodel,
                                jax.tree_util.tree_map(np.asarray, params),
                                config=requeue_config(run_dir))
                        for _ in range(2)]
            frontend = JFrontend(replicas)
        else:
            replicas = [InferenceEngine(model, params,
                                        config=requeue_config(run_dir),
                                        device="cpu") for _ in range(2)]
            frontend = ServingFrontend(replicas)
        for i, p in enumerate(seeded_prompts(4, seed=21)):
            frontend.submit(p, max_new_tokens=4, request_id=f"r{i}")
        for _ in range(2):
            frontend.step()
        frontend.mark_dead(0)
        results = frontend.run()
        receipt = replicas[1].serving_receipt()
        for engine in replicas:
            engine.close()
        records = jev.read_events(str(run_dir))
        payloads = [dict(r["data"]) for r in records
                    if r["type"] == jev.EVENT_SERVING]
        out[name] = (results, payloads, str(run_dir), receipt, records)
    return out


def test_phase_table_is_the_jax_one():
    assert SERVING_PHASE_KEYS == J_PHASE_KEYS
    assert SERVING_TRACE_SCHEMA_VERSION == J_SCHEMA


def test_every_port_record_validates_against_the_jax_tables(requeue_runs):
    _, payloads, _, _, records = requeue_runs["port"]
    for r in records:
        assert jev.validate_event(r) == [], r
    lifecycle = [d for d in payloads if d.get("kind") in J_PHASE_KEYS]
    assert lifecycle
    for d in lifecycle:
        missing = [k for k in J_PHASE_KEYS[d["kind"]] if k not in d]
        assert not missing, f"{d['kind']} record missing {missing}: {d}"
        assert d["schema"] == J_SCHEMA and d["t_mono"] > 0


def kinds_by_request(payloads):
    out = {}
    for d in payloads:
        if "request" in d:
            out.setdefault(d["request"], []).append(d["kind"])
    return out


def test_requeued_request_is_one_joined_trace(requeue_runs):
    results, payloads, _, _, _ = requeue_runs["port"]
    assert len(results) == 4
    by_trace = {}
    for d in payloads:
        if "trace" in d:
            by_trace.setdefault(d["trace"], []).append(d)
    requeued = [[d["kind"] for d in recs] for recs in by_trace.values()
                if any(d["kind"] == "requeue" for d in recs)]
    assert requeued, "no requeued trace in the run"
    for kinds in requeued:
        assert kinds.count("submit") == 1
        assert kinds.count("admit") == kinds.count("first_token") == 2
        assert kinds[-1] == "finish"
        assert kinds.index("requeue") > kinds.index("admit")
    for recs in by_trace.values():
        stamps = [d["t_mono"] for d in recs]
        assert stamps == sorted(stamps)
    traces = set(by_trace)
    for result in results.values():
        assert result["trace_id"] in traces
        assert result["admission_wait_seconds"] >= 0
    # each request's record kinds, and the tokens, are the JAX run's
    jresults, jpayloads, _, _, _ = requeue_runs["jax"]
    assert kinds_by_request(payloads) == kinds_by_request(jpayloads)
    assert {k: r["tokens"] for k, r in results.items()} == \
        {k: r["tokens"] for k, r in jresults.items()}


def test_decode_window_and_slo_records_at_cadence(requeue_runs):
    _, payloads, _, _, _ = requeue_runs["port"]
    windows = [d for d in payloads if d.get("kind") == "decode_window"]
    slos = [d for d in payloads if d.get("kind") == "slo"]
    jwindows = [d for d in requeue_runs["jax"][1]
                if d.get("kind") == "decode_window"]
    assert windows and slos and len(windows) == len(jwindows)
    for w, jw in zip(windows, jwindows):
        assert 0 < w["batch_occupancy"] <= 1.0
        assert 0 <= w["token_budget_utilization"] <= 1.0
        assert w["kv_used_peak"] >= w["kv_used_blocks"] >= 0
        for key in ("iterations", "tokens", "batch_occupancy",
                    "token_budget_utilization", "kv_used_blocks",
                    "kv_used_peak"):
            assert w[key] == jw[key], key
    for s in slos:
        assert 0 <= s["slo_attainment"] <= 1.0
        assert s["goodput_tokens"] <= s["window_tokens"]


def test_receipt_deterministic_fields_equal_jax(requeue_runs):
    receipt, jreceipt = requeue_runs["port"][3], requeue_runs["jax"][3]
    for key in DETERMINISTIC:
        assert receipt[key] == pytest.approx(jreceipt[key]), key
    assert receipt["slo_attainment"] == jreceipt["slo_attainment"] == 1.0


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_report_renders_the_others_serving_run(reader, requeue_runs):
    mod = treport if reader == "port" else jreport
    run_dir = requeue_runs["jax" if reader == "port" else "port"][2]
    text, records = mod.generate_report(run_dir, serving=True)
    assert records and "schema problems" not in text
    for needle in ("serving resilience", "requeue=", "4 trace(s)",
                   "occupancy windows", "SLO:", "-> finish"):
        assert needle in text, f"report missing {needle!r}:\n{text}"


# ------------------------------------------------------------- receipts
def test_receipt_fields_sane_without_slo(models, tmp_path):
    _, model, params = models
    config = serve_config()
    config["telemetry"] = {"enabled": True, "run_dir": str(tmp_path)}
    engine = InferenceEngine(model, params, config=config, device="cpu")
    for i, p in enumerate(seeded_prompts(4, seed=33)):
        engine.submit(p, max_new_tokens=4, request_id=f"r{i}")
    engine.run()
    receipt = engine.serving_receipt()
    engine.close()
    assert 0 < receipt["batch_occupancy_mean"] <= 1.0
    assert 0 < receipt["token_budget_utilization"] <= 1.0
    assert 0 < receipt["kv_block_occupancy_peak"] <= 1.0
    assert 0 <= receipt["padding_waste_fraction"] < 1.0
    assert not receipt["slo_enabled"] and receipt["slo_attainment"] == 1.0
    assert receipt["goodput_tokens"] == receipt["generated_tokens"]
    assert receipt["goodput_tokens_per_second"] == pytest.approx(
        receipt["tokens_per_second_per_chip"])
    # the decode-only stream leaves the first tokens out of per-token
    assert receipt["decode_per_token_p99_seconds"] \
        <= receipt["per_token_p99_seconds"]
    assert receipt["ttft_p99_seconds"] >= receipt["ttft_p50_seconds"]


def test_impossible_slo_zeroes_goodput(models, tmp_path):
    _, model, params = models
    config = serve_config(slo={"ttft_ms": 0.0001, "per_token_ms": 0.0001})
    config["telemetry"] = {"enabled": True, "run_dir": str(tmp_path)}
    engine = InferenceEngine(model, params, config=config, device="cpu")
    for i, p in enumerate(seeded_prompts(3, seed=34)):
        engine.submit(p, max_new_tokens=4, request_id=f"r{i}")
    engine.run()
    receipt = engine.serving_receipt()
    engine.close()
    assert receipt["slo_enabled"]
    assert receipt["slo_attainment"] == 0.0
    assert receipt["goodput_tokens"] == 0
    assert receipt["tokens_per_second_per_chip"] > 0
    slos = [r["data"] for r in jev.read_events(str(tmp_path))
            if r["type"] == "serving" and r["data"]["kind"] == "slo"]
    assert slos and all(s["goodput_tokens"] == 0 for s in slos)


def test_latency_receipt_splits_ttft_from_decode():
    class R:
        def __init__(self, times):
            self.step_times = times

    requests = [R([0.5, 0.01, 0.02]), R([0.7, 0.03]), R([])]
    out = latency_receipt(requests, slo_ttft_ms=600, slo_per_token_ms=25)
    assert out["ttft_p50_seconds"] == 0.7 and out["ttft_p99_seconds"] == 0.7
    assert out["decode_per_token_p50_seconds"] == 0.02
    assert out["decode_per_token_p99_seconds"] == 0.03
    assert out["delivered_tokens"] == 5
    assert out["delivered_goodput_tokens"] == 3       # 0.5, 0.01, 0.02
    assert out["delivered_slo_attainment"] == 0.6
    assert latency_receipt([])["delivered_slo_attainment"] == 1.0


def test_kv_allocator_peak_tracks_high_water():
    alloc = BlockAllocator(16)
    first = alloc.allocate(6)
    assert alloc.used_peak == 6
    alloc.release(first)
    assert alloc.used_blocks == 0 and alloc.used_peak == 6
    alloc.allocate(4)
    assert alloc.used_peak == 6 and alloc.capacity == 15


def test_frontend_gauges_exported_at_print_cadence(models, tmp_path):
    _, model, params = models
    config = serve_config()
    config["steps_per_print"] = 2
    config["telemetry"] = {"enabled": True, "run_dir": str(tmp_path)}
    replicas = [InferenceEngine(model, params, config=config, device="cpu")
                for _ in range(2)]
    frontend = ServingFrontend(replicas)
    for i, p in enumerate(seeded_prompts(3, seed=40)):
        frontend.submit(p, max_new_tokens=4, request_id=f"r{i}")
    frontend.step()
    registry = replicas[0].telemetry.registry
    frontend.step()       # the second step crosses the cadence
    assert registry.gauge("serving/live_replicas").value == 2.0
    frontend.mark_dead(0)
    assert len(frontend.run()) == 3
    assert registry.gauge("serving/live_replicas").value == 1.0
    assert registry.gauge("serving/queue_depth").value == 0.0
    for engine in replicas:
        engine.close()
