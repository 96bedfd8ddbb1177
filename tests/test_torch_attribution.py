"""The port's step-time attribution (``deepspeed_tpu_torch/profiling/
attribution``) against the JAX package's: every function gives the JAX
function's output on shared inputs (fused and step-wise program sets,
accumulation, the preferred program, measured latencies absent, zero and
present, a model that over-predicts, the flops cross-check's agreements
and splits, stragglers at one, two and three ranks).  Then the receipts
of the port's engines: the training engine's and the serving engine's
``attribution_receipt`` carry the JAX record's keys, its phases sum to
the measured step, and the driver phase is the host bracket beyond the
predicted device time; ``overlap_receipt`` carries the JAX receipt's
keys."""

import math

import numpy as np
import pytest

from deepspeed_tpu.profiling import attribution as jattr
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.profiling import attribution as attr

from . import torch_dp_workers as W


def summary(compute, coll=0.0, host=0.0, p2p=0.0, cp=None, by_kind=True):
    s = {"compute_seconds": compute,
         "critical_path_seconds": cp if cp is not None else compute * 1.1,
         "nodes": [{"kind": "collective", "seconds": coll * 2,
                    "hidden_seconds": coll},
                   {"kind": "host_transfer", "seconds": host,
                    "hidden_seconds": 0.0},
                   {"kind": "p2p_transfer", "seconds": p2p,
                    "hidden_seconds": 0.0}]}
    if by_kind:
        s["exposed_by_kind"] = {"collective": coll, "host_transfer": host,
                                "p2p_transfer": p2p}
    return s


ENTRY_SETS = {
    "fused": {"train_step": {"overlap": summary(3e-3, 1e-4, 2e-5)}},
    "stepwise": {"fwd_bwd": {"overlap": summary(2e-3, 1e-4, 0.0, 3e-5)},
                 "apply_update": {"overlap": summary(5e-4, 2e-5, 7e-4)},
                 "cast_params": {"overlap": summary(1e-5, 3e-6,
                                                    by_kind=False)}},
    "both": {"train_step": {"overlap": summary(3e-3)},
             "train_step_compressed": {"overlap": summary(1e-3, 5e-4)}},
    "decode": {"serve_decode": {"overlap": summary(4e-4, 0.0, 0.0)}},
    "none": {"fwd_bwd": None, "apply_update": {}},
}


@pytest.mark.parametrize("entries", list(ENTRY_SETS))
@pytest.mark.parametrize("acc", [1, 4])
@pytest.mark.parametrize("prefer", [None, "train_step_compressed"])
@pytest.mark.parametrize("driver", [0.0, 2.5e-3, -1.0])
@pytest.mark.parametrize("measured", [None, 0.0, 2e-3, 9e-3])
def test_budget_and_reconcile_are_the_jax_functions(entries, acc, prefer,
                                                    driver, measured):
    e = ENTRY_SETS[entries]
    got = attr.step_budget(e, acc, prefer=prefer, driver_seconds=driver)
    want = jattr.step_budget(e, acc, prefer=prefer, driver_seconds=driver)
    assert got == want
    if got is None:
        return
    for name in e:
        if e[name]:
            assert attr.program_budget(e[name]["overlap"]) == \
                jattr.program_budget(e[name]["overlap"])
    rec = attr.reconcile(got, measured)
    assert rec == jattr.reconcile(want, measured)
    if rec["measured_step_seconds"] is not None:
        assert math.isclose(sum(rec["phases"].values()),
                            rec["measured_step_seconds"], rel_tol=1e-12)


@pytest.mark.parametrize("flops,peak", [(0, 1e15), (2e12, 989e12),
                                        (1e9, 989e12), (5e14, 989e12),
                                        (1e12, 0.0)])
@pytest.mark.parametrize("compute", [0.0, 2e-3])
def test_flops_cross_check_is_the_jax_check(flops, peak, compute):
    budget = attr.step_budget(
        {"train_step": {"overlap": summary(compute)}})
    assert attr.flops_cross_check(budget, flops, peak) == \
        jattr.flops_cross_check(budget, flops, peak)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_straggler_explanation_is_the_jax_one(n):
    rng = np.random.default_rng(n)
    records = {}
    for rank in range(n):
        m = float(rng.uniform(1e-2, 2e-2))
        records[rank] = {"measured_step_seconds": m, "phases": {
            "driver": float(rng.uniform(0, 1e-3)),
            "unexplained": float(rng.uniform(-1e-3, 5e-3))}}
    records[n] = {"measured_step_seconds": None, "phases": {}}
    assert attr.straggler_explanation(records) == \
        jattr.straggler_explanation(records)


@pytest.mark.parametrize("values", [[], [0.0, None], [3.0, 1.0, 2.0],
                                    [1, 2, 3, 4, 5, 6, 7, 100.0]])
@pytest.mark.parametrize("window", [1, 2, 5])
def test_median_of_window_is_the_jax_estimator(values, window):
    assert attr.median_of_window(values, window) == \
        jattr.median_of_window(values, window)


def test_fresh_fleet_snapshots_is_the_jax_guard():
    fleet = {0: {"p50": 1.0, "ts": 1000.0}, 1: {"p50": 1.1, "ts": 100.0},
             2: {"p50": 1.2}, "3": {"p50": 0.9, "ts": 990.0}}
    for window in (5.0, 600.0, 1e4):
        assert attr.fresh_fleet_snapshots(fleet, window) == \
            jattr.fresh_fleet_snapshots(fleet, window)
    assert attr.fresh_fleet_snapshots({2: {"p50": 1.0}}) == \
        jattr.fresh_fleet_snapshots({2: {"p50": 1.0}})


def test_schema_constants_are_the_jax_ones():
    assert attr.PHASES == jattr.PHASES
    assert attr.ATTRIBUTION_SCHEMA_VERSION == \
        jattr.ATTRIBUTION_SCHEMA_VERSION
    assert attr.DEFAULT_MEASURED_WINDOW == jattr.DEFAULT_MEASURED_WINDOW
    assert attr.FLOPS_DISAGREEMENT_FACTOR == \
        jattr.FLOPS_DISAGREEMENT_FACTOR


# ------------------------------------------------------------- receipts
RECEIPT_KEYS = set(jattr.reconcile(
    jattr.step_budget({"train_step": {"overlap": summary(1e-3)}}), 1e-2))


def check_receipt(receipt):
    assert RECEIPT_KEYS <= set(receipt)
    assert set(receipt["phases"]) == set(attr.PHASES)
    assert math.isclose(sum(receipt["phases"].values()),
                        receipt["measured_step_seconds"], rel_tol=1e-12)
    device = (receipt["phases"]["compute"]
              + receipt["phases"]["exposed_collective"]
              + receipt["phases"]["host_stream"])
    assert math.isclose(receipt["phases"]["driver"],
                        max(0.0, receipt["driver_bracket_seconds"] - device),
                        rel_tol=1e-12, abs_tol=1e-18)


def test_training_engine_receipts(tmp_path):
    cfg = W.dp_config(2, "Adam", 2, 1.0, 1, steps_per_print=1,
                      flops_profiler={"enabled": True, "profile_step": 3},
                      telemetry={"enabled": True, "run_dir": str(tmp_path)})
    engine = W.port_engine("gpt2", cfg, None)
    it = iter(W.gpt2_batches(8, 2, seed=3))
    for _ in range(4):
        engine.train_batch(it)
    receipt = engine.attribution_receipt()
    check_receipt(receipt)
    assert receipt["program"] == "stepwise"
    assert receipt["phases"]["compute"] > 0
    assert receipt["flops_check"]["model_flops"] == \
        engine.flops_profiler.profile.flops
    ov = engine.overlap_receipt()
    assert set(ov) == {"program", "wire_seconds", "exposed_wire_seconds",
                       "overlap_fraction"}
    # fwd_bwd twice (two micro-batches) and apply_update once
    entries = engine.comm_ledger.overlap_entries()
    assert math.isclose(
        receipt["phases"]["compute"],
        2 * entries["fwd_bwd"]["overlap"]["compute_seconds"]
        + entries["apply_update"]["overlap"]["compute_seconds"],
        rel_tol=1e-12)
    assert engine.driver_seconds_per_step() == \
        receipt["driver_bracket_seconds"] > 0
    events = [r for r in __import__(
        "deepspeed_tpu_torch.telemetry.events", fromlist=["x"]).read_events(
            str(tmp_path)) if r["type"] == "attribution"]
    # the latency ring has its first sample after the second step
    assert [e["step"] for e in events] == [3, 4]
    gauges = engine.telemetry.registry.names()
    assert {"attribution/compute_seconds", "attribution/driver_seconds",
            "attribution/unexplained_fraction"} <= set(gauges)
    engine.close()


def test_serving_engine_receipts(tmp_path):
    cfg = GPT2Config(vocab_size=64, max_position_embeddings=64,
                     hidden_size=32, num_layers=2, num_heads=2)
    model = GPT2LMHead(cfg)
    engine = InferenceEngine(
        model, model.init(0),
        config={"steps_per_print": 2,
                "inference": {"max_batch_slots": 2, "kv_blocks": 16,
                              "kv_block_size": 8, "max_seq_len": 64,
                              "prefill_buckets": [16]},
                "telemetry": {"enabled": True, "run_dir": str(tmp_path)}},
        device="cpu")
    rng = np.random.default_rng(0)
    for i in range(2):
        engine.submit(rng.integers(0, 64, size=9).tolist(),
                      max_new_tokens=6, request_id=f"r{i}")
    engine.run()
    receipt = engine.attribution_receipt()
    check_receipt(receipt)
    assert receipt["program"] == "serve_decode"
    assert engine.overlap_receipt()["program"] == "serve_decode"
    assert engine.comm_receipt()["wire_bytes"] == 0
    ctx = engine.program_verify_context()
    assert ctx["mesh_axes"] == {"data": 1} and ctx["param_bytes"] > 0
    gauges = engine.telemetry.registry.names()
    assert "serving/attribution/predicted_step_seconds" in gauges
    engine.close()
