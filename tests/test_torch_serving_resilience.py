"""The port's serving health plane (``deepspeed_tpu_torch/inference/
resilience.py`` and the engine's hooks) against the JAX package's
(``tests/unit/test_serving_resilience.py``,
``test_serving_chaos_e2e.py``): the weight fingerprint of the weights an
engine carries, equal to the JAX ``ServingHealth``'s bit for bit; the
freshness hang quorum over seeded fleets; conviction, no majority and
``warn``; the drain deadline, the engine's drain and the SIGTERM
preemption; no added host sync with the plane armed; and the chaos trio
end to end on three CPU replicas of the tiny GPT-2 under the port's
launcher — a replica killed, hung or bitflipped is resized around, every
request is served exactly once, and the tokens equal an in-process
greedy run's."""

import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import resilience as jres
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.inference import resilience as sres
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.resilience import integrity as integ
from deepspeed_tpu_torch.resilience.chaos import ChaosMonkey
from deepspeed_tpu_torch.resilience.constants import (
    EXIT_INTEGRITY_EVICT, FleetIntegrityError, TrainingDivergedError)
from deepspeed_tpu_torch.telemetry import read_events
from tests.torch_fleet_workers import (ELASTIC_1_3, FAST, REPLICA,
                                       elastic_argv, launch_main,
                                       launcher_events, read_jsonl_dir)

# the replica script's tiny GPT-2 (2 layers, d 32) and its serve config
TINY = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
            max_position_embeddings=64)
SERVE = {"inference": {"kv_block_size": 8, "kv_blocks": 64,
                       "max_batch_slots": 4, "max_seq_len": 64,
                       "prefill_buckets": [8, 16, 32], "token_budget": 256},
         "steps_per_print": 2}


@pytest.fixture(scope="module")
def weights():
    return random_params(GPT2Config(**TINY), seed=0)


def engine_for(weights, run_dir=None, dtype=None, **extra):
    config = json.loads(json.dumps(SERVE))
    if dtype:
        config["inference"]["weights_dtype"] = dtype
    if run_dir is not None:
        config["telemetry"] = {"enabled": True, "run_dir": str(run_dir)}
    config.update(extra)
    return InferenceEngine(GPT2LMHead(GPT2Config(**TINY)), weights,
                           config=config, device="cpu")


def prompts(n, seed=71):
    """The replica script's request set (numpy RandomState 71)."""
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, 256, size=rng.randint(3, 30))]
            for _ in range(n)]


# ----------------------------------------------------------- fingerprint
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_weight_fingerprint_equals_the_jax_serving_health(weights,
                                                          tmp_path, dtype):
    """On the weights each engine carries (fp32, or cast to bf16 as it
    serves them), the port's fingerprint is the JAX ServingHealth's."""
    config = json.loads(json.dumps(SERVE))
    if dtype:
        config["inference"]["weights_dtype"] = dtype
    jengine = JEngine(GPT2LMHeadTPU(JGPT2Config(**TINY)),
                      jax.tree_util.tree_map(np.asarray, weights),
                      config=config)
    engine = engine_for(weights, dtype=dtype)
    want = int(jres.ServingHealth(jengine, tmp_path, 0, 3)
               .fingerprint_device())
    health = sres.ServingHealth(engine, tmp_path, 0, 3)
    dev = health.fingerprint_device()
    assert dev.dtype == torch.int64 and int(dev) == want
    ChaosMonkey(seed=3).bitflip_params(engine)
    assert int(health.fingerprint_device()) != want


def test_serving_hang_quorum_equals_the_jax_package():
    rng = np.random.default_rng(9)
    now = 500.0
    for _ in range(200):
        size = int(rng.integers(1, 6))
        fleet = {r: {"step": int(rng.integers(0, 50)),
                     "ts": now - float(rng.choice([0.1, 2.0, 20.0, 90.0]))}
                 for r in range(size) if rng.random() < 0.85}
        me = int(rng.integers(0, size))
        for timeout in (5.0, 30.0):
            assert sres.serving_hang_quorum(fleet, me, size, timeout,
                                            now=now) == \
                jres.serving_hang_quorum(fleet, me, size, timeout, now=now)


@pytest.mark.parametrize("peers,action,raises", [
    ((None, None), "evict", None),                   # a lone replica
    (("same", "same"), "evict", None),               # the majority agrees
    (("deadbeef", "deadbeef"), "evict", FleetIntegrityError),
    (("deadbeef", "0badf00d"), "evict", TrainingDivergedError),
    (("deadbeef", "deadbeef"), "warn", None)])
def test_weight_votes(weights, tmp_path, peers, action, raises):
    """Replica 0 votes against two peers' published fingerprints:
    pending alone, ok with them, convicted (a verdict naming it, exit
    code 87) when both disagree with it, poisoned with no majority; under
    ``warn`` an outlier only counts."""
    engine = engine_for(weights, run_dir=tmp_path)
    health = sres.ServingHealth(engine, tmp_path, 0, 3, action=action)
    mine = int(health.fingerprint_device())
    for rank, fp in zip((1, 2), peers):
        if fp is not None:
            sres.publish_weight_fingerprint(
                str(tmp_path), rank, mine if fp == "same" else int(fp, 16))
    if raises is not None:
        with pytest.raises(raises) as exc:
            health.note_weight_fingerprint(mine)
        if raises is FleetIntegrityError:
            assert exc.value.exit_code == EXIT_INTEGRITY_EVICT
            assert exc.value.suspect == 0
            assert integ.read_verdict(str(tmp_path))["kind"] == \
                "sdc_outlier"
    else:
        verdict = health.note_weight_fingerprint(mine)
        want = {(None, None): "pending", ("same", "same"): "ok"}.get(
            peers, "outlier")
        assert verdict["verdict"] == want
        assert health.violations == int(want == "outlier")
    engine.close()
    health.stop()


# ------------------------------------------------------------ draining
@pytest.mark.parametrize("env,want", [
    ({"DS_TERM_DRAIN_DEADLINE_SECS": "7.5"}, 7.5),
    ({"DS_TERM_GRACE_SECS": "10"}, 9.0),
    ({"DS_TERM_DRAIN_DEADLINE_SECS": "soon"}, 27.0),
    ({"DS_TERM_DRAIN_DEADLINE_SECS": "0"}, 0.0)])
def test_drain_deadline_equals_the_jax_package(monkeypatch, env, want):
    for k in ("DS_TERM_DRAIN_DEADLINE_SECS", "DS_TERM_GRACE_SECS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert sres.drain_deadline_secs() == pytest.approx(want) == \
        pytest.approx(jres.drain_deadline_secs())


def test_drain_finishes_in_flight_and_stops_admission(weights, tmp_path):
    engine = engine_for(weights, run_dir=tmp_path)
    health = engine.attach_health(sres.ServingHealth(engine, tmp_path, 0,
                                                     1))
    for i, p in enumerate(prompts(3)):
        engine.submit(p, max_new_tokens=4, request_id=f"r{i}")
    engine.step()
    drained = engine.drain(deadline_secs=0)
    assert {r.request_id for r in drained} == {"r0", "r1", "r2"}
    with pytest.raises(RuntimeError, match="draining"):
        engine.submit(prompts(1)[0])
    engine.close()
    engine.close()
    assert health.heartbeat._stop.is_set()
    types = [r["type"] for r in read_events(str(tmp_path))]
    assert types.count("run_end") == 1


class Closing:
    def __init__(self, fail=False):
        self.closed_with, self.fail = [], fail

    def close(self, reason="?"):
        self.closed_with.append(reason)
        if self.fail:
            raise RuntimeError("drain blew up")


@pytest.mark.parametrize("fail", [False, True])
def test_sigterm_drains_then_exits_respawnable(fail):
    engine, codes = Closing(fail), []
    old = signal.getsignal(signal.SIGTERM)
    try:
        sres.arm_serving_preemption(engine, exit_fn=codes.append)
        signal.raise_signal(signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert engine.closed_with == ["preempt_drain"]
    assert codes == [128 + signal.SIGTERM]


def count_fetches(fn):
    counts = {"n": 0}
    originals = {name: getattr(torch.Tensor, name)
                 for name in ("tolist", "item", "__float__", "__int__")}

    def counted(f):
        def wrapper(self, *a, **kw):
            counts["n"] += 1
            return f(self, *a, **kw)
        return wrapper

    try:
        for name, f in originals.items():
            setattr(torch.Tensor, name, counted(f))
        result = fn()
    finally:
        for name, f in originals.items():
            setattr(torch.Tensor, name, f)
    return counts["n"], result


def test_zero_added_host_syncs_with_health_armed(weights, tmp_path):
    """The same requests with and without the plane: the same number of
    device-to-host reads and the same tokens; the armed replica voted on
    every cadence through the fingerprint the decode fetch carried."""
    runs = {}
    for armed in (False, True):
        engine = engine_for(weights, run_dir=tmp_path / str(armed))
        health = None
        if armed:
            health = engine.attach_health(sres.ServingHealth(
                engine, tmp_path / str(armed), 0, 1))
        for i, p in enumerate(prompts(6)):
            engine.submit(p, max_new_tokens=6, request_id=f"r{i}")
        runs[armed] = count_fetches(engine.run)
        engine.close()
        if armed:
            assert health.last_verdict["verdict"] == "pending"
            assert integ.read_fleet_fingerprints(
                str(tmp_path / str(armed)))[0] == {0: integ.
                                                   canonical_fingerprint(
                    int(health.fingerprint_device()))}
    assert runs[True][0] == runs[False][0]
    assert {k: r["tokens"] for k, r in runs[True][1].items()} == \
        {k: r["tokens"] for k, r in runs[False][1].items()}


# ------------------------------------------------------------ end to end
@pytest.mark.parametrize("kind,phases,evicted_kind", [
    ("kill", ["plan", "resize"], None),
    ("hang", ["evict", "plan", "resize"], "hang_quorum"),
    ("bitflip", ["evict", "plan", "resize"], "sdc_outlier")])
def test_chaos_trio_serves_every_request_exactly_once(
        weights, tmp_path, monkeypatch, kind, phases, evicted_kind):
    """Three replicas serve 9 seeded requests; replica 1 is killed, hung
    or bitflipped at its second engine iteration.  The supervisor resizes
    3 -> 2 (aimed at slot 1 by the verdict for hang and bitflip), the
    union of the ledgers holds every request exactly once, and the
    tokens equal an in-process greedy run's."""
    for k, v in dict(FAST, DS_SERVE_CHAOS_KIND=kind,
                     DS_SERVE_PEER_TIMEOUT="3",
                     DS_SERVE_MAX_NEW="4").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("FLEET_MODEL", raising=False)
    out = tmp_path / "out"
    code = launch_main(launch, REPLICA, ("serve", str(out)),
                       slots=(0, 1, 2), max_restarts=2,
                       extra_argv=elastic_argv(tmp_path, ELASTIC_1_3, 3))
    assert code == 0
    events = launcher_events(tmp_path, "elastic")
    assert [e["data"]["phase"] for e in events] == phases
    if evicted_kind:
        assert (events[0]["data"]["suspect"], events[0]["data"]["slot"],
                events[0]["data"]["kind"]) == (1, 1, evicted_kind)
    assert events[-1]["data"]["procs"] == 2
    ledger = read_jsonl_dir(out, "results-")
    rids = [r["rid"] for r in ledger]
    assert sorted(rids) == [f"req-{i:03d}" for i in range(9)]
    reference = engine_for(weights)
    for i, p in enumerate(prompts(9)):
        reference.submit(p, max_new_tokens=4, request_id=f"req-{i:03d}")
    want = {k: r["tokens"] for k, r in reference.run().items()}
    assert {r["rid"]: r["tokens"] for r in ledger} == want
    assert os.path.exists(out / "chaos-armed-slot1")
