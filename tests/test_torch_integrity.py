"""The port's fleet integrity plane (``deepspeed_tpu_torch/resilience/
integrity.py``, ``fingerprint.py`` and the engine's wiring) against the
JAX package's (``tests/unit/test_integrity.py``,
``test_integrity_e2e.py``): the consensus and the hang quorum over
seeded fleets; verdict files, which cross between the packages; the
state fingerprint, equal to the JAX engine's checksum bit for bit on the
same leaves; the engine's arming rules and its verdicts, with no added
host sync; the ``straggler`` anomaly of ``resilience.straggler_factor``,
as the JAX engine emits it; and, end to end on CPU replicas of the tiny
GPT-2 under the port's launcher, a bitflip evicted and resized around
(losses then equal to an unbroken run) and a hung rank convicted by the
hang quorum in one resize."""

import contextlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.parallel import make_mesh as jmake_mesh
from deepspeed_tpu.resilience import integrity as jinteg
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.parallel import Mesh
from deepspeed_tpu_torch.resilience import integrity as integ
from deepspeed_tpu_torch.resilience.constants import (
    EXIT_INTEGRITY_EVICT, FleetIntegrityError, TrainingDivergedError)
import deepspeed_tpu_torch.resilience.fingerprint as fingerprint_module
from deepspeed_tpu_torch.resilience.fingerprint import fingerprint
from deepspeed_tpu_torch.telemetry import read_events
from tests.torch_dist import run_ranks
from tests.torch_fleet_workers import (ELASTIC_1_3, FAST, REPLICA,
                                       arming_rank, elastic_argv,
                                       onebit_integrity_rank,
                                       launch_main, launcher_events,
                                       read_jsonl_dir)

TINY = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)


@pytest.fixture(scope="module")
def weights():
    """The module's one tiny GPT-2 (2 layers, d 32): numpy params."""
    return random_params(GPT2Config(**TINY), seed=0)


def batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(2, 16))}
            for _ in range(n)]


def engine_for(weights, run_dir, mesh=None, stage=0, offload=False,
               **res):
    config = {"train_batch_size": 2, "steps_per_print": 1,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "zero_optimization": {"stage": stage,
                                    "cpu_offload": offload},
              "resilience": {"enabled": True, "integrity": True, **res},
              "telemetry": {"enabled": True, "run_dir": str(run_dir)}}
    engine, *_ = tds.initialize(model=GPT2LMHead(GPT2Config(**TINY)),
                                model_parameters=weights, config=config,
                                device="cpu", mesh=mesh,
                                dist_init_required=False)
    return engine


@pytest.fixture
def fleet(monkeypatch):
    """This process as rank 0 of a launcher fleet of ``n``."""
    def set_fleet(n, rank=0):
        monkeypatch.setenv("DS_PROCESS_ID", str(rank))
        monkeypatch.setenv("DS_NUM_PROCESSES", str(n))
    monkeypatch.delenv("DS_TELEMETRY_DIR", raising=False)
    return set_fleet


# ------------------------------------------------------------- the votes
def seeded_fleets(seed, n=40):
    """(fingerprint histories, fleet size) pairs drawn from ``seed``:
    up to 6 ranks publishing windows of steps, mostly agreeing, with
    outliers, lagging publishers and splits."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = int(rng.integers(1, 7))
        head = int(rng.integers(1, 6))
        fleet = {}
        for r in range(size):
            if rng.random() < 0.2:
                continue                     # never published
            lag = int(rng.integers(0, 3))
            bad = rng.random() < 0.25
            fleet[r] = {s: (f"{rng.integers(0, 3):08x}" if bad
                            else f"{s:08x}")
                        for s in range(max(0, head - lag - 3),
                                       head - lag + 1)}
        out.append((fleet, size))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_consensus_equals_the_jax_package(seed):
    for fleet, size in seeded_fleets(seed):
        assert integ.fingerprint_consensus(fleet, size) == \
            jinteg.fingerprint_consensus(fleet, size), (fleet, size)


@pytest.mark.parametrize("seed", range(5))
def test_hang_quorum_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed + 50)
    now = 1000.0
    for _ in range(60):
        size = int(rng.integers(1, 7))
        fleet = {r: {"step": int(rng.integers(3, 6)),
                     "ts": now - float(rng.choice([0.1, 1.0, 9.0, 40.0]))}
                 for r in range(size) if rng.random() < 0.9}
        me = int(rng.integers(0, size))
        for timeout in (5.0, 30.0):
            assert integ.hang_quorum(fleet, me, size, timeout, now=now) == \
                jinteg.hang_quorum(fleet, me, size, timeout, now=now)


def test_verdict_files_cross_between_the_packages(tmp_path):
    """A verdict either package writes the other reads, first writer
    wins across them, the consumed marker is read back by both, and
    either package's clear removes the other's fleet state."""
    d = str(tmp_path)
    integ.write_verdict(d, integ.KIND_SDC, 2, "port wrote", rank=0, step=4)
    jinteg.write_verdict(d, jinteg.KIND_HANG, 1, "jax wrote", rank=1)
    got = jinteg.read_verdict(d)
    assert (got["kind"], got["suspect"], got["step"]) == ("sdc_outlier", 2,
                                                          4)
    assert integ.read_verdict(d) == got
    assert jinteg.mark_verdict_consumed(d) is not None
    assert integ.read_verdict(d) is None
    assert integ.read_verdict(d, include_consumed=True) == got
    jinteg.write_verdict(d, jinteg.KIND_HANG, 1, "jax wrote", rank=1)
    assert integ.read_verdict(d)["kind"] == "hang_quorum"
    integ.publish_rank_fingerprint(d, 0, {1: "00000001"}, step=1)
    jinteg.publish_rank_heartbeat(d, 1, 3)
    assert jinteg.read_fleet_fingerprints(d) == {0: {1: "00000001"}}
    assert integ.read_fleet_heartbeats(d)[1]["step"] == 3
    assert integ.clear_fleet_state(d, keep_consumed=True) == 3
    assert os.listdir(d) == [integ.VERDICT_CONSUMED_FILE]
    assert jinteg.clear_fleet_state(d) == 1


# ---------------------------------------------------------- fingerprint
def jax_fingerprint(leaves):
    """The JAX engine's checksum (its ``_integrity_fingerprint_device``
    closure) on ``leaves``, through a stub that carries the state."""
    stub = SimpleNamespace(_integrity=object(), _fingerprint_jit=None,
                           mesh=contextlib.nullcontext(),
                           state={"master": tuple(leaves), "opt": ()})
    return int(JEngine._integrity_fingerprint_device(stub))


def seeded_leaves(seed):
    """The same leaves as (numpy for JAX, torch for the port): fp32,
    bf16, int32, uint32 and bool, of seeded sizes and values."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 3000, size=5)
    f32 = rng.standard_normal(sizes[0]).astype(np.float32)
    bf = rng.standard_normal(sizes[1]).astype(np.float32)
    i32 = rng.integers(-2 ** 31, 2 ** 31 - 1, sizes[2]).astype(np.int32)
    u32 = rng.integers(0, 2 ** 32 - 1, sizes[3], dtype=np.uint64).astype(
        np.uint32)
    flags = rng.random(sizes[4]) < 0.5
    jleaves = [jnp.asarray(f32), jnp.asarray(bf).astype(jnp.bfloat16),
               jnp.asarray(i32), jnp.asarray(u32), jnp.asarray(flags)]
    tleaves = [torch.from_numpy(f32), torch.from_numpy(bf).bfloat16(),
               torch.from_numpy(i32), torch.from_numpy(u32),
               torch.from_numpy(flags)]
    return jleaves, tleaves


@pytest.mark.parametrize("seed", range(4))
def test_fingerprint_equals_the_jax_engines_exactly(seed):
    jleaves, tleaves = seeded_leaves(seed)
    bits_j = np.asarray(jax.lax.bitcast_convert_type(jleaves[1],
                                                     jnp.uint16))
    assert np.array_equal(bits_j, tleaves[1].view(torch.int16).numpy()
                          .astype(np.uint16))
    want = jax_fingerprint(jleaves)
    got = fingerprint(tleaves)
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    # a single leaf, and a leaf of one element, too
    assert int(fingerprint(tleaves[:1])) == jax_fingerprint(jleaves[:1])
    assert int(fingerprint([tleaves[2][:1]])) == \
        jax_fingerprint([jleaves[2][:1]])


def numpy_fingerprint(leaves):
    """The checksum in numpy uint64 (products of two 32-bit words fit,
    sums wrap mod 2⁶⁴), over the leaves' unsigned words."""
    total = 0
    for bits in leaves:
        i = np.arange(bits.size, dtype=np.uint64)
        w = ((i * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)) | \
            np.uint64(1)
        total += int((bits.astype(np.uint64) * w).sum(dtype=np.uint64))
    return total & 0xFFFFFFFF


@pytest.mark.parametrize("case", ["jax", "all ones"])
def test_fingerprint_over_many_rows_and_runs(case, monkeypatch):
    """Leaves longer than one row of words, in one run and in several,
    equal the JAX checksum; leaves of all-ones words (the partial sums'
    worst case: every byte 255, every XORed byte 127) over a whole run
    of rows and over many equal the checksum in numpy's wrapping
    uint64."""
    rng = np.random.default_rng(11)
    run = 32 * 4096      # the shortest run: 32 rows of 4096 words
    if case == "jax":
        f32 = rng.standard_normal(3 * run + 123).astype(np.float32)
        # packed into one run with the tail of the leaf before it
        small = rng.standard_normal(7000).astype(np.float32)
        bf = rng.standard_normal(2 * 4096 + 5).astype(np.float32)
        flags = rng.random(2 * 4096) < 0.5
        jleaves = [jnp.asarray(f32), jnp.asarray(small),
                   jnp.asarray(bf).astype(jnp.bfloat16), jnp.asarray(flags)]
        tleaves = [torch.from_numpy(f32), torch.from_numpy(small),
                   torch.from_numpy(bf).bfloat16(), torch.from_numpy(flags)]
        want = jax_fingerprint(jleaves)
        assert int(fingerprint(tleaves)) == want
        monkeypatch.setattr(fingerprint_module, "CHUNK", run)
        assert int(fingerprint(tleaves)) == want
        return
    i32 = np.full(2 ** 22 + 4097, -1, np.int32)
    i16 = np.full(2 ** 20 + 3, -1, np.int16)
    want = numpy_fingerprint([i32.view(np.uint32), i16.view(np.uint16)])
    leaves = [torch.from_numpy(i32),
              torch.from_numpy(i16).view(torch.bfloat16)]
    assert int(fingerprint(leaves)) == want
    monkeypatch.setattr(fingerprint_module, "CHUNK", run)
    assert int(fingerprint(leaves)) == want


@pytest.mark.parametrize("leaf", range(5))
def test_one_flipped_bit_changes_the_fingerprint(leaf):
    _, tleaves = seeded_leaves(7)
    before = int(fingerprint(tleaves))
    rng = np.random.default_rng(leaf)
    t = tleaves[leaf].clone()
    if t.dtype == torch.bool:
        i = int(rng.integers(0, t.numel()))
        t[i] = ~t[i]
    else:
        words = t.view({4: torch.int32, 2: torch.int16}[t.element_size()])
        i = int(rng.integers(0, words.numel()))
        bit = int(rng.integers(0, 8 * t.element_size() - 1))
        words[i] ^= 1 << bit
    flipped = [t if k == leaf else x for k, x in enumerate(tleaves)]
    assert int(fingerprint(flipped)) != before


def test_engine_fingerprints_its_state_as_the_jax_function(weights,
                                                           tmp_path,
                                                           fleet):
    """The engine's leaves are its master, then the optimizer state's
    fields (the moments, then the step as an int32 scalar): their
    fingerprint is the JAX checksum of the same arrays in that order."""
    fleet(2)
    engine = engine_for(weights, tmp_path)
    engine.train_batch(iter(batches(1)))
    leaves = engine._integrity_leaves()
    assert [tuple(x.shape) if torch.is_tensor(x) else x
            for x in leaves[1:]] == [tuple(engine.master.shape)] * 2 + [1]
    want = jax_fingerprint(
        [jnp.asarray(x.numpy()) if torch.is_tensor(x)
         else jnp.asarray(x, jnp.int32) for x in leaves])
    assert int(fingerprint(leaves)) == want
    engine.close()


# ---------------------------------------------------------- the engine
@pytest.mark.parametrize("case,size,mesh,stage,offload,armed", [
    ("one rank", 1, None, 0, False, ()),
    ("two replicas", 2, None, 0, False, ("consensus",)),
    ("three replicas", 3, None, 0, False, ("consensus", "heartbeat")),
    ("dp2 zero0", 2, {"data": 2}, 0, False, ("consensus",)),
    ("dp1 zero2", 2, {"data": 1}, 2, False, ("consensus",)),
    ("offload", 3, None, 2, True, ("heartbeat",))])
def test_engine_arming_rules(weights, tmp_path, fleet, case, size, mesh,
                             stage, offload, armed):
    """Consensus where each process holds a full replica of (master,
    optimizer state) in a fleet of 2 or more; the heartbeat in a fleet of
    3 or more, sharded or not; neither without telemetry."""
    fleet(size)
    engine = engine_for(weights, tmp_path, stage=stage, offload=offload,
                        mesh=Mesh(mesh) if mesh else None,
                        integrity_peer_timeout_secs=30.0)
    assert (engine._integrity is not None) == ("consensus" in armed)
    assert (engine._fleet_heartbeat is not None) == ("heartbeat" in armed)
    engine.close()
    config = {"train_batch_size": 2, "resilience": {"enabled": True,
                                                    "integrity": True}}
    bare, *_ = tds.initialize(model=GPT2LMHead(GPT2Config(**TINY)),
                              model_parameters=weights, config=config,
                              device="cpu", dist_init_required=False)
    assert bare._integrity is None and bare._fleet_heartbeat is None


def test_engine_arming_over_a_gloo_world(tmp_path):
    """Two gloo ranks (the fleet is the process group): ZeRO-0 replicas
    arm the consensus, ZeRO-2 shards do not; a fleet of two never arms
    the heartbeat."""
    got = run_ranks(arming_rank, 2, tmp_path, str(tmp_path))
    assert got == [{0: (True, False), 2: (False, False)}] * 2


def test_onebit_replicas_agree_past_freeze_step(tmp_path):
    """Two gloo ranks of OneBitAdam with freeze_step 2, 5 steps: each
    rank's error feedback is its own, so above one data rank the
    fingerprint covers the master, the moments and the step only; those
    stay equal through the compressed phase, and every verdict reads
    ``ok`` (a fingerprint over the error buffers splits the two ranks
    into no majority and poisons the run)."""
    run_dir = str(tmp_path / "tel")
    got = run_ranks(onebit_integrity_rank, 2, tmp_path, run_dir, 5, 2)
    for armed, fields, verdicts, final in got:
        assert armed
        assert fields == [fields[0]] * 2 + [5]          # m, v, step
        assert {v for _, v, _ in verdicts} <= {"ok", "pending"}
        assert any(v == "ok" and n == 2 and s >= 3
                   for s, v, n in verdicts), verdicts
        assert final == ("ok", 5, 2)


@pytest.mark.parametrize("peers,action,raises", [
    (("deadbeef", "deadbeef"), "evict", FleetIntegrityError),
    (("deadbeef", "0badf00d"), "evict", TrainingDivergedError),
    (("deadbeef", "deadbeef"), "warn", None)])
def test_engine_verdicts(weights, tmp_path, fleet, peers, action, raises):
    """Two simulated peers agree against this rank: it is the outlier,
    named in the verdict file, and the step raises the eviction error
    (exit code 87); peers that disagree with each other and with it: no
    majority, the poison error; ``warn``: an event, no raise."""
    fleet(3)
    engine = engine_for(weights, tmp_path, integrity_action=action)
    for rank, fp in zip((1, 2), peers):
        integ.publish_rank_fingerprint(str(tmp_path), rank, {0: fp}, step=0)
    if raises is None:
        engine.train_batch(iter(batches(1)))
        assert engine._integrity.last_verdict["verdict"] == "outlier"
        assert integ.read_verdict(str(tmp_path)) is None
    else:
        with pytest.raises(raises) as exc:
            engine.train_batch(iter(batches(1)))
        if raises is FleetIntegrityError:
            assert exc.value.exit_code == EXIT_INTEGRITY_EVICT
            assert exc.value.suspect == 0
            verdict = jinteg.read_verdict(str(tmp_path))
            assert (verdict["kind"], verdict["suspect"]) == (
                "sdc_outlier", 0)
    engine.close()
    kinds = [r["data"]["verdict"] for r in read_events(str(tmp_path))
             if r["type"] == "integrity"]
    assert kinds and kinds[-1] in ("outlier", "no_majority")


def count_fetches(engine, steps):
    """Device-to-host reads during ``steps`` train_batch calls."""
    counts = {"n": 0}
    originals = {name: getattr(torch.Tensor, name)
                 for name in ("tolist", "item", "__float__", "__int__")}

    def counted(fn):
        def wrapper(self, *a, **kw):
            counts["n"] += 1
            return fn(self, *a, **kw)
        return wrapper

    try:
        for name, fn in originals.items():
            setattr(torch.Tensor, name, counted(fn))
        for b in batches(steps):
            engine.train_batch(iter([b]))
    finally:
        for name, fn in originals.items():
            setattr(torch.Tensor, name, fn)
    return counts["n"]


def test_integrity_adds_no_host_sync(weights, tmp_path, fleet):
    """With the plane armed every step still makes one batched fetch:
    the fingerprint rides it (the same count as resilience without
    integrity), and the fleet's files carry a fingerprint a step."""
    fleet(2)
    armed = engine_for(weights, tmp_path / "armed")
    plain = engine_for(weights, tmp_path / "plain")
    plain._integrity = None
    assert armed._integrity is not None
    assert count_fetches(armed, 4) == count_fetches(plain, 4)
    own = integ.read_fleet_fingerprints(str(tmp_path / "armed"))[0]
    assert sorted(own) == [0, 1, 2, 3]
    assert armed.vote_integrity()["verdict"] == "pending"
    assert sorted(integ.read_fleet_fingerprints(
        str(tmp_path / "armed"))[0]) == [0, 1, 2, 3, 4]
    armed.close()
    plain.close()


def test_straggler_anomaly_as_the_jax_engine_emits_it(weights, tmp_path,
                                                      fleet):
    """Two ranks' latency files in one run dir, one rank's p50 far above
    the other's: both engines emit the ``straggler`` anomaly naming it,
    with the same data keys and wording."""
    fleet(2)
    res = {"enabled": True, "straggler_factor": 1.5}
    records = {}
    for name in ("port", "jax"):
        run_dir = tmp_path / name
        run_dir.mkdir()
        with open(run_dir / "latency-rank1.json", "w") as f:
            json.dump({"rank": 1, "ts": time.time(), "n": 8, "steps": 8,
                       "last": 50.0, "mean": 50.0, "p50": 50.0,
                       "p95": 50.0, "max": 50.0}, f)
        config = {"train_batch_size": 2, "steps_per_print": 1,
                  "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                  "resilience": res,
                  "telemetry": {"enabled": True, "run_dir": str(run_dir)}}
        if name == "port":
            engine, *_ = tds.initialize(
                model=GPT2LMHead(GPT2Config(**TINY)),
                model_parameters=weights, config=config, device="cpu",
                dist_init_required=False)
            for b in batches(3):
                engine.train_batch(iter([b]))
        else:
            jconfig = dict(config, train_batch_size=4)
            engine, *_ = jds.initialize(
                model=GPT2LMHeadTPU(JGPT2Config(**TINY)),
                model_parameters=jax.tree_util.tree_map(jnp.asarray,
                                                        weights),
                config=jconfig,
                mesh=jmake_mesh({"data": 2},
                                devices=jax.devices("cpu")[:2]))
            for b in batches(3):
                engine.train_batch(iter([{
                    "input_ids": np.concatenate([b["input_ids"]] * 2)}]))
        engine.close()
        records[name] = [r["data"] for r in read_events(str(run_dir))
                         if r["type"] == "anomaly"
                         and r["data"]["kind"] == "straggler"]
    assert records["port"] and records["jax"]
    mine, want = records["port"][-1], records["jax"][-1]
    assert sorted(mine) == sorted(want)
    assert mine["detail"].startswith("rank 1 p50 50.0000s vs fleet median")
    assert want["detail"].startswith("rank 1 p50 50.0000s vs fleet median")
    assert mine["detail"].endswith("straggler_factor 1.5)")


# ------------------------------------------------------------ end to end
STEPS = 6


@pytest.fixture
def replicas(monkeypatch):
    for k, v in dict(FAST, FLEET_REPLICAS="1", FLEET_STEPS=str(STEPS),
                     DS_CHAOS_TARGET_RANK="1").items():
        monkeypatch.setenv(k, v)


def unbroken_losses(tmp_path):
    """Losses of one replica trained without chaos, alone."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DS_CHAOS", "DS_COORDINATOR"))}
    env.update(DS_PROCESS_ID="0", DS_NUM_PROCESSES="1",
               DS_TELEMETRY_DIR=str(tmp_path / "tel-ref"))
    proc = subprocess.run([sys.executable, REPLICA, "train",
                           str(tmp_path / "out-ref"),
                           str(tmp_path / "ckpt-ref")], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "out-ref" / "final-rank0.json") as f:
        return json.load(f)["losses"]


def test_bitflip_is_evicted_and_resized_around(tmp_path, replicas,
                                               monkeypatch):
    """Three replicas; rank 1's master takes one seeded bitflip before
    step 3.  The consensus names it (sdc_outlier), the supervisor evicts
    slot 1 and resizes 3 -> 2, the new life resumes the last committed
    checkpoint, and every logged loss equals an unbroken run's."""
    monkeypatch.setenv("DS_CHAOS_BITFLIP_STEP", "3")
    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    code = launch_main(launch, REPLICA, ("train", str(out), str(ckpt)),
                       slots=(0, 1, 2), max_restarts=2,
                       extra_argv=elastic_argv(tmp_path, ELASTIC_1_3, 3))
    assert code == 0
    phases = [(r["data"]["phase"], r["data"])
              for r in launcher_events(tmp_path, "elastic")]
    assert [p for p, _ in phases] == ["evict", "plan", "resize"]
    evict = phases[0][1]
    assert (evict["suspect"], evict["slot"], evict["kind"]) == (
        1, 1, "sdc_outlier")
    assert phases[2][1]["evicted_slots"] == [1]
    finals = [json.load(open(out / f"final-rank{r}.json")) for r in (0, 1)]
    assert all(f["steps"] == STEPS and f["life"].startswith("resumed@")
               for f in finals)
    ref = unbroken_losses(tmp_path)
    healthy = [r for r in read_jsonl_dir(out, "steps-")
               if not r["file"].startswith("steps-rank1-fresh")]
    assert {r["step"] for r in healthy} == set(range(1, STEPS + 1))
    for rec in healthy:
        assert rec["loss"] == ref[str(rec["step"])], rec
    assert finals[0]["verdicts"][-1]["verdict"] == "ok"
    assert finals[0]["fingerprints"] == finals[1]["fingerprints"]


def test_hang_quorum_convicts_in_one_resize(tmp_path, replicas,
                                            monkeypatch):
    """Three replicas; rank 1 wedges before it enters step 3.  Its
    healthy peers' hang quorum convicts it after the 2 s peer timeout and
    exits 87, the supervisor evicts its slot in ONE resize, well inside
    the 60 s local watchdog, and the fleet finishes every step."""
    monkeypatch.setenv("DS_CHAOS_HANG_STEP", "3")
    monkeypatch.setenv("DS_INTEGRITY_PEER_TIMEOUT", "2")
    monkeypatch.setenv("DS_WATCHDOG_SECS", "60")
    out, ckpt = tmp_path / "out", tmp_path / "ckpt"
    t0 = time.monotonic()
    code = launch_main(launch, REPLICA, ("train", str(out), str(ckpt)),
                       slots=(0, 1, 2), max_restarts=2,
                       extra_argv=elastic_argv(tmp_path, ELASTIC_1_3, 3))
    elapsed = time.monotonic() - t0
    assert code == 0 and elapsed < 45
    phases = [(r["data"]["phase"], r["data"])
              for r in launcher_events(tmp_path, "elastic")]
    assert [p for p, _ in phases] == ["evict", "plan", "resize"]
    assert (phases[0][1]["suspect"], phases[0][1]["kind"]) == (
        1, "hang_quorum")
    finals = [json.load(open(out / f"final-rank{r}.json")) for r in (0, 1)]
    assert all(f["steps"] == STEPS for f in finals)
    hangs = [r for r in read_events(str(tmp_path / "tel"))
             if r["type"] == "integrity"
             and r["data"]["kind"] == "hang_quorum"]
    assert hangs and all(r["data"]["suspects"] == [1] for r in hangs)
