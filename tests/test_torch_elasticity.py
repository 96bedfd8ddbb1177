"""The port's elasticity (``deepspeed_tpu_torch/elasticity``) against the
JAX package's (``tests/unit/test_elastic.py``, ``test_elastic_e2e.py``):
``compute_elastic_config`` and ``plan_world_size`` over a seeded grid of
schedules (results, or the same error class); the config's derived batch
triple; the env contract; and the port's launcher resizing on failure —
it re-plans and re-exports the world, never resizes around a poison
exit, tears down below the schedule's floor, jitters its backoff within
bounds, and, end to end, resizes a gloo world of two GPT-2 ranks killed
mid-run into one rank whose losses equal an unbroken one-rank run from
the same checkpoint."""

import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest

from deepspeed_tpu import elasticity as jel
from deepspeed_tpu.elasticity import cli as jcli
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch import elasticity as tel
from deepspeed_tpu_torch.elasticity import cli
from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from tests.torch_fleet_workers import (ELASTIC_1_3, ELASTIC_1_4, FAST,
                                       REPLICA, elastic_argv, launch_main,
                                       launcher_events, read_jsonl_dir)


def seeded_schedules(seed, n=12):
    """``n`` elasticity blocks drawn from ``seed``: micro-batch lists,
    caps, device ranges, the batch preference; some invalid."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        micro = sorted({int(m)
                        for m in rng.integers(1, 9, rng.integers(1, 4))})
        block = {"enabled": True,
                 "max_train_batch_size": int(rng.integers(1, 3000)),
                 "micro_batch_sizes": micro,
                 "min_gpus": int(rng.integers(1, 5)),
                 "max_gpus": int(rng.integers(1, 64)),
                 "prefer_larger_batch": bool(rng.integers(0, 2))}
        out.append(block)
    return out


def outcome(fn, *args, **kw):
    """``fn``'s result, or its exception's class name."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__


@pytest.mark.parametrize("seed", range(6))
def test_compute_elastic_config_equals_the_jax_package(seed):
    for block in seeded_schedules(seed):
        ds = {"elasticity": block}
        assert outcome(tel.compute_elastic_config, ds, "0.3.11") == \
            outcome(jel.compute_elastic_config, ds, "0.3.11")
        for world in (1, 2, 3, 4, 6, 8, 13):
            assert outcome(tel.compute_elastic_config, ds, "0.3.11",
                           world_size=world) == outcome(
                jel.compute_elastic_config, ds, "0.3.11",
                world_size=world), (block, world)


@pytest.mark.parametrize("seed", range(4))
def test_plan_world_size_equals_the_jax_package(seed):
    for block in seeded_schedules(seed + 100):
        for budget in (1, 2, 3, 5, 8, 16, 40):
            mine = outcome(tel.plan_world_size, block, budget, "0.3.11")
            want = outcome(jel.plan_world_size, block, budget, "0.3.11")
            assert (tuple(mine) if not isinstance(mine, str) else mine) \
                == (tuple(want) if not isinstance(want, str) else want)


@pytest.mark.parametrize("block,world,extra", [
    (ELASTIC_1_4, 1, {}), (ELASTIC_1_4, 2, {}), (ELASTIC_1_4, 4, {}),
    (ELASTIC_1_3, 3, {}),
    (dict(ELASTIC_1_3, ignore_non_elastic_batch_info=True), 2,
     {"train_batch_size": 99}),
    (ELASTIC_1_3, 2, {"train_batch_size": 6}),
    (ELASTIC_1_4, 3, {})])
def test_config_derives_the_batch_as_the_jax_package(block, world, extra,
                                                     monkeypatch):
    """The elastic schedule sets the batch triple for the world size; a
    batch key beside it raises unless ignored; an inadmissible world
    raises; the block no longer warns as unported."""
    monkeypatch.delenv("DEEPSPEED_ELASTICITY_CONFIG", raising=False)
    config = {"elasticity": dict(block), **extra}
    want = outcome(lambda: JConfig(json.loads(json.dumps(config)),
                                   world_size=world))
    got = outcome(lambda: DeepSpeedConfig(json.loads(json.dumps(config)),
                                          world_size=world))
    if isinstance(want, str):
        assert got == want
        return
    for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                "gradient_accumulation_steps"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.elasticity_enabled


def test_elasticity_block_is_no_longer_unported(caplog):
    with caplog.at_level("WARNING"):
        DeepSpeedConfig({"elasticity": dict(ELASTIC_1_4),
                         "strict_config": True}, world_size=2)
    assert "does not implement" not in caplog.text


def test_env_contract_equals_the_jax_package(monkeypatch):
    block = dict(ELASTIC_1_4, micro_batch_sizes=[4, 2], version="0.1.0")
    plan = tel.plan_world_size(block, 3)
    mine, want = {}, {}
    tel.export_plan_env(mine, block, plan)
    jel.export_plan_env(want, block, jel.plan_world_size(block, 3))
    assert mine == want
    monkeypatch.setenv("DEEPSPEED_ELASTICITY_CONFIG",
                       mine["DEEPSPEED_ELASTICITY_CONFIG"])
    tel.ensure_immutable_elastic_config(dict(ELASTIC_1_4))
    with pytest.raises(tel.ElasticityConfigError):
        tel.ensure_immutable_elastic_config(
            dict(ELASTIC_1_4, max_train_batch_size=16))
    monkeypatch.setenv("DS_ELASTIC_TARGET_WORLD_SIZE", "2")
    assert tel.elastic_world_size() == jel.elastic_world_size() == 2


def test_cli_prints_the_jax_packages_plan(tmp_path, capsys, monkeypatch):
    path = tmp_path / "ds.json"
    path.write_text(json.dumps({"elasticity": ELASTIC_1_4}))
    cli.main(["-c", str(path), "-w", "2"])
    mine = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["x", "-c", str(path), "-w", "2"])
    jcli.main()
    want = capsys.readouterr().out
    assert mine.replace("card", "chip") == want


# ------------------------------------------------------------ supervisor
LIFE_CHILD = """
import json, os, sys
out, mode = sys.argv[1], sys.argv[2]
rec = {k: os.environ.get(k) for k in (
    "DS_ELASTIC_TARGET_WORLD_SIZE", "DEEPSPEED_ELASTICITY_CONFIG",
    "DS_NUM_PROCESSES", "DS_PROCESS_ID", "DS_LOCAL_RANK", "LOCAL_RANK")}
with open(out, "a") as f:
    f.write(json.dumps(rec) + "\\n")
lives = len(open(out).readlines())
if mode == "poison":
    sys.exit(86)
if mode == "die" or (mode == "once" and lives == 1):
    os.kill(os.getpid(), 9)
"""


@pytest.fixture
def fast(monkeypatch):
    for k, v in FAST.items():
        monkeypatch.setenv(k, v)


def test_resize_replans_and_reexports_the_world(tmp_path, fast,
                                               monkeypatch):
    """A signal death under the supervisor respawns at the planned
    smaller world: the second life sees the new target world size and
    the normalized schedule, and the launcher stream has plan, resize
    and a respawn naming the planned size."""
    monkeypatch.setenv("DS_ELASTIC_DEVICES_PER_FAILURE", "1")
    script = tmp_path / "child.py"
    script.write_text(LIFE_CHILD)
    out = tmp_path / "lives.jsonl"
    code = launch_main(launch, script, (str(out), "once"), max_restarts=2,
                       extra_argv=elastic_argv(tmp_path, ELASTIC_1_3, 3))
    assert code == 0
    lives = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["DS_ELASTIC_TARGET_WORLD_SIZE"] for r in lives] == ["3", "2"]
    assert lives[1]["DS_NUM_PROCESSES"] == "1"
    assert json.loads(lives[1]["DEEPSPEED_ELASTICITY_CONFIG"]) == \
        tel.normalized_elastic_config(ELASTIC_1_3)
    plans = launcher_events(tmp_path, "elastic")
    assert [p["data"]["phase"] for p in plans] == ["plan", "resize"]
    assert (plans[0]["data"]["prev_world_size"],
            plans[0]["data"]["planned_world_size"],
            plans[0]["data"]["global_batch"]) == (3, 2, 6)
    (respawn,) = launcher_events(tmp_path, "proc_respawn")
    assert respawn["data"]["planned_world_size"] == 2


@pytest.mark.parametrize("mode,per_failure,restarts,code,lives,phases", [
    ("poison", "1", 3, 86, 1, []),              # never resized around
    ("die", "3", 3, 137, 1, []),                # below the schedule floor
    ("die", "1", 1, 137, 2, ["plan", "resize"])])  # resizes bound restarts
def test_resize_refusals(tmp_path, fast, monkeypatch, mode, per_failure,
                         restarts, code, lives, phases):
    monkeypatch.setenv("DS_ELASTIC_DEVICES_PER_FAILURE", per_failure)
    script = tmp_path / "child.py"
    script.write_text(LIFE_CHILD)
    out = tmp_path / "lives.jsonl"
    got = launch_main(launch, script, (str(out), mode),
                      max_restarts=restarts,
                      extra_argv=elastic_argv(tmp_path, ELASTIC_1_3, 3))
    assert got == code
    assert len(out.read_text().splitlines()) == lives
    assert [p["data"]["phase"]
            for p in launcher_events(tmp_path, "elastic")] == phases


def test_backoff_jitter_stays_within_its_bounds(monkeypatch):
    monkeypatch.setenv("DS_RESTART_BACKOFF_JITTER", "0.5")
    random.seed(0)
    draws = [launch.backoff_jitter() for _ in range(200)]
    assert all(1.0 <= d <= 1.5 for d in draws)
    assert max(draws) - min(draws) > 0.3      # it does jitter
    monkeypatch.setenv("DS_RESTART_BACKOFF_JITTER", "-1")
    assert launch.backoff_jitter() == 1.0


# ------------------------------------------------------------- end to end
KILL_STEP = 3
STEPS = 5


def test_chaos_kill_resize_end_to_end(tmp_path, fast, monkeypatch):
    """Two gloo ranks train the tiny GPT-2 on the elastic schedule; rank 1
    is SIGKILLed entering step 3, after step 2's checkpoint committed; the
    supervisor re-plans 2 -> 1 and the one-rank life resumes it.  Every
    step runs exactly once, on 2 ranks up to the kill and on 1 after, and
    the resized life's losses equal an unbroken one-rank run from the
    same checkpoint to 1e-6."""
    monkeypatch.setenv("DS_ELASTIC_DEVICES_PER_FAILURE", "1")
    monkeypatch.setenv("DS_CHAOS_KILL_STEP", str(KILL_STEP))
    monkeypatch.setenv("DS_CHAOS_TARGET_RANK", "1")
    monkeypatch.setenv("FLEET_STEPS", str(STEPS))
    monkeypatch.delenv("FLEET_REPLICAS", raising=False)
    ckpt, out = tmp_path / "ckpt", tmp_path / "out"
    code = launch_main(launch, REPLICA, ("train", str(out), str(ckpt)),
                       slots=(0, 1), max_restarts=1,
                       extra_argv=elastic_argv(tmp_path, ELASTIC_1_4, 2))
    assert code == 0
    (name,) = [n for n in os.listdir(out) if "resumed@" in n]
    resumed = int(name.rsplit("@", 1)[1].split(".")[0])
    assert resumed == KILL_STEP - 1
    first = read_jsonl_dir(out, "steps-rank0-fresh")
    again = read_jsonl_dir(out, name)
    assert [r["step"] for r in first] == list(range(1, KILL_STEP))
    assert all(r["world"] == 2 for r in first)
    assert [r["step"] for r in again] == list(range(resumed + 1, STEPS + 1))
    assert all(r["world"] == 1 and r["samples"] == 8 * r["step"]
               for r in again)
    phases = [r["data"]["phase"]
              for r in launcher_events(tmp_path, "elastic")]
    assert phases == ["plan", "resize"]
    (exit_rec,) = [r for r in launcher_events(tmp_path, "proc_exit")
                   if r["data"]["code"] != 0]
    assert exit_rec["data"]["signal"] == "SIGKILL"

    # the unbroken reference: one rank from the checkpoint the resized
    # life resumed
    ref_ckpt = tmp_path / "ckpt-ref"
    ref_ckpt.mkdir()
    for s in range(1, resumed + 1):
        shutil.copytree(ckpt / f"global_step{s}", ref_ckpt / f"global_step{s}")
    (ref_ckpt / "latest").write_text(f"global_step{resumed}")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DS_CHAOS", "DS_COORDINATOR"))}
    env.update(DS_PROCESS_ID="0", DS_NUM_PROCESSES="1",
               DS_TELEMETRY_DIR=str(tmp_path / "tel-ref"),
               DS_ELASTIC_TARGET_WORLD_SIZE="1")
    proc = subprocess.run(
        [sys.executable, REPLICA, "train", str(tmp_path / "out-ref"),
         str(ref_ckpt)], env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = {r["step"]: r for r in read_jsonl_dir(tmp_path / "out-ref",
                                                "steps-")}
    assert sorted(ref) == list(range(resumed + 1, STEPS + 1))
    for rec in again:
        np.testing.assert_allclose(rec["loss"], ref[rec["step"]]["loss"],
                                   rtol=1e-6, atol=0)
        assert ref[rec["step"]]["world"] == 1
