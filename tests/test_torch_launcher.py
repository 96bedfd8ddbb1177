"""The port's launcher (``deepspeed_tpu_torch/launcher``) against the JAX
package's (``tests/unit/test_launcher.py``): the hostfile, the filters
and the world-info codec, which cross between the packages; the
runners' commands, equal to the JAX ones but for the forwarded env
prefixes and the spawner's module; one process per card with no
hostfile; the env a spawned child sees, whose ``LOCAL_RANK`` is its
slot; the exit-code map, ``--max-restarts``, poison codes and signal
deaths; and the data loader's order check on two gloo ranks."""

import json
import os
import signal
import sys
from types import SimpleNamespace

import pytest

from deepspeed_tpu.launcher import launch as jlaunch
from deepspeed_tpu.launcher import runner as jrunner
from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JLoader
from deepspeed_tpu_torch.launcher import launch, runner
from deepspeed_tpu_torch.launcher import ds_ssh
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.utils import distributed
from tests.torch_dist import run_ranks
from tests.torch_fleet_workers import FAST, launch_main, order_check_rank

HOSTFILE = """# a comment
worker-0 slots=4
worker-1 slots=4   # trailing
worker-2 slots=2
"""


@pytest.fixture
def hostfile(tmp_path):
    path = tmp_path / "hostfile"
    path.write_text(HOSTFILE)
    return str(path)


def test_hostfile_parses_as_the_jax_package_does(hostfile, tmp_path):
    assert runner.fetch_hostfile(hostfile) == jrunner.fetch_hostfile(
        hostfile) == {"worker-0": 4, "worker-1": 4, "worker-2": 2}
    assert runner.fetch_hostfile(str(tmp_path / "absent")) == {}
    bad = tmp_path / "bad"
    bad.write_text("worker-0 4\n")
    with pytest.raises(ValueError):
        runner.fetch_hostfile(str(bad))


FILTERS = [("", ""), ("worker-1", ""), ("worker-0@worker-2:1", ""),
           ("worker-0:1,3", ""), ("", "worker-1"), ("", "worker-0:0,2"),
           ("", "worker-2:0,1"), ("worker-3", ""), ("worker-2:5", "")]


@pytest.mark.parametrize("include,exclude", FILTERS)
def test_filters_equal_the_jax_package(hostfile, include, exclude):
    pool = runner.fetch_hostfile(hostfile)
    try:
        want = jrunner.filter_resources(pool, include, exclude)
    except AssertionError:
        with pytest.raises(AssertionError):
            runner.filter_resources(pool, include, exclude)
        return
    assert runner.filter_resources(pool, include, exclude) == want


@pytest.mark.parametrize("active", [
    {"localhost": [0]}, {"worker-0": [1, 3], "worker-1": [0, 1, 2, 3]},
    {"h": list(range(8))}])
def test_world_info_crosses_between_the_packages(active):
    assert jrunner.decode_world_info(runner.encode_world_info(active)) \
        == active
    assert runner.decode_world_info(jrunner.encode_world_info(active)) \
        == active


def _args(launcher, **kw):
    base = dict(hostfile="", include="", exclude="", num_nodes=-1,
                num_procs=-1, master_addr="", master_port=29500,
                launcher=launcher, force_multi=True,
                user_script="train.py", user_args=["--lr", "0.1"])
    base.update(kw)
    return SimpleNamespace(**base)


def _normalize(cmds, hostfiles):
    """The commands with the spawner's module and each runner's temp
    hostfile path made package-neutral."""
    out = []
    for cmd in cmds:
        words = []
        for w in cmd:
            w = w.replace("deepspeed_tpu_torch.launcher.launch", "SPAWNER")
            w = w.replace("deepspeed_tpu.launcher.launch", "SPAWNER")
            words.append("HOSTFILE" if w in hostfiles else w)
        out.append(words)
    return out


@pytest.mark.parametrize("name", ["pdsh", "ssh", "openmpi", "mvapich"])
def test_runner_commands_equal_the_jax_ones(name, monkeypatch):
    """Same args, resources and exports: the same command lines, but for
    the spawner's module and the MPI runners' temp hostfile path."""
    monkeypatch.chdir("/")
    active = {"worker-0": [0, 1], "worker-1": [0, 1]}
    exports = {"DS_FEATURE": "on", "PYTHONHASHSEED": "1"}
    ours = runner._RUNNERS[name](_args(name), active, "worker-0", exports)
    theirs = jrunner._RUNNERS[name](_args(name), active, "worker-0",
                                    exports)
    try:
        mine, want = ours.commands(), theirs.commands()
        files = {*getattr(ours, "_tmp_files", ()),
                 *getattr(theirs, "_tmp_files", ())}
        assert _normalize(mine, files) == _normalize(want, files)
        for path in getattr(ours, "_tmp_files", ()):
            with open(path) as f, open(theirs._tmp_files[0]) as g:
                assert f.read() == g.read()
    finally:
        for r in (ours, theirs):
            if hasattr(r, "cleanup"):
                r.cleanup()


def test_exports_forward_the_cuda_stack_and_no_rendezvous(tmp_path):
    """NCCL/CUDA/TORCH/DS_ travel, JAX/XLA/TPU do not, and no rank's
    rendezvous variable (the launcher's or torchrun's) leaks through;
    for the prefixes both packages forward, the same exports."""
    env = {"NCCL_DEBUG": "INFO", "CUDA_LAUNCH_BLOCKING": "1",
           "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "-x", "TPU_NAME": "t", "DS_FEATURE": "1",
           "PYTHONHASHSEED": "0", "UCX_TLS": "tcp", "RANK": "3",
           "WORLD_SIZE": "4", "LOCAL_RANK": "3", "MASTER_ADDR": "h",
           "MASTER_PORT": "1", "DS_PROCESS_ID": "3", "DS_LOCAL_RANK": "3",
           "HOME": "/x"}
    got = runner.collect_exports(env, paths=())
    assert got == {"NCCL_DEBUG": "INFO", "CUDA_LAUNCH_BLOCKING": "1",
                   "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1",
                   "DS_FEATURE": "1", "PYTHONHASHSEED": "0",
                   "UCX_TLS": "tcp"}
    shared = {k: v for k, v in env.items()
              if k.startswith(("PYTHON", "MV2", "UCX", "DS_"))}
    assert {k: v for k, v in got.items() if k in shared} == \
        jrunner.collect_exports(shared, paths=())
    (tmp_path / ".deepspeed_env").write_text("NCCL_IB_DISABLE=1\nRANK=9\n")
    assert runner.collect_exports({}, paths=(str(tmp_path),)) == {
        "NCCL_IB_DISABLE": "1"}


@pytest.mark.parametrize("cards,num_procs,want", [
    (2, -1, 2), (0, 3, 3), (0, -1, None)])
def test_one_process_per_card_without_a_hostfile(tmp_path, monkeypatch,
                                                 cards, num_procs, want):
    """No hostfile: one process per visible card, counted once; with no
    card and no --num_procs the runner raises instead of starting a CPU
    process."""
    monkeypatch.setattr(runner, "local_card_count", lambda: cards)
    calls = []
    monkeypatch.setattr(runner.subprocess, "call",
                        lambda cmd, env=None: calls.append(cmd) or 0)
    argv = ["--hostfile", str(tmp_path / "none"), "--num_procs",
            str(num_procs), "train.py"]
    if want is None:
        with pytest.raises(RuntimeError, match="one process per card"):
            runner.main(argv)
        return
    with pytest.raises(SystemExit) as exc:
        runner.main(argv)
    assert exc.value.code == 0
    info = [w for w in calls[0] if w.startswith("--world_info=")][0]
    world = runner.decode_world_info(info.split("=", 1)[1])
    assert list(world.values()) == [list(range(want))]
    assert "deepspeed_tpu_torch.launcher.launch" in calls[0]


ENV_CHILD = """
import json, os, sys
sys.path.insert(0, {repo!r})
keys = ("DS_COORDINATOR", "DS_NUM_PROCESSES", "DS_PROCESS_ID",
        "DS_LOCAL_RANK", "LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR",
        "MASTER_PORT", "DS_TELEMETRY_DIR")
rec = {{k: os.environ.get(k) for k in keys}}
if {torch!r}:
    from deepspeed_tpu_torch.utils.distributed import get_local_rank
    rec["get_local_rank"] = get_local_rank()
with open(sys.argv[1], "a") as f:
    f.write(json.dumps(rec) + "\\n")
"""


def test_env_reaches_the_spawned_child(tmp_path, monkeypatch):
    """The slots of a filtered hostfile (1 and 3) reach the children as
    DS_LOCAL_RANK and LOCAL_RANK, which get_local_rank reads (cuda:1 and
    cuda:3 under NCCL); the DS_* contract equals the JAX spawner's; a
    stale torchrun rank in the launcher's shell never reaches them."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for k, v in dict(FAST, RANK="7", WORLD_SIZE="8", MASTER_ADDR="stale",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    recs = {}
    for name, mod, torch_child in (("port", launch, True),
                                   ("jax", jlaunch, False)):
        script = tmp_path / f"child_{name}.py"
        script.write_text(ENV_CHILD.format(repo=repo, torch=torch_child))
        out = tmp_path / f"{name}.jsonl"
        assert launch_main(mod, script, (str(out),), slots=(1, 3),
                           extra_argv=["--telemetry-dir",
                                       str(tmp_path / name)]) == 0
        recs[name] = sorted((json.loads(line) for line in open(out)),
                            key=lambda r: r["DS_PROCESS_ID"])
    port, jax_recs = recs["port"], recs["jax"]
    assert [r["LOCAL_RANK"] for r in port] == ["1", "3"]
    assert [r["get_local_rank"] for r in port] == [1, 3]
    for mine, theirs in zip(port, jax_recs):
        for k in ("DS_NUM_PROCESSES", "DS_PROCESS_ID", "DS_LOCAL_RANK"):
            assert mine[k] == theirs[k], k
        assert mine["DS_COORDINATOR"].startswith("127.0.0.1:")
        assert (mine["RANK"], mine["WORLD_SIZE"], mine["MASTER_ADDR"],
                mine["MASTER_PORT"]) == (None, None, None, None)
        assert mine["DS_TELEMETRY_DIR"] == str(tmp_path / "port")


def test_get_local_rank_reads_the_launchers_slot(monkeypatch):
    for k in ("LOCAL_RANK", "DS_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
              "MV2_COMM_WORLD_LOCAL_RANK", "MPI_LOCALRANKID"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.get_local_rank() == 0
    monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "5")
    assert distributed.get_local_rank() == 5
    monkeypatch.setenv("DS_LOCAL_RANK", "3")
    assert distributed.get_local_rank() == 3
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert distributed.get_local_rank() == 2


@pytest.mark.parametrize("ret", [None, 0, 1, 86, 87, -9, -15, -2, -200])
def test_map_exit_code_equals_the_jax_package(ret):
    assert launch.map_exit_code(ret) == jlaunch.map_exit_code(ret)


FLAKY_CHILD = """
import os, sys, time
marker, mode = sys.argv[1], sys.argv[2]
lives = len(open(marker).read()) if os.path.exists(marker) else 0
with open(marker, "a") as f:
    f.write("x")
if mode == "flaky":
    sys.exit(0 if lives >= 1 else 1)
if mode == "poison":
    sys.exit(86)
if mode == "signal":
    os.kill(os.getpid(), 9)
"""


@pytest.mark.parametrize("mode,max_restarts,code,lives", [
    ("flaky", 2, 0, 2),       # respawned once, then clean
    ("flaky", 0, 1, 1),       # no restart budget: the first failure
    ("poison", 3, 86, 1),     # a divergence abort is never respawned
    ("signal", 0, 128 + signal.SIGKILL, 1)])
def test_restarts_poison_and_signal_deaths(tmp_path, monkeypatch, mode,
                                           max_restarts, code, lives):
    for k, v in FAST.items():
        monkeypatch.setenv(k, v)
    script = tmp_path / "child.py"
    script.write_text(FLAKY_CHILD)
    marker = tmp_path / "marker"
    got = launch_main(launch, script, (str(marker), mode),
                      max_restarts=max_restarts)
    assert got == code
    assert len(marker.read_text()) == lives


def test_compile_cache_dir_is_accepted_without_effect(tmp_path,
                                                      monkeypatch):
    for k, v in FAST.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    script = tmp_path / "child.py"
    script.write_text("import os, sys\nsys.exit(int('JAX_COMPILATION_"
                      "CACHE_DIR' in os.environ))\n")
    assert launch_main(launch, script, extra_argv=[
        "--compile-cache-dir", str(tmp_path / "cache")]) == 0


def test_ds_ssh_runs_the_command_on_localhost(tmp_path, capfd):
    with pytest.raises(SystemExit) as exc:
        ds_ssh.main(["-H", str(tmp_path / "none"), sys.executable, "-c",
                     "print('hello from ds_ssh')"])
    assert exc.value.code == 0
    assert "hello from ds_ssh" in capfd.readouterr().out


def test_order_fingerprint_equals_the_jax_package():
    for order in ([], [3, 1, 2], list(range(1000))[::-1]):
        assert DeepSpeedDataLoader.order_fingerprint(order) == \
            JLoader.order_fingerprint(order)


def test_order_check_on_two_gloo_ranks(tmp_path):
    """Same seed on both ranks: the epoch starts; different seeds: every
    rank raises on the epoch's first batch."""
    assert run_ranks(order_check_rank, 2, tmp_path, (3, 3)) == ["ok", "ok"]
    drift = run_ranks(order_check_rank, 2, tmp_path / "drift", (3, 4))
    assert all("order drift" in r for r in drift), drift
