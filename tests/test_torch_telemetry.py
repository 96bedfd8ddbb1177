"""The port's telemetry subsystem (``deepspeed_tpu_torch/telemetry``, the
timers and the monitor) against the JAX package's, on the CPU.

- The registry: counters, gauges, reservoir histograms and P² streaming
  quantiles fed one seeded stream snapshot EQUAL to the JAX ones, and
  their Prometheus text is equal; a threaded stress keeps exact counts.
- The event stream: the schema version, the type table and the file
  names are the JAX package's; each package reads and validates the
  other's event log, torn tail line included.
- The host-span tracer's Chrome trace loads; the device-trace trigger's
  stat is throttled and its ``torch.profiler`` trace holds CPU
  activity; a CUDA trace that records no CUDA activity is discarded and
  reported as an ``anomaly`` event, not kept as a host-only trace.
- The engines: a tiny GPT-2 trains 6 steps in both packages with
  telemetry on and ``steps_per_print`` 2: the same sequence of event
  types (the JAX engine's HLO-derived ``compile``/``memory``/``comm``/
  ``attribution`` records aside: ROADMAP A12's remainder), the
  ``step_metrics`` losses within 1e-5 and the samples equal; fp16 with a
  forced overflow gives the same ``loss_scale`` events; a NaN burst
  under ``policy=rollback`` with an async checkpoint gives the anomaly,
  rollback, resume and checkpoint queued/commit events in both, the
  queue-depth gauge drained, and each package's report renders the
  other's run dir.
- The JAX timer and monitor tests (``tests/unit/test_telemetry.py:682-
  724``, ``tests/unit/test_monitor.py``), ported.
"""

import json
import logging
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.parallel import make_mesh
from deepspeed_tpu.telemetry import events as jev
from deepspeed_tpu.telemetry import registry as jreg
from deepspeed_tpu.telemetry import report as jreport
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.resilience import ChaosMonkey
from deepspeed_tpu_torch.telemetry import events as tev
from deepspeed_tpu_torch.telemetry import registry as treg
from deepspeed_tpu_torch.telemetry import report as treport
from deepspeed_tpu_torch.telemetry.config import DeepSpeedTelemetryConfig
from deepspeed_tpu_torch.telemetry.manager import TelemetryManager
from deepspeed_tpu_torch.telemetry.trace import (DeviceTraceTrigger,
                                                 StepTracer)
from deepspeed_tpu_torch.utils.monitor import TrainingMonitor
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer)

from .torch_simple_model import SimpleModel, base_config, random_batches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT2_TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
                 max_position_embeddings=32, embd_dropout=0.0,
                 attn_dropout=0.0, resid_dropout=0.0)
HIDDEN = 16
LOSS_TOL = 1e-5
# the records derived from each package's programs (the JAX
# compile-telemetry bridge, the memory and comm ledgers, the attribution
# receipt): their number and order follow how each package cuts a step
# into programs (one fused JAX program, the port's step-wise phases), so
# the event sequences are compared without them
JAX_ONLY_TYPES = {"compile", "memory", "comm", "attribution"}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cpu_mesh():
    return make_mesh({"data": 1}, devices=jax.devices("cpu")[:1])


# ------------------------------------------------------------- registry
def feed(reg, seed=0):
    """One seeded stream into every instrument kind of ``reg``."""
    rng = np.random.default_rng(seed)
    reg.counter("train/steps").inc()
    reg.counter("train/steps").inc(4)
    reg.gauge("fp16/loss_scale").set(65536.0)
    reg.gauge("ckpt/queue_depth").add(2)
    h = reg.histogram("train/host_step_secs", reservoir_size=64)
    q = reg.quantiles("serving/per_token_seconds")
    for v in rng.lognormal(-5.0, 1.0, size=3000):
        h.observe(float(v))
        q.observe(float(v))
    return reg


def test_registry_snapshots_and_prometheus_text_equal_jax(tmp_path):
    port, ref = feed(treg.MetricsRegistry()), feed(jreg.MetricsRegistry())
    assert port.snapshot() == ref.snapshot()
    assert port.to_prometheus_text() == ref.to_prometheus_text()
    assert (treg.prometheus_text({"0": port.snapshot(), "1": {}})
            == jreg.prometheus_text({"0": ref.snapshot(), "1": {}}))
    # the dump the report CLI reads round-trips
    assert json.load(open(port.dump(tmp_path / "m.json") and
                          tmp_path / "m.json")) == port.snapshot()
    with pytest.raises(TypeError):
        port.gauge("train/steps")


@pytest.mark.parametrize("p", [0.5, 0.9, 0.99])
def test_p2_quantiles_equal_jax(p):
    """The same stream through both P² estimators, and their merge over
    windows, give the same floats."""
    samples = np.random.default_rng(7).lognormal(-7.0, 1.0, size=5000)
    ests = {}
    for mod in (treg, jreg):
        windows = [mod.P2Quantile(p) for _ in range(3)]
        whole = mod.P2Quantile(p)
        for i, s in enumerate(samples):
            windows[i % 3].observe(float(s))
            whole.observe(float(s))
        ests[mod] = (whole.value, whole.markers(),
                     mod.P2Quantile.merged_estimate(p, windows))
    assert ests[treg] == ests[jreg]
    assert ests[treg][0] == pytest.approx(float(np.quantile(samples, p)),
                                          rel=0.1)


def test_registry_thread_safety():
    """Writer threads (the step loop, checkpoint writers) and a reader
    (the watchdog) at once; the final counts are exact."""
    reg = treg.MetricsRegistry()
    n_threads, n_iters = 8, 2000
    stop = threading.Event()
    snaps = []

    def writer():
        c, h, g = reg.counter("steps"), reg.histogram("lat"), \
            reg.gauge("depth")
        for i in range(n_iters):
            c.inc()
            h.observe(i * 0.001)
            g.set(i)

    def watchdog():
        while not stop.is_set():
            snaps.append(reg.snapshot())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer) for _ in range(n_threads)]
        wd = threading.Thread(target=watchdog)
        wd.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        wd.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads + [wd])
    snap = reg.snapshot()
    assert snap["steps"]["value"] == n_threads * n_iters
    assert snap["lat"]["count"] == n_threads * n_iters
    assert snaps, "the reader never took a snapshot"


# --------------------------------------------------------------- events
def test_event_schema_and_file_names_equal_jax():
    assert tev.SCHEMA_VERSION == jev.SCHEMA_VERSION
    assert tev.EVENT_TYPES == jev.EVENT_TYPES
    assert tev.events_filename(3) == jev.events_filename(3)
    from deepspeed_tpu.telemetry import manager as jman
    from deepspeed_tpu_torch.telemetry import manager as tman
    assert tman.metrics_filename(3) == jman.metrics_filename(3)


def sample_data(event_type):
    """A minimal valid payload for each known event type."""
    samples = {
        "world_size": 4, "checkpoint": "/ckpt/global_step2",
        "reason": "close", "scalars": {"loss": 1.0}, "kind": "loss_spike",
        "detail": "z=9.1", "consecutive": 2, "from_step": 7,
        "restored_path": "/ckpt/global_step2", "stalled_secs": 12.5,
        "timeout_secs": 10.0, "scale": 1024.0, "prev_scale": 2048.0,
        "tag": "global_step7", "queue_depth": 1, "latency_secs": 0.2,
        "bytes": 4096, "retries": 1, "error": "disk full", "signum": 15,
        "proc_rank": 0, "pid": 4242, "code": 85, "restart": 1,
        "backoff_secs": 2.0, "duration_secs": 12.75, "phase": "plan",
        "program": "train_step", "phases": {"compute": 0.2},
        "predicted_step_seconds": 0.37, "measured_step_seconds": 0.5,
        "step_unexplained_fraction": 0.26, "verdict": "outlier",
        "suspects": [2]}
    return {k: samples[k] for k in tev.EVENT_TYPES[event_type]}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_and_validates_the_others_events(writer,
                                                            tmp_path):
    """Every event type written by one package, two ranks and a torn
    tail line, is read back by the other in (ts, stream, seq) order and
    passes its ``validate_event``; a record missing a required key is
    flagged by both."""
    write_mod, read_mod = (tev, jev) if writer == "port" else (jev, tev)
    logs = [write_mod.EventLog(tmp_path, rank=r) for r in (0, 1)]
    for i, etype in enumerate(sorted(write_mod.EVENT_TYPES)):
        logs[i % 2].emit(etype, step=i, **sample_data(etype))
    for log in logs:
        log.close()
    with open(tmp_path / write_mod.events_filename(1), "a") as f:
        f.write('{"schema_version": 1, "seq": 99, "ty')   # torn tail
    records = read_mod.read_events(tmp_path)
    assert [r["type"] for r in sorted(records, key=lambda r: r["step"])] \
        == sorted(write_mod.EVENT_TYPES)
    for r in records:
        assert read_mod.validate_event(r) == [], r
        assert tev.validate_event(r) == jev.validate_event(r)
    with pytest.raises(ValueError, match="undecodable"):
        read_mod.read_events(tmp_path, strict=True)
    bad = dict(records[0], data={})
    assert read_mod.validate_event(bad) and write_mod.validate_event(bad)


# ---------------------------------------------------------------- trace
def test_step_tracer_writes_a_loadable_chrome_trace(tmp_path):
    tracer = StepTracer(tmp_path, rank=0, max_events=3)
    with tracer.span("dispatch", step=1):
        pass
    for i in range(10):
        tracer.instant("anomaly", step=i)
    tracer.close()
    events = json.load(open(tracer.path))       # strict JSON after close
    complete = [e for e in events if e.get("ph") == "X"]
    assert [e["name"] for e in complete] == ["dispatch", "anomaly",
                                             "anomaly"]  # capped at 3
    assert all({"ts", "dur", "pid", "tid"} <= set(e) for e in complete)
    assert any(e.get("ph") == "M" for e in events)


def test_device_trace_trigger_is_throttled_and_traces_cpu_activity(
        tmp_path, monkeypatch):
    """The trigger file is stat'ed every ``check_every``-th poll only; a
    pending trigger starts ``torch.profiler`` on that boundary, the
    deadline stops it, and the exported Chrome trace holds the CPU ops
    that ran between."""
    trig = DeviceTraceTrigger(tmp_path, max_secs=0.05, check_every=5,
                              device="cpu")
    stats = {"n": 0}
    real_exists = os.path.exists

    def counting_exists(p):
        stats["n"] += 1
        return real_exists(p)

    monkeypatch.setattr(os.path, "exists", counting_exists)
    for step in range(20):
        trig.poll(step)
    monkeypatch.undo()
    assert stats["n"] == 4                      # 20 polls / 5
    open(trig.trigger_path, "w").close()
    step = 20
    while not trig.active:
        step += 1
        assert step <= 25, "the trigger was not picked up in check_every"
        trig.poll(step)
    assert not os.path.exists(trig.trigger_path)   # consumed
    torch.randn(64, 64) @ torch.randn(64, 64)
    import time
    time.sleep(0.06)
    trig.poll(step + 1)                         # past the deadline
    assert not trig.active and len(trig.paths) == 1
    trace = json.load(open(trig.paths[0]))
    names = {e.get("name") for e in trace["traceEvents"]
             if e.get("cat") == "cpu_op"}
    assert any("mm" in n for n in names), names


def test_cuda_trace_without_cuda_activity_is_reported_not_kept(tmp_path):
    """A trace asked for on a CUDA engine that records no CUDA activity
    (here: no CUDA at all, as when CUPTI is missing) is not a device
    trace: the file is removed and the manager writes an ``anomaly``."""
    config = DeepSpeedTelemetryConfig({"telemetry": {
        "enabled": True, "run_dir": str(tmp_path),
        "device_trace_secs": 30}})
    tel = TelemetryManager(config, rank=0, device="cuda:0")
    tel.device_trace.request()
    tel.poll_device_trace(1)
    assert tel.device_trace.active
    torch.randn(8, 8).sum()
    tel.close()                                 # stops the trace
    assert tel.device_trace.paths == []
    assert not os.listdir(tmp_path / "device_trace")
    anomalies = [r for r in tev.read_events(tmp_path)
                 if r["type"] == "anomaly"]
    assert len(anomalies) == 1
    assert anomalies[0]["data"]["kind"] == "device_trace"
    assert "no CUDA activity" in anomalies[0]["data"]["detail"]
    assert jev.validate_event(anomalies[0]) == []


# --------------------------------------------------------------- config
def test_telemetry_config_defaults_and_parse():
    cfg = DeepSpeedTelemetryConfig({})
    assert not cfg.enabled and cfg.events and not cfg.trace
    assert cfg.run_dir == os.path.join("runs", "telemetry")
    cfg = DeepSpeedTelemetryConfig({"telemetry": {
        "enabled": True, "run_dir": "/tmp/t", "trace": True,
        "trace_max_events": 10, "device_trace_secs": 3.5,
        "device_trace_trigger": "/tmp/go"}})
    assert cfg.enabled and cfg.trace and cfg.run_dir == "/tmp/t"
    assert cfg.trace_max_events == 10 and cfg.device_trace_secs == 3.5
    assert cfg.device_trace_trigger == "/tmp/go"
    with pytest.raises(ValueError, match="device_trace_secs"):
        DeepSpeedTelemetryConfig({"telemetry": {"device_trace_secs": 0}})


def test_telemetry_block_keys_are_checked(caplog):
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    with caplog.at_level(logging.WARNING):
        DeepSpeedConfig({"train_batch_size": 8,
                         "telemetry": {"enabled": True, "evnts": True}})
    assert "did you mean 'events'?" in caplog.text


def test_disabled_manager_is_cheap_noop(tmp_path):
    tel = TelemetryManager(DeepSpeedTelemetryConfig({}), rank=0)
    assert not tel.enabled
    tel.emit("anything", step=1, x=1)
    tel.counter("c").inc()
    tel.gauge("g").set(1)
    tel.histogram("h").observe(1)
    tel.quantiles("q").observe(1)
    with tel.span("s"):
        pass
    tel.poll_device_trace(1)
    tel.step_metrics(1, 16, {"loss": 1.0})
    tel.flush()
    tel.close()
    assert not os.listdir(tmp_path)


# --------------------------------------------------------------- engines
def gpt2_batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(2, 32)).astype(
        np.int32)} for _ in range(n)]


def gpt2_engine(kind, config):
    """The JAX (``kind="jax"``) or the port's engine on the tiny GPT-2's
    numpy weights from seed 0."""
    params = random_params(GPT2Config(**GPT2_TINY), seed=0)
    if kind == "jax":
        from deepspeed_tpu.models import GPT2Config as JGPT2
        from deepspeed_tpu.models import GPT2LMHeadTPU

        return jds.initialize(
            model=GPT2LMHeadTPU(JGPT2(**GPT2_TINY)),
            model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
            config=dict(config), mesh=cpu_mesh())[0]
    return tds.initialize(model=GPT2LMHead(GPT2Config(**GPT2_TINY)),
                          model_parameters=params, config=dict(config),
                          device="cpu")[0]


def tel_block(run_dir, **kw):
    return dict({"enabled": True, "run_dir": str(run_dir), "trace": True},
                **kw)


def port_types(records):
    return [r["type"] for r in records if r["type"] not in JAX_ONLY_TYPES]


@pytest.fixture(scope="module")
def gpt2_runs(tmp_path_factory):
    """The tiny GPT-2, 6 steps with steps_per_print 2 and telemetry on,
    in both packages: {package: event records}."""
    out = {}
    config = {"train_batch_size": 2, "steps_per_print": 2,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "zero_optimization": {"stage": 2}}
    batches = gpt2_batches(6)
    for k in ("jax", "port"):
        run_dir = tmp_path_factory.mktemp(k)
        engine = gpt2_engine(k, dict(config, telemetry=tel_block(run_dir)))
        for b in batches:
            engine.train_batch(iter([b]))
        engine.close()
        out[k] = (jev.read_events(run_dir), run_dir)
    return out


def test_gpt2_runs_give_the_same_events_and_step_metrics(gpt2_runs):
    jrec, _ = gpt2_runs["jax"]
    trec, _ = gpt2_runs["port"]
    assert port_types(trec) == port_types(jrec)
    assert port_types(trec) == (["run_start"] + ["step_metrics"] * 3
                                + ["run_end"])
    jm = [r for r in jrec if r["type"] == "step_metrics"]
    tm = [r for r in trec if r["type"] == "step_metrics"]
    assert [r["step"] for r in tm] == [r["step"] for r in jm] == [2, 4, 6]
    for t, j in zip(tm, jm):
        assert t["data"]["samples"] == j["data"]["samples"]
        assert t["data"]["skipped"] == j["data"]["skipped"] == 0
        ts, js = t["data"]["scalars"], j["data"]["scalars"]
        assert set(ts) == set(js)
        assert ts["Train/Samples/train_loss"] == pytest.approx(
            js["Train/Samples/train_loss"], rel=LOSS_TOL, abs=LOSS_TOL)
        assert ts["Train/Samples/lr"] == pytest.approx(
            js["Train/Samples/lr"], rel=1e-6)
        assert ts["Train/Samples/loss_scale"] == \
            js["Train/Samples/loss_scale"]
    for r in trec:
        assert jev.validate_event(r) == [], r
    start = trec[0]["data"]
    assert {k: start[k] for k in ("world_size", "dp", "precision",
                                  "zero_stage")} == \
        {k: jrec[0]["data"][k] for k in ("world_size", "dp", "precision",
                                         "zero_stage")}


def test_gpt2_run_artifacts_metrics_and_spans(gpt2_runs):
    """The port's run dir: the metrics snapshot counts the steps and
    samples as the JAX one does, and the host-span trace holds the step
    phases."""
    _, tdir = gpt2_runs["port"]
    _, jdir = gpt2_runs["jax"]
    tsnap = json.load(open(tdir / "metrics-rank0.json"))
    jsnap = json.load(open(jdir / "metrics-rank0.json"))
    for name in ("train/steps", "train/samples"):
        assert tsnap[name] == jsnap[name]
    assert tsnap["train/host_step_secs"]["count"] == 6
    spans = {e.get("name") for e in json.load(open(tdir / "trace-rank0.json"))
             if e.get("ph") == "X"}
    assert {"batch_fetch", "dispatch", "device_get", "run_start"} <= spans


def test_fp16_loss_scale_events_follow_the_same_trace(tmp_path):
    """fp16 with an inf in a compute param before step 3 and
    ``steps_per_print`` 1: the skipped steps move the scale alike, and
    each package writes the same ``loss_scale`` events."""
    config = {"train_batch_size": 2, "steps_per_print": 1,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "fp16": {"enabled": True, "initial_scale_power": 12,
                       "loss_scale_window": 2, "hysteresis": 1}}
    events = {}
    for k in ("jax", "port"):
        engine = gpt2_engine(k, dict(
            config, telemetry=tel_block(tmp_path / k, trace=False)))
        for step, b in enumerate(gpt2_batches(6, seed=2)):
            if step == 2:
                if k == "jax":
                    node = engine._module_params["blocks"]["layer_0"]["fc1"]
                    node["bias"] = node["bias"].at[0].set(jnp.inf)
                else:
                    with torch.no_grad():
                        engine.params["blocks"]["layer_0"]["fc1"][
                            "bias"][0] = float("inf")
            engine.train_batch(iter([b]))
        engine.close()
        events[k] = [(r["step"], r["data"]["scale"], r["data"]["prev_scale"])
                     for r in jev.read_events(tmp_path / k)
                     if r["type"] == "loss_scale"]
    assert events["port"] == events["jax"]
    # the window's growth at step 2, the skipped step's halving at 3
    assert events["port"][:2] == [(2, 8192.0, 4096.0), (3, 4096.0, 8192.0)]


def simple_engine(kind, config):
    """The JAX or the port's engine on one SimpleModel's numpy params."""
    params = SimpleModel(HIDDEN, nlayers=2).init(0)
    if kind == "jax":
        from .unit.simple_model import SimpleModel as JSimple

        return jds.initialize(
            model=JSimple(HIDDEN, nlayers=2),
            model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
            config=dict(config), mesh=cpu_mesh())[0]
    return tds.initialize(model=SimpleModel(HIDDEN, nlayers=2),
                          model_parameters=params, config=dict(config),
                          device="cpu")[0]


@pytest.fixture(scope="module")
def chaos_runs(tmp_path_factory):
    """The JAX chaos acceptance run (``tests/unit/test_telemetry.py:576``)
    in both packages: 2 clean steps, an async checkpoint, a NaN burst of
    2 under policy=rollback (rollback to step 2), 4 more steps."""
    out = {}
    for k in ("jax", "port"):
        base = tmp_path_factory.mktemp(f"chaos_{k}")
        cfg = base_config(steps_per_print=1, telemetry=tel_block(base / "tel"),
                          resilience={"enabled": True, "policy": "rollback",
                                      "divergence_patience": 2,
                                      "max_rollbacks": 1})
        engine = simple_engine(k, cfg)
        clean = random_batches(6, 16, HIDDEN, seed=5)
        for b in clean[:2]:
            engine.train_batch(iter([b]))
        engine.save_checkpoint(str(base / "ckpt"))          # async
        engine.wait_checkpoint()
        depth = engine.telemetry.registry.gauge("ckpt/queue_depth").value
        it = ChaosMonkey(seed=0).wrap_iter(
            iter([clean[2], clean[3]] + clean[2:]), nan_steps=(0, 1))
        for _ in range(6):
            engine.train_batch(it)
        assert engine.global_steps == 6
        engine.close()
        out[k] = (str(base / "tel"), depth)
    return out


def test_chaos_events_match_and_the_queue_depth_gauge_drains(chaos_runs):
    types = {}
    for k, (run_dir, depth) in chaos_runs.items():
        assert depth == 0, f"{k}: ckpt/queue_depth stuck at {depth}"
        records = jev.read_events(run_dir)
        for r in records:
            assert jev.validate_event(r) == [], r
        types[k] = port_types(records)
        by_type = {}
        for r in records:
            by_type.setdefault(r["type"], []).append(r)
        assert by_type["ckpt_queued"][0]["step"] == 2
        assert by_type["ckpt_commit"][0]["data"]["bytes"] > 0
        assert [a["step"] for a in by_type["anomaly"]] == [3, 4]
        assert all(a["data"]["kind"] == "nonfinite_grads"
                   for a in by_type["anomaly"])
        rb = by_type["rollback"][0]
        assert rb["data"]["from_step"] == 4 and rb["step"] == 2
        assert by_type["run_resume"][0]["step"] == 2
    assert types["port"] == types["jax"]


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_report_renders_the_others_chaos_run(reader, chaos_runs):
    """The report of one package on the other's run dir: the timeline
    names each event with its step and rank, the CLI exits 0, and the
    Prometheus dump carries the rollback counter."""
    mod = treport if reader == "port" else jreport
    run_dir = chaos_runs["jax" if reader == "port" else "port"][0]
    text, records = mod.generate_report(run_dir)
    for needle in ("anomaly", "rollback", "run_resume", "ckpt_queued",
                   "ckpt_commit", "rank=0", "step=2", "step=4"):
        assert needle in text, f"report missing {needle}:\n{text}"
    assert "schema problems" not in text
    assert mod.main(["report", run_dir]) == 0
    prom = mod.prometheus_dump(run_dir)
    assert "deepspeed_tpu_resilience_rollbacks_total" in prom
    assert 'deepspeed_tpu_ckpt_queue_depth{rank="rank0"} 0.0' in prom


def test_port_report_cli_modes(chaos_runs, capsys):
    """``python -m deepspeed_tpu_torch.telemetry report``: the text
    report, ``--json``, ``--prometheus`` and ``--serving`` exit 0;
    ``--doctor`` renders the doctor's verdict from the run's program
    dumps (``profiling.program_dump`` follows the comm ledger, which
    telemetry turns on)."""
    run_dir = chaos_runs["port"][0]
    out = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.telemetry", "report",
         run_dir, "--doctor", "--serving", "--comm"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "step-time attribution (doctor):" in out.stdout
    assert "step program: stepwise" in out.stdout
    assert "unavailable" not in out.stdout and "rollback" in out.stdout
    assert treport.main(["report", run_dir, "--json", "--doctor"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert "error" not in doc["doctor"]
    assert doc["doctor"]["budget"]["program"] == "stepwise"
    assert doc["summary"]["events_by_type"]["rollback"] == 1
    assert treport.main(["report", run_dir, "--prometheus"]) == 0
    assert "deepspeed_tpu_train_steps_total" in capsys.readouterr().out
    assert treport.main(["report", str(os.path.join(run_dir, "nope"))]) == 2


def test_preemption_path_flushes_tail_events(tmp_path):
    engine = simple_engine("port", base_config(
        steps_per_print=1, telemetry=tel_block(tmp_path)))
    engine.train_batch(iter(random_batches(1, 16, HIDDEN, seed=3)))
    engine._preemption_save()        # no checkpoint dir yet: no save
    types = [r["type"] for r in tev.read_events(tmp_path)]
    assert types[-2:] == ["preemption", "run_end"]
    assert os.path.isfile(tmp_path / "metrics-rank0.json")
    engine.close()
    closed = tev.read_events(tmp_path)
    engine.close()                   # idempotent: no second close record
    assert tev.read_events(tmp_path) == closed
    assert [r["type"] for r in closed].count("run_end") == 2


# ------------------------------------------------- timers and monitor
def test_throughput_timer_avg_before_any_window_is_zero():
    t = ThroughputTimer(batch_size=4, num_workers=1)
    assert t.avg_samples_per_sec() == 0.0
    lines = []
    t2 = ThroughputTimer(batch_size=4, num_workers=1, start_step=0,
                         steps_per_output=1, logging_fn=lines.append)
    t2.start()
    t2.stop()
    assert lines and "-inf" not in lines[0]


def test_wallclock_timer_log_honors_kwargs(caplog):
    timers = SynchronizedWallClockTimer()
    with caplog.at_level(logging.INFO):
        timers("phase").start(sync=False)
        timers("phase").stop(sync=False)
        timers.log(["phase"], memory_breakdown=True)
    assert any("phase" in r.getMessage() and "mem" in r.getMessage()
               for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        timers("phase").start(sync=False)
        timers("phase").stop(sync=False)
        timers.log(["phase"], ranks=[99])      # this process is rank 0
    assert not any("time (ms)" in r.getMessage() for r in caplog.records)


def test_memory_usage_reports_every_local_card():
    out = SynchronizedWallClockTimer.memory_usage()
    assert "mem" in out
    if "across" in out:
        assert "local device(s)" in out


def test_monitor_writes_scalars(tmp_path):
    mon = TrainingMonitor(True, str(tmp_path), "job")
    mon.write_scalars(10, {"Train/loss": 1.5, "Train/lr": 0.01})
    mon.write_scalars(20, {"Train/loss": 1.2, "Train/lr": 0.01})
    mon.close()
    lines = [json.loads(line) for line in
             open(tmp_path / "job" / "events.jsonl")]
    assert [line["step"] for line in lines] == [10, 20]
    assert lines[1]["Train/loss"] == 1.2
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path / "job"))


def test_monitor_disabled_is_noop(tmp_path):
    mon = TrainingMonitor(False, str(tmp_path), "job")
    mon.write_scalars(1, {"x": 1.0})
    mon.close()
    assert not (tmp_path / "job").exists()


def test_engine_tensorboard_wiring(tmp_path):
    """The ``tensorboard`` block's monitor gets the print cadence's
    scalars (with telemetry off too) and warns no more."""
    config = base_config(steps_per_print=1,
                         tensorboard={"enabled": True,
                                      "output_path": str(tmp_path),
                                      "job_name": "unit"})
    engine = simple_engine("port", config)
    for b in random_batches(3, 16, HIDDEN, seed=0):
        engine.train_batch(iter([b]))
    engine.close()
    lines = [json.loads(line) for line in
             open(tmp_path / "unit" / "events.jsonl")]
    assert len(lines) == 3
    assert all(np.isfinite(line["Train/Samples/train_loss"])
               for line in lines)


def test_wall_clock_breakdown_runs_the_reference_timers(caplog):
    """``wall_clock_breakdown``: ``train_batch`` logs its synchronized
    ``train_batch`` timer's mean at the print cadence only; the step-wise
    API logs its forward, backward and step timers at each step."""
    engine = simple_engine("port", base_config(
        steps_per_print=2, wall_clock_breakdown=True))
    batches = random_batches(4, 16, HIDDEN, seed=6)
    with caplog.at_level(logging.INFO,
                         logger="deepspeed_tpu_torch.utils.timer"):
        for b in batches[:3]:
            engine.train_batch(iter([b]))
    lines = [r.getMessage() for r in caplog.records
             if "time (ms)" in r.getMessage()]
    assert len(lines) == 1 and "train_batch:" in lines[0]
    caplog.clear()
    with caplog.at_level(logging.INFO,
                         logger="deepspeed_tpu_torch.utils.timer"):
        engine.backward(engine.forward(batches[3]))
        engine.step()
    lines = [r.getMessage() for r in caplog.records
             if "time (ms)" in r.getMessage()]
    assert len(lines) == 1
    assert all(f"{k}:" in lines[0] for k in ("forward", "backward", "step"))
    engine.close()
