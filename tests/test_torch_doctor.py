"""The port's offline doctor (``deepspeed_tpu_torch/profiling/doctor``)
and program dumps (``profiling/verify``) against the JAX package's
doctor.

- ``serving_traces`` and ``serving_tail_decomposition`` on a synthetic
  run dir of serving events (a requeued request, a shed one, one in
  flight) equal the JAX functions' results, with and without a decode
  budget.
- A tiny GPT-2 run with telemetry (``program_dump`` on by default with
  the comm ledger) writes ``programs/fwd_bwd.json`` and
  ``programs/apply_update.json`` with untruncated summaries and no HLO;
  ``doctor_run_dir`` gives a verdict whose phases sum to the measured
  step on every rank; the CLI exits 0 on that run dir (text and JSON)
  and 2 on an empty one and on a malformed sidecar; ``telemetry report
  --doctor`` renders the verdict.
- ``program_dump: true`` with the comm ledger off still dumps, and no
  longer warns.
"""

import json
import logging
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from deepspeed_tpu.profiling import doctor as jdoctor
from deepspeed_tpu_torch.profiling import attribution as attr
from deepspeed_tpu_torch.profiling import doctor
from deepspeed_tpu_torch.profiling import verify
from deepspeed_tpu_torch.telemetry import events as tev
from deepspeed_tpu_torch.telemetry import report as treport

from . import torch_dp_workers as W

REPO = Path(__file__).resolve().parent.parent


def serving_events(run_dir):
    """Four traces: r0 finished (4 tokens), r1 requeued once then
    finished later and longer (the tail), r2 shed, r3 in flight."""
    log = tev.EventLog(str(run_dir), rank=0)

    def emit(kind, trace, **data):
        log.emit(tev.EVENT_SERVING, kind=kind, trace=trace, **data)

    emit("submit", "t0", request="r0", t_mono=10.0)
    emit("admit", "t0", request="r0", wait_seconds=0.01, t_mono=10.01)
    emit("first_token", "t0", request="r0", prefill_seconds=0.02,
         ttft_seconds=0.03, t_mono=10.03)
    emit("finish", "t0", request="r0", latency_seconds=0.09,
         generated_tokens=4, reason="length", t_mono=10.09)
    emit("submit", "t1", request="r1", t_mono=10.0)
    emit("admit", "t1", request="r1", wait_seconds=0.02, t_mono=10.02)
    emit("requeue", "t1", request="r1")
    emit("admit", "t1", request="r1", wait_seconds=0.05, t_mono=10.2)
    emit("first_token", "t1", request="r1", prefill_seconds=0.03,
         ttft_seconds=0.25, t_mono=10.25)
    emit("finish", "t1", request="r1", latency_seconds=0.4,
         generated_tokens=7, reason="eos", t_mono=10.4)
    emit("submit", "t2", request="r2", t_mono=10.1)
    emit("shed", "t2", request="r2", reason="queue_full")
    emit("submit", "t3", request="r3", t_mono=10.3)
    emit("queue", None, queue_depth=1)
    log.close()


BUDGETS = [None, {"phases": {"compute": 0.004, "exposed_collective": 0.001,
                             "driver": 0.02}},
           {"phases": {"compute": 0.5}}]


@pytest.mark.parametrize("budget", range(len(BUDGETS)))
def test_serving_tail_decomposition_is_the_jax_one(tmp_path, budget):
    serving_events(tmp_path)
    records = tev.read_events(str(tmp_path))
    assert doctor.serving_traces(records) == jdoctor.serving_traces(records)
    got = doctor.serving_tail_decomposition(tmp_path, BUDGETS[budget])
    assert got == jdoctor.serving_tail_decomposition(tmp_path,
                                                     BUDGETS[budget])
    assert got["trace"] == "t1" and got["requeues"] == 1
    assert doctor.format_serving_tail(got) == \
        jdoctor.format_serving_tail(got)
    assert doctor.serving_tail_decomposition(tmp_path / "none") is None


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Five steps of the tiny GPT-2, telemetry on at every step."""
    root = tmp_path_factory.mktemp("doctor")
    cfg = W.dp_config(2, "Adam", 1, 1.0, 1, steps_per_print=1,
                      telemetry={"enabled": True, "run_dir": str(root)})
    engine = W.port_engine("gpt2", cfg, None)
    it = iter(W.gpt2_batches(5, 2, seed=4))
    for _ in range(5):
        engine.train_batch(it)
    engine.close()
    return root


def test_program_dump_writes_untruncated_sidecars(run_dir):
    names = sorted(os.listdir(run_dir / "programs"))
    assert names == ["apply_update.json", "fwd_bwd.json"]
    progs = verify.load_run_programs(run_dir)
    for name, side in progs.items():
        s = side["overlap"]
        assert s["nodes_truncated"] == 0 and s["compute_seconds"] > 0
        assert side["entry"]["collectives"] == 0
        assert side["context"]["device_kind"] == "cpu"
        assert "overlap" not in side["entry"]
    with pytest.raises(NotImplementedError, match="A12 step 6"):
        verify.verify_run_dir(run_dir)


def test_doctor_verdict_sums_to_the_measured_step(run_dir):
    verdict = doctor.doctor_run_dir(run_dir)
    assert verdict["programs"] == ["apply_update", "fwd_bwd"]
    assert verdict["budget"]["program"] == "stepwise"
    assert verdict["ranks"], verdict
    for rec in verdict["ranks"].values():
        assert set(rec["phases"]) == set(attr.PHASES)
        assert math.isclose(sum(rec["phases"].values()),
                            rec["measured_step_seconds"], rel_tol=1e-12)
    assert verdict["straggler"] is None and verdict["serving"] is None
    lines = doctor.format_verdict(verdict)
    assert lines[0].startswith("  step program: stepwise")
    assert any(line.strip().startswith("rank0") for line in lines)


def cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.profiling.doctor",
         *map(str, args)], cwd=REPO, capture_output=True, text=True,
        timeout=120)


def test_doctor_cli_exit_codes(run_dir, tmp_path, capsys):
    out = cli(run_dir)
    assert out.returncode == 0, out.stderr
    assert "step-time attribution" in out.stdout and "rank0" in out.stdout
    assert doctor.main([str(run_dir), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["programs"] == [
        "apply_update", "fwd_bwd"]
    assert doctor.main([str(tmp_path)]) == 2
    (tmp_path / "programs").mkdir()
    (tmp_path / "programs" / "bad.json").write_text("{not json")
    assert doctor.main([str(tmp_path)]) == 2
    assert "sidecar" in capsys.readouterr().err


def test_report_doctor_section_renders_the_verdict(run_dir, capsys):
    assert treport.main(["report", str(run_dir), "--doctor"]) == 0
    text = capsys.readouterr().out
    assert "step-time attribution (doctor):" in text
    assert "step program: stepwise" in text and "unavailable" not in text
    assert treport.main(["report", str(run_dir), "--json",
                         "--doctor"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert "error" not in doc["doctor"] and doc["doctor"]["ranks"]


def test_explicit_program_dump_records_with_the_ledger_off(tmp_path,
                                                           caplog):
    """``program_dump: true`` with ``comm_ledger: false`` still records
    and dumps each phase, and warns nothing."""
    cfg = W.dp_config(2, "Adam", 1, 1.0, 1,
                      profiling={"comm_ledger": False, "program_dump": True},
                      telemetry={"enabled": True, "run_dir": str(tmp_path)})
    with caplog.at_level(logging.WARNING):
        engine = W.port_engine("gpt2", cfg, None)
        engine.train_batch(iter(W.gpt2_batches(1, 2, seed=5)))
    engine.close()
    assert "program_dump" not in caplog.text
    assert sorted(verify.load_run_programs(tmp_path)) == ["apply_update",
                                                          "fwd_bwd"]
