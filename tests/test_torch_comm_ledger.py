"""The port's comm ledger (``deepspeed_tpu_torch/profiling/comm``) against
the JAX package's (``deepspeed_tpu/profiling/comm``): the wire-bytes
model and the summary are the JAX functions' over a grid of ops, sizes
and groups; on a dp=2 gloo run (one spawned group for every case) the
ledger's entries obey the ring formula, ZeRO-2's all-gathers move
exactly the flat compute buffer (as the JAX
``tests/unit/test_comm_profiling.py:171`` asserts of its master), the
offload stream's copies land in ``host_transfer_bytes``, the events are
schema-valid and ``telemetry report --comm`` prints their table."""

import contextlib
import io

import pytest

from deepspeed_tpu.profiling import comm as jcomm
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.profiling import comm as cp
from deepspeed_tpu_torch.telemetry import read_events, validate_event
from deepspeed_tpu_torch.telemetry import report as telemetry_report

from .torch_dist import run_ranks
from .torch_profiling_workers import LEDGER_CASES, comm_ledger_runs

WORLD = 2
OPS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute",
       "all-to-all")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("out_bytes", [0, 4, 1000, 4096, 12345])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_predicted_wire_bytes_is_the_jax_model(op, out_bytes, group):
    assert cp.predicted_wire_bytes(op, out_bytes, group) == \
        jcomm.predicted_wire_bytes(op, out_bytes, group)


def test_collective_summary_is_the_jax_summary():
    recs = [{"op": op, "out_bytes": n, "group": g,
             "wire_bytes": cp.predicted_wire_bytes(op, n, g)}
            for op in OPS for n in (64, 4096) for g in (1, 2, 4)]
    assert cp.collective_summary(recs) == jcomm.collective_summary(recs)
    assert cp.collective_summary([]) == jcomm.collective_summary([])


@pytest.mark.parametrize("weights", [("fwd_bwd", "apply_update"),
                                     ("train_step", "fwd_bwd"),
                                     ("serve_decode",), ()])
@pytest.mark.parametrize("acc", [1, 3])
def test_step_program_weights_is_the_jax_rule(weights, acc):
    assert cp.step_program_weights(set(weights), acc) == \
        jcomm.step_program_weights(set(weights), acc)


@pytest.mark.parametrize("verb,nbytes,group,want", [
    ("psum", 400, 4, ("all-reduce", 400)),
    ("pmax", 8, 2, ("all-reduce", 8)),
    ("reduce_scatter", 400, 4, ("reduce-scatter", 100)),
    ("all_gather", 400, 4, ("all-gather", 400)),
    ("all_to_all", 400, 4, ("all-to-all", 400)),
    ("send", 64, 2, ("collective-permute", 64)),
    ("recv", 64, 2, None)])
def test_counter_verbs_map_to_hlo_ops(verb, nbytes, group, want):
    """A counter call is one collective record: its result bytes (1/group
    of a reduce-scatter's input) and the ring formula's wire bytes; a
    receive is its permute's other half and records nothing."""
    rec = cp.collective_record(verb, nbytes, group)
    if want is None:
        assert rec is None
        return
    assert (rec["op"], rec["out_bytes"]) == want and rec["group"] == group
    assert rec["wire_bytes"] == jcomm.predicted_wire_bytes(
        want[0], want[1], group)


def test_ledger_records_the_counters_calls_between_begin_and_end():
    ledger = cp.CommLedger()
    assert ledger.begin("phase")
    comm.counter.add("all_gather", 800, 2)
    comm.counter.add("recv", 800, 2)
    entry = ledger.end("phase", host_transfers=3, host_transfer_bytes=96)
    comm.counter.add("all_gather", 800, 2)   # after the phase: not counted
    assert entry["collectives"] == 1
    assert entry["ops"]["all-gather"] == {"count": 1, "payload_bytes": 800,
                                          "wire_bytes": 400, "max_group": 2}
    assert entry["host_transfer_bytes"] == 96
    assert not ledger.begin("phase")         # recorded once
    assert comm.counter.listeners == []


def test_disabled_ledger_records_nothing():
    ledger = cp.CommLedger(enabled=False)
    assert not ledger.begin("phase") and ledger.end("phase") is None
    assert ledger.entries() == {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("comm_ledger")
    ranks = run_ranks(comm_ledger_runs, WORLD, root / "ranks", str(root))
    return ranks


def check_entry(entry):
    """Internal consistency: the totals are the ops' sums, and every op's
    wire bytes its payload under the ring formula (payloads divide)."""
    assert entry["payload_bytes"] == sum(
        b["payload_bytes"] for b in entry["ops"].values())
    assert entry["wire_bytes"] == sum(
        b["wire_bytes"] for b in entry["ops"].values())
    assert entry["collectives"] == sum(
        b["count"] for b in entry["ops"].values())


@pytest.mark.parametrize("label", [c[0] for c in LEDGER_CASES])
def test_ledger_entries_obey_the_ring_formula(runs, label):
    """At dp=2: the step's all-gathers move exactly the flat compute
    buffer, each at ``(dp-1)/dp`` of its payload on the wire; the
    gradient's reduction carries the flat gradient once (ZeRO-2: a
    reduce-scatter in each micro-batch's backward; ZeRO-1: at the step);
    the stats all-reduce is the step's; under offload the stream's
    copies are the step's host transfers."""
    case = dict((c[0], c) for c in LEDGER_CASES)[label]
    _, stage, _, acc, offload = case
    for rank, res in enumerate(runs):
        r = res[label]
        entries = r["entries"]
        assert set(entries) == {"fwd_bwd", "apply_update"}
        for e in entries.values():
            check_entry(e)
        flat_bytes = r["flat_elements"] * r["compute_bytes"]
        apply = entries["apply_update"]
        gathers = apply["ops"]["all-gather"]
        assert gathers["payload_bytes"] == flat_bytes
        assert gathers["max_group"] == WORLD
        assert gathers["wire_bytes"] == flat_bytes * (WORLD - 1) // WORLD
        assert apply["ops"]["all-reduce"]["max_group"] == WORLD
        grad = entries["fwd_bwd"] if stage == 2 else apply
        scatter = grad["ops"]["reduce-scatter"]
        # the exchange sums in fp32 above one rank
        assert scatter["payload_bytes"] == r["flat_elements"] * 4
        assert scatter["wire_bytes"] == \
            r["flat_elements"] * 4 * (WORLD - 1) // WORLD
        if offload:
            assert apply["host_transfers"] > 0
            assert apply["host_transfer_bytes"] >= r["host_state_bytes"]
        else:
            assert apply["host_transfer_bytes"] == 0
        step = r["step"]
        assert step["program"] == "stepwise"
        assert step["wire_bytes"] == (entries["fwd_bwd"]["wire_bytes"] * acc
                                      + apply["wire_bytes"])


def test_ledger_events_and_report(runs, capsys):
    """Every rank's ``comm``/``program`` events are schema-valid with the
    mesh; the report's ``--comm`` section prints a row per phase and
    rank."""
    run_dir = runs[0]["zero2_fused"]["run_dir"]
    records = read_events(run_dir)
    progs = [r for r in records if r["type"] == "comm"
             and r["data"]["kind"] == "program"]
    assert len(progs) == 2 * WORLD
    for r in progs:
        assert validate_event(r) == []
        assert r["data"]["mesh"] == {"data": WORLD}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = telemetry_report.main(["report", run_dir, "--comm"])
    text = out.getvalue()
    assert rc == 0
    assert "no comm program events" not in text
    rows = [line for line in text.splitlines()
            if line.strip().startswith(("fwd_bwd", "apply_update"))]
    assert len(rows) == 2 * WORLD
    assert any("all-gather:1(g2)" in line for line in rows)
