"""The port's overlap model (``deepspeed_tpu_torch/profiling/overlap``)
against the JAX package's (``deepspeed_tpu/profiling/overlap``).

- The model functions (``_classify``, ``_bucket``,
  ``_declared_stream_nodes``, ``_apply_collective_schedule``) give the
  JAX functions' outputs on the same inputs, over the serialized,
  pipelined, redundant-prefetch and grad-stream host schedules and the
  bucketed exchange on and off at 1, 2 and 8 buckets, at rel 1e-12.
- A lone matmul and a lone add price the same in ``analyze_dispatch``
  (what torch dispatches) as in ``analyze_hlo`` (the compiled HLO of the
  same function, printed with its operand shapes so the JAX parser reads
  each instruction's inputs as well as its output), at rel 1e-9.
- The pricer: views are free, an in-place op's buffer counts once, a
  kernel launch counts its own inputs and outputs, an async call's
  window is the compute dispatched between its issue and its wait.
- The engine at ``{data: 2}`` on a gloo pair, both packages' spec tables
  patched to one dict whose link makes every bucket's wire far below the
  compute: the port's bucketed ZeRO-2 exchange (8 reduce-scatters in
  ``fwd_bwd``, 4 all-gathers in ``apply_update``) against the JAX
  engine's step-wise programs (``fwd_bwd``, and ``cast_params``, which
  holds its all-gathers).  The reduce-scatter and all-gather nodes'
  counts, wire bytes and seconds, and the exposed seconds (the fill and
  drain, ``total / B`` under overlap; everything in the fused control)
  are equal at rel 1e-9, and so is ``fwd_bwd``'s whole summary wire and
  exposure (the loss count's all-reduce is in both).  Compared apart:
  the port's ``apply_update`` adds the step's stats all-reduce (12
  bytes), and the JAX fused control's gradient reduction is GSPMD's
  all-reduce and all-to-alls where the port reduce-scatters, so there
  the gather side's bytes and every node's serialization are compared.
  The per-node classification counts follow the issue order, which is
  the JAX scheduler's HLO order there and the backward's here: their
  totals are compared.  Losses with the ledger on are bitwise those
  without it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lib import xla_client as xc

import deepspeed_tpu as jds
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu.profiling import overlap as jov
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.profiling import overlap as ov
from deepspeed_tpu_torch.profiling.flops_profiler import kernel_launch
from deepspeed_tpu_torch.profiling.utilization import chip_specs

from . import torch_dp_workers as W
from . import torch_zero_workers as Z
from .torch_dist import run_ranks
from .torch_profiling_workers import (OVERLAP_CASES, overlap_runs,
                                      shared_chip_specs)

WORLD = 2
REL = 1e-12


def close(a, b, rel=REL, path=""):
    """``a`` equals ``b`` structurally, floats to ``rel``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            close(a[k], b[k], rel, f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, rel, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=rel, abs_tol=0.0) or a == b, \
            (path, a, b)
    else:
        assert a == b, (path, a, b)


SPECS = dict(chip_specs(""), ici_gbps=chip_specs("")["link_gbps"])


# ------------------------------------------------------- model functions
@pytest.mark.parametrize("seconds", [0.0, 1e-3, 2.5e-6])
@pytest.mark.parametrize("hidden", [0.0, 5e-7, 9.6e-4, 2e-3, -1.0])
@pytest.mark.parametrize("window", [None, 0.0, 1e-3])
def test_classify_is_the_jax_rule(seconds, hidden, window):
    for op in ("all-reduce-start", "reduce-scatter", "send"):
        args = dict(ins_op=op, kind=ov.KIND_COLLECTIVE, wire_bytes=4096,
                    seconds=seconds, hidden=hidden, window=window, index=7,
                    name="n")
        close(ov._classify(**args), jov._classify(**args))


def nodes_grid(n, with_windows=True):
    """``n`` collective nodes of mixed ops, sizes, windows and sources."""
    rng = np.random.default_rng(n)
    out = []
    for i in range(n):
        op = ("reduce-scatter", "all-gather", "all-reduce")[i % 3]
        secs = float(rng.uniform(1e-6, 5e-5))
        win = (None if not with_windows or i % 4 == 0
               else float(rng.uniform(0.0, 8e-5)))
        out.append({"index": int(rng.integers(0, 1000)), "name": f"c{i}",
                    "op": op, "kind": ov.KIND_COLLECTIVE,
                    "wire_bytes": int(secs * 1e11), "seconds": secs,
                    "hidden_seconds": 0.0, "window_seconds": win,
                    "classification": ov.SERIALIZED,
                    "source": "hlo" if i % 5 else "declared"})
    return out


@pytest.mark.parametrize("n", [0, 1, 5, 12])
def test_bucket_is_the_jax_count(n):
    nodes = nodes_grid(n)
    for i, node in enumerate(nodes):
        node["classification"] = (ov.OVERLAPPED, ov.PARTIAL,
                                  ov.SERIALIZED)[i % 3]
        node["kind"] = (ov.KIND_COLLECTIVE, ov.KIND_HOST, ov.KIND_P2P)[i % 2]
    for kind in (ov.KIND_COLLECTIVE, ov.KIND_HOST, ov.KIND_P2P):
        assert ov._bucket(nodes, kind) == jov._bucket(nodes, kind)


HOST_SCHEDULES = {
    "serialized": None,
    "overlap_off": {"overlap": False, "chunks": 4},
    "pipelined": {"overlap": True, "chunks": 6, "prefetch_depth": 2},
    "redundant_prefetch": {"overlap": True, "chunks": 8,
                           "prefetch_depth": 2,
                           "redundant_prefetch_chunks": 3},
    "grad_stream": {"overlap": True, "chunks": 4, "prefetch_depth": 2,
                    "grad_wire_bytes": 3 << 24},
}


@pytest.mark.parametrize("schedule", list(HOST_SCHEDULES))
@pytest.mark.parametrize("residual", [0, 1 << 20, 7 << 26])
@pytest.mark.parametrize("compute", [0.0, 1e-3, 0.5])
@pytest.mark.parametrize("excess", [0, 1 << 22])
def test_declared_stream_nodes_are_the_jax_nodes(schedule, residual,
                                                 compute, excess):
    sched = HOST_SCHEDULES[schedule]
    args = (residual, sched, compute, SPECS)
    close(ov._declared_stream_nodes(*args, hlo_excess_bytes=excess),
          jov._declared_stream_nodes(*args, hlo_excess_bytes=excess))


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("buckets", [1, 2, 8])
@pytest.mark.parametrize("compute", [1e-6, 1e-4, 1.0])
@pytest.mark.parametrize("windows", [True, False])
def test_apply_collective_schedule_is_the_jax_repricing(overlap, buckets,
                                                        compute, windows):
    nodes = nodes_grid(buckets + 3, with_windows=windows)
    sched = {"overlap": overlap, "rs_buckets": buckets,
             "ag_buckets": max(buckets // 2, 1)}
    mine = [dict(n) for n in nodes]
    theirs = [dict(n) for n in nodes]
    ov._apply_collective_schedule(mine, sched, compute)
    jov._apply_collective_schedule(theirs, sched, compute)
    close(mine, theirs)
    ov._apply_collective_schedule(mine, None, compute)
    close(mine, theirs)


# ------------------------------------------------------------- roofline
def hlo_with_operand_shapes(fn, *args):
    """The compiled module's HLO, printed with each operand's shape."""
    compiled = jax.jit(fn).lower(*args).compile()
    opts = xc._xla.HloPrintOptions()
    opts.print_operand_shape = True
    opts.print_metadata = False
    return compiled.runtime_executable().hlo_modules()[0].to_string(opts)


def priced(fn, *args):
    pricer = ov.DispatchPricer("cpu").start()
    try:
        out = fn(*args)
    finally:
        pricer.stop()
    return out, ov.analyze_dispatch(pricer.records(), specs=SPECS)


@pytest.mark.parametrize("kind", ["dot", "add"])
@pytest.mark.parametrize("shape", [(64, 128, 32), (256, 512, 384)])
def test_lone_op_prices_as_the_hlo_roofline(kind, shape, monkeypatch):
    monkeypatch.setattr(jov, "chip_specs", lambda kind="": dict(SPECS))
    m, k, n = shape
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) if kind == "dot"
         else rng.standard_normal((m, k))).astype(np.float32)

    def fn(x, y):
        return x @ y if kind == "dot" else x + y

    want = jov.analyze_hlo(hlo_with_operand_shapes(fn, a, b))
    out, got = priced(fn, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(out.numpy(), np.asarray(fn(a, b)))
    assert got["compute_seconds"] > 0
    close(got["compute_seconds"], want["compute_seconds"], rel=1e-9)
    close(got["critical_path_seconds"], want["critical_path_seconds"],
          rel=1e-9)


def test_views_are_free_and_an_inplace_buffer_counts_once():
    x = torch.randn(64, 32)
    y = torch.randn(64, 32)

    def fn(a, b):
        v = a.t()[1:].unsqueeze(0).expand(3, 31, 64)   # views only
        a.add_(b)                            # a read, b read, a written
        return v

    _, s = priced(fn, x.clone(), y)
    nbytes = x.numel() * 4
    assert s["op_bytes"] == {"add_": 2 * nbytes}
    close(s["compute_seconds"], 2 * nbytes / (SPECS["hbm_gbps"] * 1e9))


def test_kernel_launch_prices_its_own_inputs_and_outputs():
    """A launch counts its plain version's flops and only its own inputs
    and outputs as bytes (the softmax's intermediates are not)."""
    q = torch.randn(16, 64)
    k = torch.randn(64, 48)

    def plain(a, b):
        return torch.softmax(a @ b, dim=-1)

    pricer = ov.DispatchPricer("cpu").start()
    try:
        kernel_launch("K", plain, q, k)
    finally:
        pricer.stop()
    (_, name, flops, nbytes), = pricer.events
    assert name == "K"
    assert nbytes == (q.numel() + k.numel() + 16 * 48) * 4
    counter = ov._MetaFlops()
    with counter:
        plain(q.to("meta"), k.to("meta"))
    assert flops == counter.flops >= 2 * 16 * 64 * 48


def test_async_window_is_the_compute_between_issue_and_wait():
    x = torch.randn(128, 128)
    w = torch.randn(128, 128)
    pricer = ov.DispatchPricer("cpu").start()
    try:
        comm.counter.add("all_reduce", 4096, 2)                 # blocking
        waits = comm.counter.add("reduce_scatter", 1 << 20, 2,
                                 async_op=True)
        y = x @ w
        y = y + x
        for done in waits:
            done()
        z = y * 2
        sends = comm.counter.add("send", 512, 2, async_op=True)
        comm.counter.add("recv", 512, 2)
        for done in sends:
            done()
    finally:
        pricer.stop()
    del z
    specs = dict(SPECS, link_gbps=1.0)   # slow: nothing hides fully
    s = ov.analyze_dispatch(pricer.records(), specs=specs, max_nodes=None)
    by_op = {n["op"]: n for n in s["nodes"]}
    ar, rs = by_op["all-reduce"], by_op["reduce-scatter"]
    assert ar["classification"] == ov.SERIALIZED
    assert ar["window_seconds"] is None and ar["hidden_seconds"] == 0.0
    between = (ov.op_seconds(2 * 128 ** 3, 3 * x.numel() * 4, specs)
               + ov.op_seconds(x.numel(), 3 * x.numel() * 4, specs))
    close(rs["hidden_seconds"], between)
    assert rs["classification"] == ov.PARTIAL
    assert by_op["send"]["kind"] == by_op["recv"]["kind"] == ov.KIND_P2P
    assert by_op["send"]["window_seconds"] is None   # nothing between
    assert s["p2p_transfers"]["total"] == 2
    assert s["hlo_transfer_summary"]["p2p_transfer_bytes"] == 1024
    close(s["compute_seconds"], between + ov.op_seconds(
        x.numel(), 2 * x.numel() * 4, specs))
    assert comm.counter.trackers == []


# --------------------------------------------------------- engine, dp=2
@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("overlap")
    return run_ranks(overlap_runs, WORLD, root / "ranks", str(root))


def jax_engine(config):
    mesh = jax_mesh({"data": WORLD}, devices=jax.devices("cpu")[:WORLD])
    _, params = W.model_and_params("gpt2")
    engine, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JConfig(**W.TINY)),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=dict(config), mesh=mesh)
    return engine


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's step-wise programs (forward, backward, step) on
    the global batches the port's ranks slice, under the shared specs."""
    saved = jov.chip_specs
    jov.chip_specs = shared_chip_specs
    try:
        out = {}
        for label, on in OVERLAP_CASES:
            engine = jax_engine(Z.zero_config(
                2, on, 1, 0.0, WORLD, profiling={"comm_ledger": True}))
            for b in Z.gpt2_global(2, WORLD):
                engine.backward(engine.forward(b))
                engine.step()
            out[label] = {"entries": engine.comm_ledger.entries(),
                          "schedule": engine.collective_schedule()}
        return out
    finally:
        jov.chip_specs = saved


def exchange(nodes, op):
    return [n for n in nodes if n["op"] == op]


def exposed(nodes):
    return sum(n["seconds"] - n["hidden_seconds"] for n in nodes)


@pytest.mark.parametrize("label", [c[0] for c in OVERLAP_CASES])
def test_dp2_exchange_prices_as_the_jax_engine(port_runs, jax_runs, label):
    want = jax_runs[label]
    jfb = want["entries"]["fwd_bwd"]["overlap"]
    jcast = want["entries"]["cast_params"]["overlap"]
    overlap = dict(OVERLAP_CASES)[label]
    for rank in port_runs:
        got = rank[label]
        fb = got["entries"]["fwd_bwd"]["overlap"]
        apply = got["entries"]["apply_update"]["overlap"]
        assert got["losses"] == got["plain_losses"]
        sched = got["schedule"]
        assert sched == want["schedule"], (sched, want["schedule"])
        # the gather side: the JAX cast_params against the port's apply
        j_ag, p_ag = (exchange(jcast["nodes"], "all-gather"),
                      exchange(apply["nodes"], "all-gather"))
        assert len(p_ag) == len(j_ag) == (sched["ag_buckets"] if overlap
                                          else 1)
        assert sorted(n["wire_bytes"] for n in p_ag) == \
            sorted(n["wire_bytes"] for n in j_ag)
        close(sum(n["seconds"] for n in p_ag),
              sum(n["seconds"] for n in j_ag), rel=1e-9)
        close(exposed(p_ag), exposed(j_ag), rel=1e-9)
        # the stats all-reduce: the port's step only
        extra = exchange(apply["nodes"], "all-reduce")
        assert [n["wire_bytes"] for n in extra] == [12]
        assert apply["collectives"]["total"] == len(p_ag) + 1
        if overlap:
            total = sum(n["seconds"] for n in p_ag)
            close(exposed(p_ag), total / len(p_ag), rel=1e-9)
            # the scatter side and fwd_bwd's whole summary
            j_rs, p_rs = (exchange(jfb["nodes"], "reduce-scatter"),
                          exchange(fb["nodes"], "reduce-scatter"))
            assert len(p_rs) == len(j_rs) == sched["rs_buckets"]
            assert sorted(n["wire_bytes"] for n in p_rs) == \
                sorted(n["wire_bytes"] for n in j_rs)
            close(exposed(p_rs), sum(n["seconds"] for n in p_rs)
                  / len(p_rs), rel=1e-9)
            for key in ("wire_seconds", "exposed_wire_seconds",
                        "overlap_fraction"):
                close(fb[key], jfb[key], rel=1e-9)
            assert fb["collectives"]["total"] == \
                jfb["collectives"]["total"]
            assert got["entries"]["fwd_bwd"]["wire_bytes"] == \
                want["entries"]["fwd_bwd"]["wire_bytes"]
            assert {n["source"] for n in p_rs + p_ag} == {"hlo+declared"}
        else:
            # the control: every wire second exposed in both packages
            for s in (fb, apply, jfb, jcast):
                assert s["overlap_fraction"] == 0.0
                close(s["exposed_wire_seconds"], s["wire_seconds"])
            for n in p_ag + exchange(fb["nodes"], "reduce-scatter"):
                assert n["classification"] == ov.SERIALIZED
                assert n["source"] == "hlo+declared"
        receipt = got["receipt"]
        close(receipt["wire_seconds"], fb["wire_seconds"]
              + apply["wire_seconds"])
        close(receipt["exposed_wire_seconds"],
              fb["exposed_wire_seconds"] + apply["exposed_wire_seconds"])
        assert got["comm_receipt"]["wire_bytes"] == (
            got["entries"]["fwd_bwd"]["wire_bytes"]
            + got["entries"]["apply_update"]["wire_bytes"])


def test_dp2_control_declares_the_potential_window(port_runs, jax_runs):
    """The fused control's gathers record what the declared buckets
    could have hidden, ``compute × (B-1)/B`` of their program (the JAX
    node keeps its dependency-graph window where that is larger; the
    port's blocking gather has none)."""
    sched = jax_runs["fused"]["schedule"]
    b = sched["rs_buckets"] + sched["ag_buckets"]
    jcast = jax_runs["fused"]["entries"]["cast_params"]["overlap"]
    for n in exchange(jcast["nodes"], "all-gather"):
        assert n["window_seconds"] >= jcast["compute_seconds"] * (b - 1) / b
    for rank in port_runs:
        s = rank["fused"]["entries"]["apply_update"]["overlap"]
        for n in exchange(s["nodes"], "all-gather"):
            close(n["window_seconds"], s["compute_seconds"] * (b - 1) / b)
