"""The port's memory observability (``deepspeed_tpu_torch/profiling/memory``)
against the JAX package's (``deepspeed_tpu/profiling/memory``): watermark
events at the print cadence, the cross-device summary (on fake devices,
as the JAX test does), ``see_memory_usage`` and the timers through it,
the offload host-buffer registry's family totals equal to the JAX
registry's, the ledger's entry points in the training and the serving
engine, and the disabled ledger handing the function back.  The tests
run on CPU tensors, where the measured entries are None (the summary
reports ``reporting: 0``); chip_smoke.py's phase 43 holds the measured
numbers on the card."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadTPU
from deepspeed_tpu.parallel import make_mesh
from deepspeed_tpu.profiling import memory as jmem
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.profiling import memory as mem
from deepspeed_tpu_torch.telemetry import read_events, validate_event
from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(run_dir=None, **overrides):
    cfg = {"train_batch_size": 2, "steps_per_print": 1,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "profiling": {"memory_ledger": True, "memory_watermarks": True}}
    if run_dir is not None:
        cfg["telemetry"] = {"enabled": True, "run_dir": str(run_dir)}
    cfg.update(overrides)
    return cfg


def engine_of(cfg, params=None):
    engine, *_ = tds.initialize(model=GPT2LMHead(GPT2Config(**TINY)),
                                model_parameters=params, config=cfg,
                                device="cpu")
    return engine


def steps(engine, n):
    ids = np.random.default_rng(0).integers(0, 256, (2, 16))
    return [float(engine.train_batch(iter([{"input_ids": ids}])))
            for _ in range(n)]


@pytest.mark.parametrize("every,n,want", [(1, 3, [1, 2, 3]),
                                          (2, 4, [2, 4])])
def test_watermark_events_at_print_cadence(tmp_path, every, n, want):
    """One ``memory``/watermark event per ``steps_per_print`` boundary,
    honest about the device: a CPU engine reports no stats, so
    ``reporting`` is 0 and the sums stay 0 rather than fabricated."""
    engine = engine_of(config(tmp_path, steps_per_print=every))
    steps(engine, n)
    engine.close()
    marks = [r for r in read_events(tmp_path) if r["type"] == "memory"
             and r["data"]["kind"] == "watermark"]
    assert [m["step"] for m in marks] == want
    for m in marks:
        assert validate_event(m) == []
        data = m["data"]
        assert {"bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                "devices", "reporting", "host_buffer_bytes"} <= set(data)
        assert data["reporting"] == 0 and data["bytes_in_use"] == 0


def test_watermarks_need_telemetry():
    engine = engine_of(config())
    assert not engine._memory_watermarks
    engine.close()


class _FakeDev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_memory_summary_sums_across_devices():
    """The JAX test's fakes give the JAX summary's dict."""
    stats = [{"bytes_in_use": 10, "peak_bytes_in_use": 20,
              "bytes_limit": 100},
             {"bytes_in_use": 1, "peak_bytes_in_use": 2,
              "bytes_limit": 100}, None]
    want = {"bytes_in_use": 11, "peak_bytes_in_use": 22,
            "bytes_limit": 200, "devices": 3, "reporting": 2}
    assert mem.device_memory_summary([_FakeDev(s) for s in stats]) == want
    assert jmem.device_memory_summary([_FakeDev(s) for s in stats]) == want


def test_summary_without_a_card_reports_nothing():
    """``devices=None`` on a machine without a card: no device, nothing
    reporting (the CPU's memory is not read in its place); a CPU device
    asked for explicitly reports no stats."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert mem.device_memory_summary() == {
        "bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0,
        "devices": 0, "reporting": 0}
    assert mem.device_memory_summary(["cpu"])["reporting"] == 0


def test_see_memory_usage_routes_through_shared_helper(monkeypatch):
    fake = {"bytes_in_use": 3 << 30, "peak_bytes_in_use": 5 << 30,
            "bytes_limit": 32 << 30, "devices": 2, "reporting": 2}
    monkeypatch.setattr(mem, "device_memory_summary",
                        lambda devices=None: dict(fake))
    messages = []
    handler = logging.Handler()
    handler.emit = lambda rec: messages.append(rec.getMessage())
    mem.logger.addHandler(handler)
    try:
        mem.see_memory_usage("after step", force=True)
        mem.see_memory_usage("quiet")          # force=False: no output
    finally:
        mem.logger.removeHandler(handler)
    assert len(messages) == 1
    assert "after step" in messages[0]
    assert "5.0000 GB" in messages[0] and "2/2 local device(s)" \
        in messages[0]
    assert "2/2 local device(s)" in SynchronizedWallClockTimer.memory_usage()


def host_families(registry):
    return {e["family"]: e["bytes"] for e in registry.entries()}


@pytest.mark.parametrize("opt", ["Adam", "Lamb"])
def test_host_buffer_registry_totals_equal_the_jax_registry(cpu_devices,
                                                            opt):
    """Under ZeRO-Offload the registry lists the pinned host state by
    family (the master and the two flat moments), and each family's
    bytes equal the JAX registry's for the same model and config, row
    for row: the JAX layout pads the offloaded rows to a multiple of 64
    (a libtpu rule, ``deepspeed_tpu/runtime/zero/coordinator.py:191-196``)
    that the port does not carry, so its totals are the port's over its
    padded rows.  The JAX family names carry the attribute path's dot
    (``opt/.exp_avg``).  Counts may differ: the JAX coordinator groups
    rows into several host buffers where the port holds one a family.
    (``offload_gradients`` needs the JAX in-jit host placement, which
    the JAX CPU backend lacks.)"""
    cfg = config(zero_optimization={"stage": 2, "cpu_offload": True},
                 optimizer={"type": opt, "params": {"lr": 1e-3}})
    params = random_params(GPT2Config(**TINY), seed=0)
    port = engine_of(cfg, params)
    # the JAX engine registers its host buffers whatever its ledger's
    # setting; its ledger's AOT compile of the offload programs needs a
    # backend with a host memory space, which the JAX CPU backend lacks
    jcfg = dict(cfg, profiling={"memory_ledger": False})
    jengine, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JGPT2Config(**TINY)),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=jcfg, mesh=make_mesh({"data": 1}, devices=cpu_devices[:1]))
    got = host_families(port.memory_ledger.host_buffers)
    want = {k.replace("opt/.", "opt/"): v for k, v in
            host_families(jengine.memory_ledger.host_buffers).items()}
    rows, jrows = port.flat.segments.rows, jengine.segments.rows
    assert jrows == -(-rows // 64) * 64
    assert set(got) == set(want) == {"master", "opt/exp_avg",
                                     "opt/exp_avg_sq"}
    for family in got:
        assert got[family] * jrows == want[family] * rows
    assert port.memory_ledger.host_buffers.total_bytes() == sum(got.values())
    port.close()


def test_ledger_wraps_the_engine_entry_points():
    """The forward, backward and optimizer apply go through the ledger
    (their first call recorded; on the CPU with no numbers), and a run
    with the ledger trains bitwise the run without it."""
    engine = engine_of(config())
    off = engine_of(config(profiling={"memory_ledger": False}))
    assert steps(engine, 3) == steps(off, 3)
    entries = engine.memory_ledger.entries()
    assert set(entries) == {"forward", "backward", "apply_update"}
    assert all(e is None for e in entries.values())
    assert off.memory_ledger.entries() == {}
    assert not isinstance(off._loss, mem._LedgeredCall)
    engine.close()
    off.close()


def test_ledger_records_the_serving_entry_points():
    model = GPT2LMHead(GPT2Config(**TINY))
    engine = InferenceEngine(
        model, random_params(GPT2Config(**TINY), seed=0), device="cpu",
        config={"inference": {"kv_block_size": 8, "max_seq_len": 64,
                              "prefill_buckets": [16, 32],
                              "max_batch_slots": 2, "kv_blocks": 32,
                              "token_budget": 256, "max_new_tokens": 4},
                "profiling": {"memory_ledger": True}})
    for i, n in enumerate((10, 20)):
        engine.submit(list(range(1, n + 1)), request_id=f"r{i}")
    engine.run()
    entries = engine.memory_ledger.entries()
    assert set(entries) == {"serve_prefill_16", "serve_prefill_32",
                            "serve_decode"}
    assert engine.serving_receipt()["programs_compiled"] == 3
    engine.close()


def test_disabled_ledger_returns_raw_fn():
    ledger = mem.MemoryLedger(enabled=False)

    def fn(x):
        return x

    assert ledger.wrap("f", fn) is fn
    assert ledger.entries() == {}


def test_ledger_records_each_entry_point_once():
    """The first call is recorded (None: no stats on this device), later
    calls are the function itself; results pass through unchanged."""
    ledger = mem.MemoryLedger(enabled=True, device=torch.device("cpu"))
    calls = []

    def double(x):
        calls.append(x)
        return x * 2

    wrapped = ledger.wrap("double", double)
    assert wrapped(3) == 6 and wrapped(4) == 8 and len(calls) == 2
    assert ledger.entries() == {"double": None}
    assert wrapped.wrapped is double


def test_measured_entry_fields():
    """A recorded entry emits the JAX field names it has a meaning for,
    and ``predicted_peak_bytes`` reads the measured peak."""
    entry = {"argument_size_in_bytes": 10, "output_size_in_bytes": 2,
             "temp_size_in_bytes": 5, "peak_bytes_in_use": 15,
             "bytes_in_use_after": 12}
    assert set(entry) == set(mem.ENTRY_FIELDS)
    assert mem.predicted_peak_bytes(entry) == 15
    assert mem.predicted_peak_bytes(None) is None
    ledger = mem.MemoryLedger()
    ledger.record("p", entry)
    assert ledger.predicted_peak_bytes("p") == 15
    assert ledger.predicted_temp_bytes("p") == 5
