"""The port's resilience subsystem (``deepspeed_tpu_torch/resilience``) on
the CPU: every test of the JAX package's ``tests/unit/test_resilience.py``,
ported to the torch engine.  Anomaly-guard policies, divergence rollback
with its budget and cooldown, abort, the in-flight commit, corrupt, torn
and crash-mid-save checkpoints, SIGTERM, the step watchdog, auto_resume
and the loss scaler's floor hook.

The JAX file builds each engine on a dp=4 mesh; the port runs at one
data-parallel rank (ROADMAP A5), so every engine here is dp=1.  All 27
tests run at one rank: none of them asserts anything about the other
replicas, and the fleet integrity plane (fingerprint consensus, the hang
quorum), which would, is ROADMAP A15's second half and has no test in
that file.  The model is the JAX file's SimpleModel in torch
(``torch_simple_model.py``: float inputs, so a NaN batch reaches the
loss and the gradients)."""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as deepspeed
from deepspeed_tpu_torch import checkpoint as ckpt
from deepspeed_tpu_torch.profiling.step_profiler import StepLatencyRing
from deepspeed_tpu_torch.resilience import (EXIT_DIVERGENCE_ABORT,
                                            EXIT_STEP_HANG, ChaosMonkey,
                                            TrainingDivergedError)
from deepspeed_tpu_torch.resilience.config import DeepSpeedResilienceConfig
from deepspeed_tpu_torch.resilience.guard import (ACTION_ABORT, ACTION_NONE,
                                                  ACTION_ROLLBACK,
                                                  AnomalyGuard)
from deepspeed_tpu_torch.resilience.watchdog import StepWatchdog
from deepspeed_tpu_torch.runtime.config import config_issues

from .torch_simple_model import SimpleModel, base_config, random_batches

HIDDEN = 16


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def res_config(checkpoint=None, **resilience):
    resilience.setdefault("enabled", True)
    cfg = base_config(resilience=resilience)
    if checkpoint is not None:
        cfg["checkpoint"] = checkpoint
    return cfg


def make_engine(config, **kwargs):
    engine, *_ = deepspeed.initialize(model=SimpleModel(HIDDEN, nlayers=2),
                                      config=config, device="cpu", **kwargs)
    return engine


def run_steps(engine, batches):
    return [float(engine.train_batch(iter([b]))) for b in batches]


def master_np(engine):
    return engine.master.numpy().copy()


# --------------------------------------------------------------- config
def test_resilience_config_defaults_and_parse():
    cfg = DeepSpeedResilienceConfig({})
    assert not cfg.enabled and cfg.policy == "skip"
    assert cfg.divergence_patience == 3 and cfg.max_rollbacks == 2
    assert cfg.hang_timeout_secs == 0.0 and cfg.checkpoint_dir is None
    cfg = DeepSpeedResilienceConfig({"resilience": {
        "enabled": True, "policy": "rollback", "spike_window": 32,
        "spike_zscore": 4.0, "divergence_patience": 2, "max_rollbacks": 1,
        "rollback_cooldown_steps": 10, "hang_timeout_secs": 120,
        "floor_scale_patience": 4, "checkpoint_dir": "/ckpt"}})
    assert cfg.enabled and cfg.policy == "rollback"
    assert cfg.spike_window == 32 and cfg.divergence_patience == 2
    assert cfg.hang_timeout_secs == 120 and cfg.checkpoint_dir == "/ckpt"
    with pytest.raises(AssertionError, match="policy"):
        DeepSpeedResilienceConfig({"resilience": {"policy": "explode"}})


def test_resilience_block_in_config_schema():
    """The block rides the config schema: misspelled sub-keys get a
    'did you mean' instead of being silently ignored (the JAX test reads
    dslint's ``validate_config_dict``; the port's checks are
    ``config_issues``)."""
    issues = config_issues({"resilience": {"polcy": "skip"}})
    assert len(issues) == 1 and "did you mean 'policy'" in issues[0]
    assert not config_issues(
        {"resilience": {"enabled": True, "policy": "abort",
                        "hang_timeout_secs": 60}})


# ---------------------------------------------------------------- guard
def test_guard_nonfinite_and_policy_escalation():
    g = AnomalyGuard(policy="rollback", divergence_patience=3)
    assert g.observe(1.0, False) is ACTION_NONE
    assert g.observe(float("nan"), False) is ACTION_NONE   # 1
    assert g.observe(1.0, True) is ACTION_NONE             # 2
    assert g.observe(1.0, True) is ACTION_ROLLBACK         # 3 = patience
    g.notify_rollback()
    assert g.consecutive_anomalies == 0
    ab = AnomalyGuard(policy="abort", divergence_patience=1)
    assert ab.observe(float("inf"), False) is ACTION_ABORT


def test_guard_skip_policy_never_escalates():
    g = AnomalyGuard(policy="skip", divergence_patience=1)
    for _ in range(5):
        assert g.observe(float("nan"), True) is ACTION_NONE
    assert g.total_anomalies == 5


def test_guard_loss_spike_zscore():
    g = AnomalyGuard(policy="abort", divergence_patience=1,
                     spike_window=32, spike_zscore=6.0)
    for i in range(12):
        assert g.observe(1.0 + 0.01 * (i % 3), False) is ACTION_NONE
    assert g.observe(100.0, False) is ACTION_ABORT
    assert g.recent_events()[-1][1] == "loss_spike"
    # spiky losses never enter the window: the baseline stays clean
    assert max(g._window) < 2.0


def test_guard_spike_detection_disabled_by_zero_window():
    g = AnomalyGuard(policy="abort", divergence_patience=1, spike_window=0)
    for _ in range(20):
        assert g.observe(1.0, False) is ACTION_NONE
    assert g.observe(1e9, False) is ACTION_NONE  # only non-finite counts


def test_guard_scale_floor_event():
    g = AnomalyGuard(policy="skip", floor_scale_patience=3, min_scale=1.0,
                     fp16=True)
    for _ in range(2):
        g.observe(1.0, True, scale=1.0)
    assert all(k != "scale_floor" for _, k, _ in g.recent_events())
    g.observe(1.0, True, scale=1.0)  # 3rd consecutive floor overflow
    assert any(k == "scale_floor" for _, k, _ in g.recent_events())
    # recovery resets the counter
    g.observe(1.0, False, scale=1.0)
    assert g._floor_overflows == 0


# ------------------------------------------------------- engine + guard
def test_engine_skip_policy_protects_weights():
    """A NaN batch under policy=skip: the step skips the update for a
    NON-fp16 run (fp32 here), weights/optimizer are untouched, the
    skipped counter advances, and training continues cleanly."""
    e = make_engine(res_config(policy="skip"))
    batches = random_batches(4, 16, HIDDEN, seed=0)
    run_steps(e, batches[:1])
    before = master_np(e)
    chaos = ChaosMonkey()
    loss = run_steps(e, [chaos.nan_batch(batches[1])])[0]
    assert not np.isfinite(loss)
    np.testing.assert_array_equal(master_np(e), before)
    assert e.skipped_steps == 1
    assert np.isfinite(run_steps(e, batches[2:3])[0])
    assert np.isfinite(master_np(e)).all()
    kinds = [k for _, k, _ in e._guard.recent_events()]
    assert kinds == ["nonfinite_grads"]


def test_engine_guard_happy_path_unchanged():
    """Guard on vs off: identical losses on clean data (the non-finite
    check changes nothing numerically)."""
    batches = random_batches(3, 16, HIDDEN, seed=2)
    ref = run_steps(make_engine(base_config()), batches)
    got = run_steps(make_engine(res_config(policy="skip")), batches)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


# ----------------------------------------------------- chaos: rollback
def test_chaos_nan_rollback_end_to_end(tmp_path):
    """THE acceptance chaos test: injected NaN gradients under
    policy=rollback restore from the last committed checkpoint and the
    run continues to completion — post-rollback losses match a fault-free
    reference run exactly."""
    clean = random_batches(6, 16, HIDDEN, seed=3)
    cfg = res_config(policy="rollback", divergence_patience=2,
                     max_rollbacks=1)

    # fault-free reference: steps 1-2, then the 4 "after" batches
    ref_engine = make_engine(cfg)
    run_steps(ref_engine, clean[:2])
    ref_losses = run_steps(ref_engine, clean[2:])

    e = make_engine(cfg)
    run_steps(e, clean[:2])
    e.save_checkpoint(str(tmp_path), sync=True)
    chaos = ChaosMonkey(seed=0)
    # data plan mirrors a resumed dataloader: the two faulted batches are
    # retrained post-rollback, so the recovered run sees exactly the
    # reference's step 3..6 data
    it = chaos.wrap_iter(iter([clean[2], clean[3]] + clean[2:]),
                         nan_steps=(0, 1))
    # pulls 0,1 are NaN -> two consecutive anomalies -> rollback to
    # step 2 inside the second train_batch; pulls 2.. are clean
    nan_losses = [float(e.train_batch(it)) for _ in range(2)]
    assert not any(np.isfinite(nan_losses))
    assert e._rollback_mgr.rollbacks_used == 1
    assert e.global_steps == 2          # rewound to the checkpoint
    assert e.skipped_steps == 0         # counter restored too
    got = [float(e.train_batch(it)) for _ in range(4)]
    np.testing.assert_allclose(got, ref_losses, rtol=1e-6)
    assert e.global_steps == 6
    assert [k for _, k in chaos.log] == ["nan", "nan"]


def test_rollback_budget_exhaustion_aborts(tmp_path):
    e = make_engine(res_config(policy="rollback", divergence_patience=1,
                               max_rollbacks=0))
    batches = random_batches(2, 16, HIDDEN, seed=4)
    run_steps(e, batches[:1])
    e.save_checkpoint(str(tmp_path), sync=True)
    chaos = ChaosMonkey()
    with pytest.raises(TrainingDivergedError, match="budget") as exc:
        run_steps(e, [chaos.nan_batch(batches[1])])
    assert exc.value.exit_code == EXIT_DIVERGENCE_ABORT


def test_rollback_without_checkpoint_aborts():
    e = make_engine(res_config(policy="rollback", divergence_patience=1))
    batches = random_batches(2, 16, HIDDEN, seed=5)
    run_steps(e, batches[:1])
    chaos = ChaosMonkey()
    with pytest.raises(TrainingDivergedError, match="no checkpoint"):
        run_steps(e, [chaos.nan_batch(batches[1])])


def test_abort_policy_raises_poison():
    e = make_engine(res_config(policy="abort", divergence_patience=2))
    batches = random_batches(3, 16, HIDDEN, seed=6)
    run_steps(e, batches[:1])
    chaos = ChaosMonkey()
    run_steps(e, [chaos.nan_batch(batches[1])])  # 1st anomaly: tolerated
    with pytest.raises(TrainingDivergedError, match="diverged") as exc:
        run_steps(e, [chaos.nan_batch(batches[2])])
    assert exc.value.exit_code == EXIT_DIVERGENCE_ABORT


def test_rollback_waits_for_inflight_commit(tmp_path):
    """Divergence right after an ASYNC save: rollback must drain the
    in-flight commit and restore it, not race it."""
    e = make_engine(res_config(policy="rollback", divergence_patience=1))
    batches = random_batches(3, 16, HIDDEN, seed=7)
    run_steps(e, batches[:2])
    chaos = ChaosMonkey()
    gate = threading.Event()
    with chaos.delayed_commit(gate=gate):
        e.save_checkpoint(str(tmp_path))          # async, held by chaos
        threading.Timer(0.3, gate.set).start()
        run_steps(e, [chaos.nan_batch(batches[2])])
    assert e._rollback_mgr.rollbacks_used == 1
    assert e.global_steps == 2
    assert ckpt.read_latest(str(tmp_path)) == "global_step2"


def test_rollback_rejects_corrupt_checkpoint(tmp_path):
    """Bit-rot in the only checkpoint: verify_on_load refuses it and the
    rollback escalates to a loud abort instead of restoring garbage."""
    e = make_engine(res_config(policy="rollback", divergence_patience=1))
    batches = random_batches(2, 16, HIDDEN, seed=8)
    run_steps(e, batches[:1])
    e.save_checkpoint(str(tmp_path), sync=True)
    chaos = ChaosMonkey(seed=1)
    chaos.corrupt_checkpoint(str(tmp_path / "global_step1"))
    with pytest.raises(TrainingDivergedError, match="no loadable"):
        run_steps(e, [chaos.nan_batch(batches[1])])


def test_chaos_torn_tmp_dir_is_harmless_and_swept(tmp_path):
    e = make_engine(res_config())
    run_steps(e, random_batches(1, 16, HIDDEN, seed=9))
    e.save_checkpoint(str(tmp_path), sync=True)
    chaos = ChaosMonkey()
    torn = chaos.torn_tmp_dir(str(tmp_path), "global_step9")
    # the torn dir never loads nor shadows `latest`
    assert ckpt.verify_checkpoint(torn)[0] == "bad"
    path, _ = e.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("global_step1")
    # the next committed save sweeps the wreckage
    run_steps(e, random_batches(1, 16, HIDDEN, seed=10))
    e.save_checkpoint(str(tmp_path), sync=True)
    assert not os.path.exists(torn)


def test_chaos_crash_mid_save_keeps_previous(tmp_path):
    e = make_engine(res_config(checkpoint={"save_retries": 0,
                                           "retry_backoff_secs": 0.0}))
    batches = random_batches(2, 16, HIDDEN, seed=11)
    run_steps(e, batches[:1])
    e.save_checkpoint(str(tmp_path), sync=True)
    chaos = ChaosMonkey()
    run_steps(e, batches[1:])
    with chaos.crash_mid_save():
        with pytest.raises(ckpt.CheckpointError):
            e.save_checkpoint(str(tmp_path), sync=True)
    assert ckpt.read_latest(str(tmp_path)) == "global_step1"
    assert chaos.log[-1][1] == "crash_mid_save"


def test_chaos_sigterm_takes_preemption_save(tmp_path):
    """Synthetic preemption mid-epoch: the SIGTERM drain commits a final
    synchronous checkpoint at the current step before shutdown."""
    from deepspeed_tpu_torch.checkpoint import manager as mgr_mod

    old = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    cbs_before = list(mgr_mod._PREEMPT_CALLBACKS)
    prev_before = dict(mgr_mod._PREEMPT_PREVIOUS)
    try:
        cfg = res_config(checkpoint={"save_on_preemption": True})
        e = make_engine(cfg)
        batches = random_batches(3, 16, HIDDEN, seed=12)
        run_steps(e, batches[:1])
        e.save_checkpoint(str(tmp_path), sync=True)
        chaos = ChaosMonkey()
        it = chaos.wrap_iter(iter(batches[1:]), sigterm_steps=(1,))
        for _ in range(2):
            e.train_batch(it)
        # the SIGTERM fired before pull 1's step; the preemption handler
        # committed global_step2 synchronously at that point
        assert (0, "sigterm") not in chaos.log
        assert (1, "sigterm") in chaos.log
        assert ckpt.read_latest(str(tmp_path)) == "global_step2"
        assert e.global_steps == 3
    finally:
        mgr_mod._PREEMPT_CALLBACKS[:] = cbs_before
        mgr_mod._PREEMPT_PREVIOUS.clear()
        mgr_mod._PREEMPT_PREVIOUS.update(prev_before)
        signal.signal(signal.SIGTERM, old)


def test_chaos_schedule_is_seed_deterministic():
    a = ChaosMonkey(seed=7).schedule_steps(100, 5)
    b = ChaosMonkey(seed=7).schedule_steps(100, 5)
    c = ChaosMonkey(seed=8).schedule_steps(100, 5)
    assert a == b and len(a) == 5
    assert all(0 <= s < 100 for s in a)
    assert a != c  # different seed, different schedule (overwhelmingly)


# ------------------------------------------------------------ watchdog
def test_watchdog_trips_dumps_and_exits(tmp_path):
    ring = StepLatencyRing(capacity=8)
    for s in (0.1, 0.2, 0.15):
        ring.record(s)
    codes = []
    dump_path = tmp_path / "dump.txt"
    with open(dump_path, "w") as dump:
        wd = StepWatchdog(timeout_secs=0.3, poll_interval=0.05,
                          exit_fn=codes.append, dump_file=dump,
                          latency_ring=ring,
                          describe=lambda: "global_step=7").start()
        try:
            wd.beat()
            # wait on the exit hook, not `fired`: the dump runs between
            # the flag flip and the exit call
            deadline = time.monotonic() + 10
            while not codes and time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            wd.stop()
    assert codes == [EXIT_STEP_HANG]
    text = dump_path.read_text()
    assert "step watchdog" in text and "global_step=7" in text
    assert "mean=" in text            # latency ring summary
    assert "Current thread" in text or "Thread" in text  # faulthandler


def test_watchdog_arms_only_after_first_beat():
    codes = []
    wd = StepWatchdog(timeout_secs=0.1, poll_interval=0.02,
                      exit_fn=codes.append).start()
    time.sleep(0.4)   # long set-up before step 1: must NOT fire
    assert not wd.fired and not codes
    wd.stop()


def test_engine_hung_step_trips_watchdog(tmp_path):
    """End-to-end through engine config: a chaos-injected step hang
    stalls the heartbeat; the watchdog dumps stacks + step latencies and
    fires the (injected) exit with the respawnable code."""
    e = make_engine(res_config(policy="skip", hang_timeout_secs=0.5))
    assert e._watchdog is not None
    codes = []
    dump_path = tmp_path / "dump.txt"
    dump = open(dump_path, "w")
    e._watchdog._exit_fn = codes.append   # keep pytest alive
    e._watchdog._dump_file = dump
    try:
        batches = random_batches(3, 16, HIDDEN, seed=13)
        run_steps(e, batches[:1])         # first beat arms the watchdog
        chaos = ChaosMonkey()
        it = chaos.wrap_iter(iter(batches[1:]), hang_steps=(0,),
                             hang_secs=1.5)
        e.train_batch(it)                 # hangs 1.5s > 0.5s timeout
        deadline = time.monotonic() + 10
        while not codes and time.monotonic() < deadline:
            time.sleep(0.05)
        assert codes == [EXIT_STEP_HANG]
        assert (0, "hang") in chaos.log
    finally:
        e._watchdog.stop()
        dump.close()
    text = dump_path.read_text()
    assert "step watchdog" in text and "global_step=1" in text


def test_abort_stops_watchdog_before_raising():
    """A divergence abort's teardown (final saves, sys.exit with the
    POISON code) must not race the watchdog's RESPAWNABLE os._exit."""
    e = make_engine(res_config(policy="abort", divergence_patience=1,
                               hang_timeout_secs=60))
    assert e._watchdog is not None
    codes = []
    e._watchdog._exit_fn = codes.append
    batches = random_batches(2, 16, HIDDEN, seed=15)
    run_steps(e, batches[:1])
    chaos = ChaosMonkey()
    with pytest.raises(TrainingDivergedError):
        run_steps(e, [chaos.nan_batch(batches[1])])
    assert e._watchdog._stop.is_set()     # disarmed for the teardown
    assert not codes


# ---------------------------------------------------------- auto_resume
def test_auto_resume_from_latest_pointer(tmp_path):
    cfg = res_config(policy="rollback", checkpoint_dir=str(tmp_path))
    e = make_engine(cfg)
    batches = random_batches(4, 16, HIDDEN, seed=14)
    run_steps(e, batches[:2])
    e.save_checkpoint(str(tmp_path), sync=True)
    ref_post = run_steps(e, batches[2:])

    e2 = make_engine(cfg, auto_resume=True)
    assert e2.global_steps == 2
    np.testing.assert_allclose(run_steps(e2, batches[2:]), ref_post,
                               rtol=1e-6)
    # rollback source defaults to the auto-resume dir: usable immediately
    assert e2._rollback_mgr._load_dir() == str(tmp_path)


def test_auto_resume_fresh_start_when_no_checkpoint(tmp_path):
    cfg = res_config(checkpoint_dir=str(tmp_path / "empty"))
    e = make_engine(cfg, auto_resume=True)
    assert e.global_steps == 0
    assert np.isfinite(run_steps(e, random_batches(1, 16, HIDDEN))[0])


# ------------------------------------------------- loss-scaler satellite
def test_dynamic_loss_scaler_floor_warning_and_hook():
    from deepspeed_tpu_torch.runtime.fp16.loss_scaler import \
        DynamicLossScaler

    events = []
    s = DynamicLossScaler(init_scale=4, min_scale=1, floor_patience=3,
                          anomaly_hook=events.append)
    for _ in range(6):
        s.update_scale(True)
    # scale path: 4 -> 2 -> 1 (floor) -> three more floor overflows
    assert s.cur_scale == 1
    assert s.floor_stuck
    assert events == [3]           # hook fired once, at patience
    s.update_scale(False)          # one good step resets the detector
    assert s.consecutive_floor_overflows == 0 and not s.floor_stuck


def test_dynamic_loss_scaler_reference_semantics_unchanged():
    """The floor fix must not alter the reference update_scale walk."""
    from deepspeed_tpu_torch.runtime.fp16.loss_scaler import \
        DynamicLossScaler

    s = DynamicLossScaler(init_scale=8, scale_window=2, min_scale=1,
                          delayed_shift=1)
    s.update_scale(True)
    assert s.cur_scale == 4 and s.last_overflow_iter == 0
    s.update_scale(False)
    s.update_scale(False)
    assert s.cur_scale == 8        # window of 2 good iters doubles
    s.update_scale(True)
    s.update_scale(True)
    s.update_scale(True)
    assert s.cur_scale == 1        # floored, silently clamped no more:
    assert s.consecutive_floor_overflows >= 1
