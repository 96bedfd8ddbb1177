"""The checkpoint subsystem of the port (``deepspeed_tpu_torch/checkpoint``),
on the CPU: every test of the JAX package's
``tests/unit/test_checkpoint_manager.py``, ported.  Atomic commit
protocol, crash-mid-save recovery, retention, retry, async-vs-sync
bit-identity, native-dtype model states and the preemption handler;
where a test drives an engine it is the port's, training a tiny GPT-2
(2 layers, hidden 64, vocab 256, seq 32).  The port runs at one
data-parallel rank, so the elastic test loads a JAX checkpoint written
at dp=2 through the JAX manager."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as deepspeed
from deepspeed_tpu_torch import checkpoint as ckpt
from deepspeed_tpu_torch.checkpoint import writer as ckpt_writer
from deepspeed_tpu_torch.checkpoint.config import DeepSpeedCheckpointConfig
from deepspeed_tpu_torch.checkpoint.manager import CheckpointManager
from deepspeed_tpu_torch.checkpoint.snapshot import CheckpointSnapshot
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def base_config(**overrides):
    cfg = {"train_batch_size": 2, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "Adam", "params": {"lr": 0.01}}}
    cfg.update(overrides)
    return cfg


def random_batches(num_batches, seed=0, batch_size=2):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(batch_size, 32))}
            for _ in range(num_batches)]


# ---------------------------------------------------------------- helpers
def fake_snapshot(step, payload=None, tag=None, save_latest=True):
    """Engine-free snapshot for writer/manager-level tests."""
    arr = np.full((4, 4), float(step), np.float32)
    return CheckpointSnapshot(
        tag=tag or f"global_step{step}",
        model_states={"w": payload if payload is not None else arr},
        model_dtypes={},
        optim_states={"master": arr.reshape(-1)},
        meta={"global_steps": step},
        save_latest=save_latest)


def manager(**overrides):
    cfg = DeepSpeedCheckpointConfig(
        {"checkpoint": dict({"save_retries": 0, "retry_backoff_secs": 0.0},
                            **overrides)})
    return CheckpointManager(cfg)


def make_engine(config, seed=0):
    cfg = GPT2Config(**TINY)
    engine, *_ = deepspeed.initialize(
        model=GPT2LMHead(cfg), model_parameters=random_params(cfg, seed),
        config=config, device="cpu")
    return engine


def run_steps(engine, batches):
    return [float(np.asarray(engine.train_batch(iter([b]))))
            for b in batches]


@pytest.fixture
def no_hook():
    yield
    ckpt_writer._file_written_hook = None


# ------------------------------------------------------- commit protocol
def test_atomic_commit_layout_and_verify(tmp_path):
    m = manager()
    assert m.save(fake_snapshot(1), str(tmp_path), async_save=False)
    tag_dir = tmp_path / "global_step1"
    assert sorted(os.listdir(tag_dir)) == [
        "manifest.json", "meta.json", "model_states.npz",
        "zero_optim_states.npz"]
    assert ckpt.read_latest(str(tmp_path)) == "global_step1"
    status, problems = ckpt.verify_checkpoint(str(tag_dir))
    assert status == "ok" and not problems
    manifest = ckpt.read_manifest(str(tag_dir))
    assert manifest["global_steps"] == 1
    for entry in manifest["files"].values():
        assert entry["bytes"] > 0 and "checksum" in entry


def test_verify_flags_corruption(tmp_path):
    m = manager()
    m.save(fake_snapshot(1), str(tmp_path), async_save=False)
    victim = tmp_path / "global_step1" / "model_states.npz"
    data = bytearray(victim.read_bytes())
    data[-1] ^= 0xFF
    victim.write_bytes(bytes(data))
    status, problems = ckpt.verify_checkpoint(str(tmp_path / "global_step1"))
    assert status == "bad" and any("checksum" in p for p in problems)


def test_crash_mid_save_preserves_previous(tmp_path, no_hook):
    """Kill the writer between npz files: `latest` must still resolve to
    the previous complete checkpoint and the torn tmp dir must be flagged
    by verification, never loadable."""
    m = manager()
    assert m.save(fake_snapshot(1), str(tmp_path), async_save=False)

    def die_after_first_file(tmp_dir, name):
        if name == ckpt.MODEL_STATES_NPZ:
            raise OSError("simulated crash mid-save")

    ckpt_writer._file_written_hook = die_after_first_file
    assert not m.save(fake_snapshot(2), str(tmp_path), async_save=False)
    ckpt_writer._file_written_hook = None

    assert ckpt.read_latest(str(tmp_path)) == "global_step1"
    torn = tmp_path / "global_step2.tmp"
    assert torn.is_dir()  # half-written, never committed
    status, _ = ckpt.verify_checkpoint(str(torn))
    assert status == "bad"
    assert not (tmp_path / "global_step2").exists()
    # the next successful save sweeps the torn leftovers
    assert m.save(fake_snapshot(3), str(tmp_path), async_save=False)
    assert not torn.exists()
    assert ckpt.read_latest(str(tmp_path)) == "global_step3"


def test_interrupted_resave_recovers_from_old_dir(tmp_path):
    """A crash between the two renames of a same-tag re-save leaves only
    <tag>.old; the loader heals it, and retention sweeps superseded .old
    dirs instead of counting them as checkpoints."""
    m = manager()
    assert m.save(fake_snapshot(1), str(tmp_path), async_save=False)
    # simulate the crash window: final dir parked aside, new commit lost
    os.replace(str(tmp_path / "global_step1"),
               str(tmp_path / "global_step1.old"))

    assert ckpt.recover_tag(str(tmp_path), "global_step1")
    assert ckpt.verify_checkpoint(str(tmp_path / "global_step1"))[0] == "ok"
    assert not (tmp_path / "global_step1.old").exists()

    # engine loader does the same healing implicitly
    e = make_engine(base_config())
    run_steps(e, random_batches(1, seed=3))
    e.save_checkpoint(str(tmp_path), sync=True)
    os.replace(str(tmp_path / "global_step1"),
               str(tmp_path / "global_step1.old"))
    path, _ = e.load_checkpoint(str(tmp_path), tag="global_step1")
    assert path is not None and path.endswith("global_step1")

    # a superseded .old (final dir still present) is swept by retention,
    # never listed as a committed checkpoint
    import shutil

    shutil.copytree(str(tmp_path / "global_step1"),
                    str(tmp_path / "global_step1.old"))
    m2 = manager(keep_last_n=1)
    assert m2.save(fake_snapshot(2), str(tmp_path), async_save=False)
    assert not (tmp_path / "global_step1.old").exists()


def test_save_retry_with_backoff(tmp_path, no_hook):
    fails = {"left": 2}

    def flaky(tmp_dir, name):
        if name == ckpt.META_JSON and fails["left"] > 0:
            fails["left"] -= 1
            raise OSError("transient I/O error")

    ckpt_writer._file_written_hook = flaky
    m = manager(save_retries=2, retry_backoff_secs=0.0)
    assert m.save(fake_snapshot(5), str(tmp_path), async_save=False)
    assert fails["left"] == 0
    assert ckpt.verify_checkpoint(str(tmp_path / "global_step5"))[0] == "ok"


def test_retention_keep_last_n_and_every_n(tmp_path):
    m = manager(keep_last_n=2, keep_every_n_steps=4)
    for step in range(1, 7):
        assert m.save(fake_snapshot(step), str(tmp_path), async_save=False)
    kept = sorted(p for p in os.listdir(tmp_path)
                  if (tmp_path / p).is_dir())
    # last 2 (steps 5, 6) + every multiple of 4 (step 4)
    assert kept == ["global_step4", "global_step5", "global_step6"]
    assert ckpt.read_latest(str(tmp_path)) == "global_step6"


def test_retention_never_prunes_foreign_dirs(tmp_path):
    (tmp_path / "not_a_checkpoint").mkdir()
    (tmp_path / "not_a_checkpoint" / "data.txt").write_text("keep me")
    m = manager(keep_last_n=1)
    for step in (1, 2):
        m.save(fake_snapshot(step), str(tmp_path), async_save=False)
    assert (tmp_path / "not_a_checkpoint" / "data.txt").exists()
    assert not (tmp_path / "global_step1").exists()


def test_save_latest_false_does_not_pin_pointer(tmp_path):
    """An archival save_latest=False commit at a high step must not pin
    the monotonic guard: later lower-step saves that DO want `latest`
    moved still move it."""
    m = manager()
    assert m.save(fake_snapshot(10), str(tmp_path), async_save=False)
    assert m.save(fake_snapshot(100, tag="archive100", save_latest=False),
                  str(tmp_path), async_save=False)
    assert ckpt.read_latest(str(tmp_path)) == "global_step10"
    assert m.save(fake_snapshot(11), str(tmp_path), async_save=False)
    assert ckpt.read_latest(str(tmp_path)) == "global_step11"


def test_verify_uses_manifest_checksum_algorithm(tmp_path):
    """A crc32 manifest must verify with crc32 even on a host whose
    preferred local algorithm is crc32c (cross-host portability)."""
    m = manager()
    m.save(fake_snapshot(1), str(tmp_path), async_save=False)
    tag_dir = tmp_path / "global_step1"
    manifest = ckpt.read_manifest(str(tag_dir))
    algo = manifest["checksum_algorithm"]
    for name, entry in manifest["files"].items():
        assert entry["checksum"] == ckpt_writer.file_checksum(
            str(tag_dir / name), algorithm=algo)
    # an algorithm we don't have degrades to sizes-only, still "ok"
    manifest["checksum_algorithm"] = "xxh3"
    (tag_dir / ckpt.MANIFEST_JSON).write_text(json.dumps(manifest))
    status, problems = ckpt.verify_checkpoint(str(tag_dir))
    assert status == "ok" and not problems


def test_legacy_dir_without_manifest_is_loadable(tmp_path):
    """Pre-manifest checkpoints (meta.json only) verify as 'legacy'."""
    legacy = tmp_path / "global_step9"
    legacy.mkdir()
    (legacy / "meta.json").write_text(json.dumps({"global_steps": 9}))
    status, problems = ckpt.verify_checkpoint(str(legacy))
    assert status == "legacy" and not problems


# ------------------------------------------------------------ engine level
def test_async_save_matches_sync_bit_identical(tmp_path):
    """A committed async checkpoint restores bit-identically to a
    synchronous save of the same step."""
    config = base_config(zero_optimization={"stage": 2})
    e = make_engine(config)
    run_steps(e, random_batches(3, seed=5))

    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    e.save_checkpoint(sync_dir, sync=True)
    e.save_checkpoint(async_dir)          # async by default
    e.wait_checkpoint(async_dir)

    for name in (ckpt.MODEL_STATES_NPZ, ckpt.OPTIM_STATES_NPZ):
        a = np.load(os.path.join(sync_dir, "global_step3", name))
        b = np.load(os.path.join(async_dir, "global_step3", name))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")


def test_train_batch_overlaps_inflight_save(tmp_path, no_hook):
    """The acceptance gate: train_batch completes a full update while a
    checkpoint write is still in flight."""
    gate = threading.Event()
    blocked = threading.Event()

    def block_writer(tmp_dir, name):
        if name == ckpt.OPTIM_STATES_NPZ:
            blocked.set()
            assert gate.wait(timeout=60), "test deadlock"

    config = base_config(zero_optimization={"stage": 1})
    e = make_engine(config)
    batches = random_batches(4, seed=9)
    ref = run_steps(e, batches[:2])

    ckpt_writer._file_written_hook = block_writer
    try:
        e.save_checkpoint(str(tmp_path))
        assert blocked.wait(timeout=60), "writer thread never started"
        # writer is parked mid-checkpoint; a full optimizer update runs
        loss = run_steps(e, batches[2:3])[0]
        assert np.isfinite(loss)
        assert e.global_steps == 3
        assert ckpt.read_latest(str(tmp_path)) is None  # not committed yet
    finally:
        gate.set()
        ckpt_writer._file_written_hook = None
    e.wait_checkpoint(str(tmp_path))
    assert ckpt.read_latest(str(tmp_path)) == "global_step2"

    # the in-flight snapshot was immutable: restoring it replays step 3
    e2 = make_engine(config)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None and e2.global_steps == 2
    np.testing.assert_allclose(run_steps(e2, batches[2:3])[0], loss,
                               rtol=1e-6)
    del ref


def test_load_waits_for_inflight_save_same_process(tmp_path, no_hook):
    """A different engine in the same process loading the same dir drains
    the in-flight save instead of racing it."""
    gate = threading.Event()

    def slow_writer(tmp_dir, name):
        if name == ckpt.META_JSON:
            gate.wait(timeout=60)

    config = base_config()
    e = make_engine(config)
    run_steps(e, random_batches(2, seed=2))
    ckpt_writer._file_written_hook = slow_writer
    try:
        e.save_checkpoint(str(tmp_path))
        threading.Timer(0.2, gate.set).start()
        e2 = make_engine(config)
        path, _ = e2.load_checkpoint(str(tmp_path))  # drains, then loads
        assert path is not None and e2.global_steps == 2
    finally:
        gate.set()
        ckpt_writer._file_written_hook = None


def test_strict_load_raises(tmp_path):
    e = make_engine(base_config())
    with pytest.raises(ckpt.CheckpointError, match="latest"):
        e.load_checkpoint(str(tmp_path), strict=True)
    # non-strict keeps the reference warn-and-continue contract
    assert e.load_checkpoint(str(tmp_path)) == (None, None)


def test_missing_meta_rejected_not_raised(tmp_path):
    """A tag dir without meta.json must be rejected up front, not blow up
    mid-restore with FileNotFoundError."""
    (tmp_path / "sometag").mkdir()
    e = make_engine(base_config())
    assert e.load_checkpoint(str(tmp_path), tag="sometag") == (None, None)
    with pytest.raises(ckpt.CheckpointError, match="meta.json"):
        e.load_checkpoint(str(tmp_path), tag="sometag", strict=True)


def test_verify_on_load_rejects_corrupt_checkpoint(tmp_path):
    config = base_config()
    e = make_engine(config)
    run_steps(e, random_batches(2, seed=1))
    e.save_checkpoint(str(tmp_path), sync=True)
    victim = tmp_path / "global_step2" / ckpt.OPTIM_STATES_NPZ
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF
    victim.write_bytes(bytes(data))

    e2 = make_engine(config)
    assert e2.load_checkpoint(str(tmp_path)) == (None, None)
    # corruption raises the dedicated subclass so callers can distinguish
    # "corrupt, fail hard" from "missing, start fresh"
    with pytest.raises(ckpt.CheckpointCorruptionError, match="integrity"):
        e2.load_checkpoint(str(tmp_path), strict=True)


def test_native_dtype_model_states(tmp_path):
    """bf16 runs save bf16 model states (half the bytes of the old forced
    fp32) with the dtype recorded; the typed loader restores them."""
    config = base_config(zero_optimization={"stage": 1},
                         bf16={"enabled": True})
    e = make_engine(config)
    run_steps(e, random_batches(2, seed=4))
    e.save_checkpoint(str(tmp_path), sync=True)

    tag_dir = str(tmp_path / "global_step2")
    with open(os.path.join(tag_dir, ckpt.META_JSON)) as f:
        meta = json.load(f)
    assert meta["model_dtypes"], "bf16 params must be recorded in the map"
    assert all(v == "bfloat16" for v in meta["model_dtypes"].values())
    states = ckpt.load_model_states(tag_dir)
    for key in meta["model_dtypes"]:
        assert states[key].dtype == torch.bfloat16
    # every leaf is one view of the flat bf16 compute buffer
    assert set(meta["model_dtypes"]) == set(states)
    with np.load(os.path.join(tag_dir, ckpt.MODEL_STATES_NPZ)) as npz:
        assert npz["wte"].dtype == np.uint16
        assert npz["wte"].nbytes == 2 * 256 * 64
    # and a bf16-saved checkpoint restores exactly (load path uses the
    # fp32 master, so precision is untouched)
    e2 = make_engine(config)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None
    assert torch.equal(e2.master, e.master)


def test_fp32_checkpoint_loads_into_bf16_run(tmp_path):
    """Old-style fp32 model states (no dtype map) pass through the typed
    loader unchanged — fp32 checkpoints restore into any compute dtype."""
    fp32_cfg = base_config()
    e = make_engine(fp32_cfg)
    run_steps(e, random_batches(2, seed=6))
    e.save_checkpoint(str(tmp_path), sync=True)
    tag_dir = str(tmp_path / "global_step2")
    states = ckpt.load_model_states(tag_dir)
    assert all(a.dtype == torch.float32 for a in states.values())

    bf16_cfg = base_config(bf16={"enabled": True})
    e2 = make_engine(bf16_cfg)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None
    assert torch.equal(e2.master, e.master)


def test_async_retention_roundtrip(tmp_path):
    """Async saves + retention: several saves in flight, only the window
    survives, and the survivor restores correctly."""
    config = base_config(checkpoint={"keep_last_n": 2})
    e = make_engine(config)
    batches = random_batches(6, seed=8)
    for i in range(4):
        run_steps(e, batches[i:i + 1])
        e.save_checkpoint(str(tmp_path))
    e.wait_checkpoint(str(tmp_path))

    tags = sorted(p for p in os.listdir(tmp_path)
                  if (tmp_path / p).is_dir())
    assert tags == ["global_step3", "global_step4"]
    assert ckpt.read_latest(str(tmp_path)) == "global_step4"
    ref = run_steps(e, batches[4:])

    e2 = make_engine(config)
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step4")
    np.testing.assert_allclose(run_steps(e2, batches[4:]), ref, rtol=1e-5)


def test_elastic_dp_change_through_manager(tmp_path):
    """DP-degree-change restore through the manager path: the JAX
    engine saves async at dp=2 through its own manager, the port
    resumes at dp=1 on the same global batches (the unpadded flat
    master re-padded for one rank): the losses agree to 1e-5."""
    import jax

    import deepspeed_tpu as jds
    from deepspeed_tpu.models import GPT2Config as JConfig
    from deepspeed_tpu.models import GPT2LMHeadTPU
    from deepspeed_tpu.parallel import make_mesh

    batches = random_batches(8, seed=7, batch_size=4)
    cfg = base_config(train_batch_size=4,
                      zero_optimization={"stage": 2})
    mesh = make_mesh({"data": 2}, devices=jax.devices("cpu")[:2])
    e1, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JConfig(**TINY)),
        model_parameters=jax.tree_util.tree_map(
            jax.numpy.asarray, random_params(GPT2Config(**TINY), 0)),
        config=dict(cfg), mesh=mesh)
    run_steps(e1, batches[:4])
    e1.save_checkpoint(str(tmp_path))     # async path
    ref_losses = run_steps(e1, batches[4:])
    e1.wait_checkpoint(str(tmp_path))

    e2 = make_engine(dict(cfg), seed=3)   # dp=1, micro-batch 4
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None and e2.global_steps == 4
    np.testing.assert_allclose(run_steps(e2, batches[4:]), ref_losses,
                               rtol=1e-5)


def test_checkpoint_config_defaults_and_parse():
    cfg = DeepSpeedCheckpointConfig({})
    assert cfg.async_save and cfg.verify_on_load
    assert cfg.keep_last_n == 0 and cfg.keep_every_n_steps == 0
    cfg = DeepSpeedCheckpointConfig(
        {"checkpoint": {"async_save": False, "keep_last_n": 3,
                        "keep_every_n_steps": 100, "verify_on_load": False,
                        "save_on_preemption": True}})
    assert not cfg.async_save and cfg.keep_last_n == 3
    assert cfg.keep_every_n_steps == 100
    assert not cfg.verify_on_load and cfg.save_on_preemption
    with pytest.raises(AssertionError):
        DeepSpeedCheckpointConfig({"checkpoint": {"keep_last_n": -1}})


def test_wait_errors_are_per_directory(tmp_path, no_hook):
    """A failed commit to one dir must still raise from wait() after a
    later successful commit to a different dir."""
    dir_a, dir_b = tmp_path / "a", tmp_path / "b"

    def fail_in_a(tmp_dir, name):
        if os.path.dirname(tmp_dir) == str(dir_a):
            raise OSError("disk full")

    ckpt_writer._file_written_hook = fail_in_a
    m = manager()
    assert not m.save(fake_snapshot(1), str(dir_a), async_save=False)
    ckpt_writer._file_written_hook = None
    assert m.save(fake_snapshot(1), str(dir_b), async_save=False)

    m.wait(str(dir_b))  # b is clean
    with pytest.raises(ckpt.CheckpointError, match="disk full"):
        m.wait(str(dir_a))
    with pytest.raises(ckpt.CheckpointError):
        m.wait()  # no dir: any tracked failure raises
    # a later successful re-save to a clears its error
    assert m.save(fake_snapshot(2), str(dir_a), async_save=False)
    m.wait(str(dir_a))
    m.wait()


def test_drain_inflight_timeout_path(tmp_path, no_hook):
    """drain_inflight with a timeout returns False while a writer is
    stuck (instead of blocking forever) and True once it finishes; the
    checkpoint still commits intact afterwards."""
    from deepspeed_tpu_torch.checkpoint.manager import drain_inflight

    gate = threading.Event()
    started = threading.Event()

    def block(tmp_dir, name):
        if name == ckpt.OPTIM_STATES_NPZ:
            started.set()
            assert gate.wait(timeout=60), "test deadlock"

    ckpt_writer._file_written_hook = block
    m = manager()
    try:
        assert m.save(fake_snapshot(1), str(tmp_path), async_save=True)
        assert started.wait(timeout=60), "writer never started"
        t0 = time.monotonic()
        assert not drain_inflight(str(tmp_path), timeout=0.2)
        assert time.monotonic() - t0 < 5  # timed out, didn't hang
        # a zero timeout is a pure poll
        assert not drain_inflight(str(tmp_path), timeout=0.0)
    finally:
        gate.set()
        ckpt_writer._file_written_hook = None
    assert drain_inflight(str(tmp_path), timeout=60)
    m.wait(str(tmp_path))
    assert ckpt.read_latest(str(tmp_path)) == "global_step1"


def test_preemption_handler_chained_not_self_chained(tmp_path):
    """Installing handlers from several managers must chain the ORIGINAL
    disposition exactly once — never the preemption handler over itself
    (which would re-run every callback recursively on delivery)."""
    import signal

    from deepspeed_tpu_torch.checkpoint import manager as mgr_mod

    chained = []
    old = signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    cbs_before = list(mgr_mod._PREEMPT_CALLBACKS)
    prev_before = dict(mgr_mod._PREEMPT_PREVIOUS)
    try:
        calls = []
        m1, m2 = manager(), manager()
        assert m1.install_preemption_handler(lambda: calls.append(1))
        assert m2.install_preemption_handler(lambda: calls.append(2))
        # the second install saw our handler already in place and must
        # NOT have recorded it as the disposition to chain to
        assert (signal.getsignal(signal.SIGTERM)
                is mgr_mod._preemption_handler)
        assert (mgr_mod._PREEMPT_PREVIOUS[signal.SIGTERM]
                is not mgr_mod._preemption_handler)
        signal.raise_signal(signal.SIGTERM)
        assert sorted(calls) == [1, 2]       # every callback ran once
        assert chained == [signal.SIGTERM]   # original handler ran ONCE
    finally:
        mgr_mod._PREEMPT_CALLBACKS[:] = cbs_before
        mgr_mod._PREEMPT_PREVIOUS.clear()
        mgr_mod._PREEMPT_PREVIOUS.update(prev_before)
        signal.signal(signal.SIGTERM, old)


def test_preemption_handler_refused_off_main_thread():
    """Signal handlers can only be installed from the main thread; a
    worker-thread install must refuse (False) without touching the
    process disposition."""
    import signal

    before = signal.getsignal(signal.SIGTERM)
    results = []
    m = manager()
    t = threading.Thread(target=lambda: results.append(
        m.install_preemption_handler(lambda: None)))
    t.start()
    t.join()
    assert results == [False]
    assert signal.getsignal(signal.SIGTERM) is before


def test_preemption_callbacks_drop_dead_engines(tmp_path):
    """Bound-method callbacks are weak: a discarded registrant neither
    leaks nor fires on SIGTERM; live ones still do."""
    import signal

    from deepspeed_tpu_torch.checkpoint import manager as mgr_mod

    class Registrant:
        def __init__(self):
            self.fired = 0

        def final_save(self):
            self.fired += 1

    old = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    cbs_before = list(mgr_mod._PREEMPT_CALLBACKS)
    try:
        m = manager()
        dead, live = Registrant(), Registrant()
        m.install_preemption_handler(dead.final_save)
        m.install_preemption_handler(live.final_save)
        del dead  # weakref target gone
        signal.raise_signal(signal.SIGTERM)
        assert live.fired == 1
        # the dead registrant's callback was pruned from the registry
        assert all(r() is not None for r in mgr_mod._PREEMPT_CALLBACKS)
    finally:
        mgr_mod._PREEMPT_CALLBACKS[:] = cbs_before
        signal.signal(signal.SIGTERM, old)


def test_preemption_handler_drains_final_save(tmp_path):
    """SIGTERM runs one final synchronous save before the previous
    disposition fires (manager-level; the engine wires save_checkpoint
    in as final_save_fn when checkpoint.save_on_preemption is set)."""
    import signal

    from deepspeed_tpu_torch.checkpoint import manager as mgr_mod

    chained = []
    old = signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    cbs_before = list(mgr_mod._PREEMPT_CALLBACKS)
    try:
        m = manager()
        calls = []
        m.install_preemption_handler(
            lambda: calls.append(
                m.save(fake_snapshot(7), str(tmp_path), async_save=False)))
        signal.raise_signal(signal.SIGTERM)  # delivered synchronously
        assert calls == [True]
        assert ckpt.read_latest(str(tmp_path)) == "global_step7"
        # the previous handler still fires, so shutdown proceeds
        assert chained == [signal.SIGTERM]
    finally:
        mgr_mod._PREEMPT_CALLBACKS[:] = cbs_before
        signal.signal(signal.SIGTERM, old)
