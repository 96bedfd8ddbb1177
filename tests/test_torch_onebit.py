"""1-bit Adam and the compressed all-reduce in the port (ROADMAP A14)
against the JAX package (its ``tests/unit/test_onebit.py:22-200`` and
``test_comm_overlap.py:365-434``).

- ``pack_signs`` / ``unpack_signs`` bitwise the JAX package's.
- ``compressed_allreduce`` on two gloo processes
  (:mod:`tests.torch_zero_workers`), at an aligned and two unaligned
  sizes, against the JAX function under ``shard_map`` on two virtual CPU
  devices and against ``compressed_allreduce_reference``.
- A OneBitAdam trajectory through ``freeze_step`` at dp=2 against the
  JAX engine at dp=2; the compressed phase makes no dense all-reduce
  (the comm counters); a compressed-phase checkpoint crosses to the JAX
  engine and back; the refusals.
- At one rank: fp16 with a static loss scale through the freeze against
  the JAX engine, and the anomaly guard with rollback in the compressed
  phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.comm import compression as jcomp
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu.utils.compat import shard_map
from deepspeed_tpu_torch.comm import compression
from deepspeed_tpu_torch.resilience.chaos import ChaosMonkey

from . import torch_dp_workers as W
from . import torch_zero_workers as Z
from .torch_dist import run_ranks

WORLD = 2
# compressed_allreduce against the JAX function: the signs agree
# exactly; the scales are norms that XLA and torch sum in different
# orders (a few ulps), so the outputs and the error buffers agree to a
# few ulps of their magnitude.  Measured: at most 2.4e-7 absolute.
ALLREDUCE_ATOL = 1e-6
# OneBitAdam against the JAX engine.  The warmup is dense Adam (the dp=2
# trajectory tolerance, also for the loss after the first compressed
# update).  A compressed update can flip the sign of a momentum element
# that lies within ulps of 0 (the two engines' gradients differ in the
# last bits), which moves its consensus by 2 x scale; the frozen variance
# of a 3-step warmup is ~0.3% of the second moment and below eps for
# some elements, so such an element's step is huge and the later steps
# compound the flips.  So one compressed update from the same state is
# held element by element (signs may flip on at most FLIP_FRACTION of
# the elements; elsewhere the momentum and the master agree), and the
# whole trajectory's losses to the measured bound: at most 4.4e-3
# relative at step 8 (9.9e-3 before the compression's norms summed in
# fp64; the masters then differ by most of the update's norm, in the
# few elements whose variance is below eps).
LOSS_RTOL = 1e-5
COMPOUNDED_RTOL = 5e-2
FLIP_FRACTION = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_engine(config, dp=WORLD):
    mesh = jax_mesh({"data": dp}, devices=jax.devices("cpu")[:dp])
    _, params = W.model_and_params("gpt2")
    engine, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JConfig(**W.TINY)),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=dict(config), mesh=mesh)
    return engine


def jax_state(engine):
    flat, opt = engine.flat, engine.state["opt"]
    return {"master": flat.gather_master_unpadded(engine.state["master"]),
            "exp_avg": flat.gather_master_unpadded(opt.exp_avg),
            "exp_avg_sq": flat.gather_master_unpadded(opt.exp_avg_sq),
            "worker_error": np.asarray(opt.worker_error),
            "server_error": np.asarray(opt.server_error),
            "step": int(opt.step)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engine's trajectory (a checkpoint after step 5 in the
    compressed phase, then 3 steps of other batches from it) and the
    gloo ranks' runs."""
    root = tmp_path_factory.mktemp("onebit")
    jeng = jax_engine(Z.onebit_config(WORLD))
    start = jax_state(jeng)["master"].copy()
    it = iter(Z.gpt2_global(Z.ONEBIT_STEPS, WORLD))
    losses = []
    for step in range(Z.ONEBIT_STEPS):
        losses.append(float(np.asarray(jeng.train_batch(it))))
        if step == Z.ONEBIT_STEPS - 4:
            jeng.save_checkpoint(str(root / "jax"), sync=True)
            jeng.wait_checkpoint()
    out = {"root": root, "jax_losses": losses, "jax": jax_state(jeng),
           "start": start}
    resumed = jax_engine(Z.onebit_config(WORLD))
    resumed.load_checkpoint(str(root / "jax"), strict=True)
    out["jax_at_ckpt"] = jax_state(resumed)
    it = iter(Z.gpt2_global(3, WORLD, seed=4))
    out["jax_resumed"] = [float(np.asarray(resumed.train_batch(it)))]
    out["jax_1"] = jax_state(resumed)
    out["jax_resumed"] += [float(np.asarray(resumed.train_batch(it)))
                           for _ in range(2)]
    out["ranks"] = run_ranks(Z.onebit_runs, WORLD, root / "ranks",
                             str(root / "jax"), str(root))
    return out


# ------------------------------------------------------------ signs
@pytest.mark.parametrize("n", [8, 64, 1024])
def test_pack_signs_bitwise_the_jax_package(n):
    bits = np.random.default_rng(n).random(n) > 0.5
    mine = compression.pack_signs(torch.from_numpy(bits)).numpy()
    want = np.asarray(jcomp.pack_signs(jnp.asarray(bits)))
    assert mine.dtype == np.uint8 and np.array_equal(mine, want)
    assert np.array_equal(mine, np.packbits(bits))
    assert np.array_equal(
        compression.unpack_signs(torch.from_numpy(mine)).numpy(),
        np.asarray(jcomp.unpack_signs(jnp.asarray(want))))


@pytest.mark.parametrize("kind", ["equal", "random"])
def test_compress_scale_is_the_exact_norm(kind):
    """Every element of a compressed buffer is +-scale, so the scale's
    rounding is the whole result's: over a long buffer it is the exact
    norm over sqrt(n), rounded once to fp32 (the norm sums in fp64,
    where an fp32 sum on the CPU drifts as the buffer grows)."""
    n = 1 << 22
    rng = np.random.default_rng(0)
    host = (np.full(n, 0.1, np.float32) if kind == "equal"
            else rng.normal(size=n).astype(np.float32))
    buf = torch.from_numpy(host)
    bits, scale, err = compression._compress(buf, torch.zeros(n))
    exact = np.sqrt(np.sum(host.astype(np.float64) ** 2)) / np.sqrt(n)
    assert float(scale) == np.float32(exact)
    assert torch.equal(bits, buf >= 0)
    assert torch.equal(err, buf - scale * (bits.float() * 2 - 1))


def test_padded_size_and_the_error_sizes_are_checked():
    assert compression.padded_size(100, 4) == 128
    assert compression.padded_size(128, 4) == 128
    assert compression.padded_size(0, 2) == 0
    buf = torch.zeros(100)
    with pytest.raises(ValueError, match="padded_size"):
        compression.compressed_allreduce(buf, torch.zeros(100),
                                         torch.zeros(104), "data")


# ----------------------------------------------------- compressed all-reduce
def _jax_allreduce(bufs, werrs, serrs):
    world = bufs.shape[0]
    mesh = jax_mesh({"data": world}, devices=jax.devices("cpu")[:world])

    def body(b, we, se):
        out, nwe, nse = jcomp.compressed_allreduce(b[0], we[0], se[0], "data")
        return out[None], nwe[None], nse[None]

    return [np.asarray(x) for x in jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data")),
        axis_names={"data"}, check_vma=False))(bufs, werrs, serrs)]


@pytest.mark.parametrize("n", Z.ALLREDUCE_SIZES)
def test_compressed_allreduce_matches_jax_and_the_reference(n, runs):
    bufs, werrs, serrs = Z.allreduce_inputs(WORLD, n)
    n_pad = compression.padded_size(n, WORLD)
    jout, jwe, jse = _jax_allreduce(bufs, werrs, serrs)
    padded = np.zeros((WORLD, n_pad), np.float32)
    padded[:, :n] = bufs
    ref_out, ref_we, ref_se = compression.compressed_allreduce_reference(
        list(padded), list(werrs), list(serrs))
    for rank, got in enumerate(runs["ranks"]):
        out, we, se = got[("allreduce", n)]
        assert out.shape == (n,) and we.shape == (n_pad,)
        assert se.shape == (n_pad // WORLD,)
        # the signs are the same: every output is +-(a served scale)
        np.testing.assert_array_equal(np.sign(out), np.sign(jout[rank]))
        np.testing.assert_allclose(out, jout[rank], rtol=0,
                                   atol=ALLREDUCE_ATOL)
        np.testing.assert_allclose(we, jwe[rank], rtol=0,
                                   atol=ALLREDUCE_ATOL)
        np.testing.assert_allclose(se, jse[rank], rtol=0,
                                   atol=ALLREDUCE_ATOL)
        np.testing.assert_allclose(out, ref_out[:n], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(we, ref_we[rank], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(se, ref_se[rank], rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ OneBitAdam
def test_onebit_trajectory_matches_the_jax_engine(runs):
    """Through the warmup and the first compressed update the losses
    agree as dense Adam's do; after it the steps compound the sign flips
    through the frozen early variance, within the measured bound."""
    got = runs["ranks"][0]
    assert runs["ranks"][1]["losses"] == got["losses"]
    k = Z.ONEBIT_FREEZE + 2
    np.testing.assert_allclose(got["losses"][:k], runs["jax_losses"][:k],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], runs["jax_losses"],
                               rtol=COMPOUNDED_RTOL)
    ref, mine = runs["jax"], got["state"]
    assert mine["step"] == ref["step"] == Z.ONEBIT_STEPS
    # the variance froze at freeze_step in both (measured: 7.2e-5
    # relative, 1.1e-9 absolute at most, on elements near 1e-7 whose
    # gradients the two engines round differently)
    np.testing.assert_allclose(mine["exp_avg_sq"], ref["exp_avg_sq"],
                               rtol=2e-4, atol=5e-9)
    # this rank's error buffers are its rows of the JAX engine's
    assert mine["worker_error"].shape == ref["worker_error"].shape[1:]
    assert mine["server_error"].shape == ref["server_error"].shape[1:]


def test_one_compressed_update_from_the_same_state(runs):
    """From the JAX engine's compressed-phase checkpoint, one update on
    both engines: the momentum's signs agree except on a few elements
    near 0, and where they agree the momentum agrees to its scale's
    rounding (a norm over the whole buffer, summed in another order:
    measured 4.8e-6 relative, no flip) and the master's step to the
    same relative error (measured 1.8e-5; a step of up to lr x m / eps
    where the frozen variance is below eps)."""
    ref, before = runs["jax_1"], runs["jax_at_ckpt"]
    for got in runs["ranks"]:
        mine = got["from_jax_1"]
        same = np.sign(mine["exp_avg"]) == np.sign(ref["exp_avg"])
        assert (~same).mean() <= FLIP_FRACTION
        np.testing.assert_allclose(mine["exp_avg"][same],
                                   ref["exp_avg"][same], rtol=5e-5)
        step = np.abs(ref["master"] - before["master"])[same]
        assert np.all(np.abs(mine["master"] - ref["master"])[same]
                      <= 5e-5 * step + 1e-7)
        assert np.array_equal(mine["exp_avg_sq"], ref["exp_avg_sq"])


def test_compressed_phase_makes_no_dense_allreduce(runs):
    """Warmup steps all-reduce the fp32 gradient; from ``freeze_step`` on
    the data axis carries the packed signs (at most n/8 bytes a phase)
    and the scales, and an all-reduce of one loss."""
    got = runs["ranks"][0]
    n = got["n_flat"]
    for step, (calls, nbytes) in enumerate(got["calls"]):
        if step < Z.ONEBIT_FREEZE:
            assert nbytes["psum"] >= 4 * n
            assert "all_to_all" not in calls
            continue
        assert nbytes.get("psum", 0) <= 8, (step, nbytes)
        assert calls["all_to_all"] == 1
        n_pad = compression.padded_size(n, WORLD)
        assert nbytes["all_to_all"] <= n_pad // 8
        assert nbytes["all_to_all"] + nbytes["all_gather"] == \
            compression.buffer_bytes(n, WORLD)
        # each phase's packed signs, and two scales a rank
        assert nbytes["all_gather"] <= n_pad // 8 + 2 * 4 * WORLD


def test_compressed_phase_checkpoint_crosses_the_packages(runs):
    """The JAX engine's checkpoint after step 5 into the port: master,
    moments and each rank's row of the error buffers bitwise, and the
    next 3 steps as the JAX engine's; the port's checkpoint of the same
    step into the JAX engine."""
    ref = runs["jax_at_ckpt"]
    for rank, got in enumerate(runs["ranks"]):
        mine = got["from_jax"]
        for key in ("master", "exp_avg", "exp_avg_sq", "step"):
            assert np.array_equal(mine[key], ref[key]), key
        assert np.array_equal(mine["worker_error"], ref["worker_error"][rank])
        assert np.array_equal(mine["server_error"], ref["server_error"][rank])
        np.testing.assert_allclose(got["from_jax_losses"][:2],
                                   runs["jax_resumed"][:2], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["from_jax_losses"],
                                   runs["jax_resumed"], rtol=COMPOUNDED_RTOL)
    jeng = jax_engine(Z.onebit_config(WORLD))
    jeng.load_checkpoint(str(runs["root"] / "onebit"), strict=True)
    st = jax_state(jeng)
    assert st["step"] == Z.ONEBIT_STEPS - 3
    assert st["worker_error"].shape == ref["worker_error"].shape
    assert np.abs(st["worker_error"]).sum() > 0


def _one(opt_params, **over):
    cfg = dict(W.dp_config(over.pop("stage", 0), "OneBitAdam", 1,
                           over.pop("clip", 0.0), 1), **over)
    cfg["optimizer"]["params"] = opt_params
    model, params = W.model_and_params("simple")
    return tds.initialize(model=model, model_parameters=params, config=cfg,
                          device="cpu")[0]


def test_onebit_refusals():
    with pytest.raises(ValueError, match="incompatible with ZeRO"):
        _one({"lr": 1e-2}, stage=2)
    # offload needs ZeRO stage 2, which 1-bit Adam refuses first
    with pytest.raises(ValueError, match="incompatible with ZeRO"):
        _one({"lr": 1e-2}, stage=2,
             zero_optimization={"stage": 2, "cpu_offload": True})
    with pytest.raises(ValueError, match="dynamic"):
        _one({"lr": 1e-2}, fp16={"enabled": True})


def test_onebit_trains_at_one_rank_and_warns_on_clipping(caplog):
    """Without a mesh the compressed phase runs over an axis of one
    member; the loss on one batch falls through the freeze."""
    with caplog.at_level("WARNING"):
        engine = _one({"lr": 1e-3, "freeze_step": 3}, clip=1.0)
    assert "gradient_clipping" in caplog.text
    batch = W.simple_batches(1, W.MICRO)[0]
    losses = [float(engine.train_batch(iter([batch]))) for _ in range(12)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert engine.opt_state.step == 12
    assert float(engine.opt_state.worker_error.abs().sum()) > 0


def _fp16_onebit(scale):
    cfg = Z.onebit_config(1, freeze=3,
                          fp16={"enabled": True, "loss_scale": scale})
    # the frozen variance of a short warmup lies below eps for some
    # elements; at 1e-3 their steps overflow the fp16 params in both
    # packages
    cfg["optimizer"]["params"]["lr"] = 1e-4
    return cfg


def test_fp16_static_scale_compressed_phase_matches_the_jax_engine():
    """fp16 with a static loss scale of 128, 3 warmup and 3 compressed
    steps at one rank, against the JAX engine and against the port's
    run at scale 1.  The JAX compressed program applies no loss scale,
    so the momentum mixes unscaled gradients; its 1-bit consensus at
    one rank is one magnitude, which flips of sign leave alone.
    Measured: the losses within 3.6e-5 relative of the JAX engine's and
    2.0e-5 of the scale-1 run's (fp16 gradients rounded in other
    orders), the magnitude within 2.6e-4 of the JAX engine's.  A
    momentum of the scaled gradient is ~128 times too large and the
    params overflow to NaN in the fourth compressed step's forward."""
    batches = Z.gpt2_global(6, 1)
    runs = {}
    for scale in (128, 1):
        engine = W.port_engine("gpt2", _fp16_onebit(scale), None)
        runs[scale] = ([float(engine.train_batch(iter([b])))
                        for b in batches], Z.onebit_state(engine))
    jeng = jax_engine(_fp16_onebit(128), dp=1)
    it = iter(batches)
    jax_losses = [float(np.asarray(jeng.train_batch(it))) for _ in batches]
    ref = jax_state(jeng)
    losses, mine = runs[128]
    assert mine["step"] == ref["step"] == 6
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    np.testing.assert_allclose(losses, runs[1][0], rtol=1e-4)
    magnitude = np.abs(mine["exp_avg"])
    assert magnitude.min() == magnitude.max()
    np.testing.assert_allclose(magnitude.max(),
                               np.abs(ref["exp_avg"]).max(), rtol=1e-3)
    np.testing.assert_allclose(magnitude.max(),
                               np.abs(runs[1][1]["exp_avg"]).max(),
                               rtol=1e-3)


def test_guard_rolls_back_in_the_compressed_phase(tmp_path):
    """The anomaly guard sees every compressed step's loss, as the JAX
    engine hands it.  Two NaN batches after a compressed-phase
    checkpoint poison the momentum, the error buffers and the master
    (the compressed phase skips nothing); the guard rolls back to the
    checkpoint, and the run then equals a clean engine loaded from it,
    bitwise.  (Not the unbroken run: the compressed update writes
    +-scale into the momentum's padding, which a checkpoint does not
    carry, and the next scale's norm sums it; the JAX engine does the
    same, ROADMAP C.)"""
    resilience = {"resilience": {
        "enabled": True, "policy": "rollback", "divergence_patience": 2,
        "checkpoint_dir": str(tmp_path), "spike_window": 0}}
    params = {"lr": 1e-3, "freeze_step": 2}
    engine = _one(dict(params), **resilience)
    batch = W.simple_batches(1, W.MICRO)[0]
    for _ in range(3):
        engine.train_batch(iter([batch]))
    assert engine._onebit_compressing()
    engine.save_checkpoint(str(tmp_path), sync=True)
    clean = _one(dict(params))
    clean.load_checkpoint(str(tmp_path))
    for _ in range(2):
        engine.train_batch(iter([ChaosMonkey.nan_batch(batch)]))
    assert engine.global_steps == 3
    assert engine._rollback_mgr.rollbacks_used == 1
    assert engine._guard.total_anomalies == 2
    got = [float(engine.train_batch(iter([batch]))) for _ in range(3)]
    want = [float(clean.train_batch(iter([batch]))) for _ in range(3)]
    assert got == want and all(np.isfinite(got))
    assert torch.equal(engine.master, clean.master)
    for name in ("exp_avg", "worker_error", "server_error"):
        assert torch.equal(getattr(engine.opt_state, name),
                           getattr(clean.opt_state, name))
    assert float(engine.opt_state.worker_error.abs().sum()) > 0
