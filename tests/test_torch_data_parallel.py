"""Data parallelism of the port (ROADMAP A5) against the JAX engine.

The port runs on two gloo processes (:func:`tests.torch_dist.run_ranks`,
the rank functions in :mod:`tests.torch_dp_workers`), each on its slice
of the global batch, through ``initialize(mesh=make_mesh({"data": 2}))``;
the JAX engine runs in this process on ``make_mesh({"data": 2})`` over
two of the conftest's virtual CPU devices, on the same numpy weights and
the same global batches.  One spawn serves every case of a group.

- Trajectories: 10 steps, fp32, dropout off, a tiny GPT-2 (2 layers,
  hidden 64) and SimpleModel, ZeRO stages 0, 1 and 2, Adam and Lamb,
  accumulation 1 and 2, clipping 1.0: the losses and the final unpadded
  master to rtol ``TRAJ_RTOL`` (the dp=1 trajectory tests' tolerance;
  the sums over the two ranks are ordered differently in XLA and in
  gloo).
- fp16 under the dynamic scaler at dp=2: the same skipped step and the
  same scale after every step as the JAX engine.
- The port against itself: BERT, whose two halves of a batch count
  different MLM labels, at dp=2 against one rank on the whole batch;
  a loss computed by one rank alone issues no collective; dropout masks
  differ between ranks; a mesh of one rank draws exactly what the
  engine without a mesh draws, and trains as it does in bf16 with
  accumulation.
- Checkpoints: a JAX dp=2 checkpoint loads into the port at dp=2 and
  the reverse, master and moments bitwise; a port save at dp=2 resumes
  at dp=1 and the reverse, with the dataloader's cursor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu_torch.parallel import DATA_AXIS, Mesh, get_current_mesh

from . import torch_dp_workers as W
from .torch_dist import run_ranks
from .unit.simple_model import SimpleModel as JSimple

WORLD = 2
TRAJ_RTOL = 1e-5
# the master after 10 steps against the JAX engine's, as the relative
# norm of the difference over the norm of the update, and elementwise:
# Adam's step on a near-zero gradient and Lamb's trust ratios carry the
# last-bit differences up.  Measured on the tiny GPT-2 at most 7.1e-5
# and 3.5e-5 at dp=2, and 7.2e-5 and 3.0e-5 between the two engines at
# dp=1 on the same global batches: the gap is the engines', not the
# exchange's.  SimpleModel: 1.2e-6 and 6e-8.
MASTER_UPDATE_RTOL = 1e-4
MASTER_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``get(fn, *args)``: ``fn`` on ``WORLD`` gloo ranks, run once per
    module and argument list."""
    cache = {}

    def get(fn, *args):
        key = (fn.__name__, args)
        if key not in cache:
            cache[key] = run_ranks(fn, WORLD, tmp_path_factory.mktemp(
                fn.__name__), *args)
        return cache[key]

    return get


def jax_engine(kind, config, dp=WORLD, data=None):
    mesh = jax_mesh({"data": dp}, devices=jax.devices("cpu")[:dp])
    if kind == "gpt2":
        model = GPT2LMHeadTPU(JConfig(**W.TINY))
    else:
        model = JSimple(W.HIDDEN, nlayers=2)
    _, params = W.model_and_params(kind)
    engine, *_ = jds.initialize(
        model=model,
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=dict(config), mesh=mesh, training_data=data)
    return engine


def jax_state(engine):
    flat, opt = engine.flat, engine.state["opt"]
    return {"master": flat.gather_master_unpadded(engine.state["master"]),
            "exp_avg": flat.gather_master_unpadded(opt.exp_avg),
            "exp_avg_sq": flat.gather_master_unpadded(opt.exp_avg_sq),
            "step": int(opt.step)}


CASES = [(kind, case) for kind in ("gpt2", "simple")
         for case in W.TRAJECTORY_CASES[kind]]
CASE_IDS = [f"{kind}-zero{s}-{o}-acc{a}" for kind, (s, o, a, _) in CASES]


@pytest.mark.parametrize("kind,case", CASES, ids=CASE_IDS)
def test_dp2_trajectory_matches_the_jax_engine(kind, case, spawned):
    stage, opt, acc, clip = case
    ranks = spawned(W.trajectories, kind)
    jengine = jax_engine(kind, W.dp_config(stage, opt, acc, clip, WORLD))
    start = jax_state(jengine)["master"].copy()
    it = iter(W.global_batches(kind, W.STEPS * acc, WORLD))
    want = [float(np.asarray(jengine.train_batch(it)))
            for _ in range(W.STEPS)]
    got = ranks[0][case]
    # every rank reports the global loss and gathers the same master
    assert ranks[1][case]["losses"] == got["losses"]
    np.testing.assert_array_equal(ranks[1][case]["master"], got["master"])
    np.testing.assert_allclose(got["losses"], want, rtol=TRAJ_RTOL, atol=0)
    assert_master_close(got["master"], jax_state(jengine)["master"], start)


def assert_master_close(got, want, start):
    diff = got - want
    assert np.linalg.norm(diff) <= MASTER_UPDATE_RTOL * np.linalg.norm(
        want - start)
    np.testing.assert_allclose(got, want, rtol=0, atol=MASTER_ATOL)


def test_dp2_fp16_skips_and_scales_as_the_jax_engine(spawned):
    """An inf in rank 0's slice at step 3: both engines skip that step
    alone, with the same loss scale after every step."""
    ranks = spawned(W.fp16_trace)
    jengine = jax_engine("simple", W.dp_config(
        2, "Adam", 1, 0.0, WORLD, fp16=dict(W.FP16)))
    scales, skipped, losses = [], [], []
    for batch in W.fp16_batches(WORLD):
        losses.append(float(np.asarray(jengine.train_batch(iter([batch])))))
        scales.append(float(jengine.loss_scale))
        skipped.append(int(jengine.skipped_steps))
    for got in ranks:
        assert got["skipped"] == skipped
        assert got["scales"] == scales
    assert skipped.index(1) == W.POISON_STEP and skipped[-1] == 1
    assert len(set(scales)) > 1
    keep = [i for i in range(W.STEPS) if i != W.POISON_STEP]
    np.testing.assert_allclose(np.array(ranks[0]["losses"])[keep],
                               np.array(losses)[keep], rtol=1e-2)


def test_dp2_equals_one_rank_on_the_global_batch(spawned):
    """BERT at ZeRO-2 whose halves count 1+3 and 5+7 MLM labels: the
    loss normaliser is the global batch's count, so dp=2 is one rank on
    the whole batch (a mean of the ranks' means would not be: it fails
    this test by 3.9e-3), in training and in ``eval_batch``."""
    ranks = spawned(W.self_consistency)
    model, params = W.model_and_params("bert")
    engine, *_ = tds.initialize(
        model=model, model_parameters=params, device="cpu",
        config=W.dp_config(2, "Lamb", 1, 1.0, 1, micro=W.MICRO * WORLD))
    start = engine.flat.gather_master_unpadded(engine.master)
    it = iter(W.bert_batches(W.SELF_STEPS, W.MICRO * WORLD))
    want = [float(engine.train_batch(it)) for _ in range(W.SELF_STEPS)]
    np.testing.assert_allclose(ranks[0]["bert_losses"], want,
                               rtol=TRAJ_RTOL, atol=0)
    assert_master_close(ranks[0]["bert_master"],
                        engine.flat.gather_master_unpadded(engine.master),
                        start)
    # eval_batch: every rank reports the global batch's loss
    want_eval = float(engine.eval_batch(W.bert_batches(
        1, W.MICRO * WORLD, seed=7)[0]))
    for got in ranks:
        np.testing.assert_allclose(got["bert_eval"], want_eval, rtol=1e-5)


def test_a_loss_outside_the_engine_issues_no_collective(spawned):
    """Rank 0 alone computes its slice's loss through the model while
    the engine's mesh is live: the engine's mesh is current only inside
    its own calls, so the loss counts rank 0's labels alone (a global
    count would need rank 1, hang, or count both halves)."""
    ranks = spawned(W.self_consistency)
    model, params = W.model_and_params("bert")
    engine, *_ = tds.initialize(
        model=model, model_parameters=params, device="cpu",
        config=W.dp_config(2, "Lamb", 1, 1.0, 1))
    want = float(engine.eval_batch(W.lone_eval_slice()))
    np.testing.assert_allclose(ranks[0]["lone_loss"], want, rtol=1e-6)
    assert "lone_loss" not in ranks[1]


def test_ranks_draw_their_own_dropout_and_one_rank_draws_the_engines(
        spawned):
    """The same batch with dropout 0.1 gives the two ranks different
    losses; a mesh of one rank (its own gloo group, the sharded path)
    trains bitwise as the engine without a mesh."""
    ranks = spawned(W.self_consistency)
    assert ranks[0]["dropout_loss"] != ranks[1]["dropout_loss"]
    engine = W.port_engine("gpt2", W.dp_config(2, "Adam", 1, 1.0, 1), None,
                           model_kw=W.DROPOUT)
    it = iter(W.gpt2_batches(W.SELF_STEPS, W.MICRO))
    want = [float(engine.train_batch(it)) for _ in range(W.SELF_STEPS)]
    for got in ranks:
        assert got["one_rank_losses"] == want
        np.testing.assert_array_equal(got["one_rank_master"],
                                      engine.master.numpy())


@pytest.mark.parametrize("stage,acc", W.ONE_RANK_BF16,
                         ids=[f"zero{s}-acc{a}" for s, a in W.ONE_RANK_BF16])
def test_one_rank_mesh_in_bf16_with_accumulation_is_the_engine_without(
        stage, acc, spawned):
    """bf16 with accumulation on a mesh of one rank, on its own gloo
    group (the spawned ranks) and without a process group (here), sums
    the micro-batches' gradients in fp32 and trains bitwise as the
    engine without a mesh; no mesh stays current after the engine's
    calls."""
    ranks = spawned(W.self_consistency)
    want = W.one_rank_bf16(stage, acc, None)
    got_here = W.one_rank_bf16(stage, acc, Mesh({DATA_AXIS: 1}))
    for got in [got_here] + [r[("bf16", stage, acc)] for r in ranks]:
        assert got["losses"] == want["losses"]
        np.testing.assert_array_equal(got["master"], want["master"])
    assert get_current_mesh() is None


@pytest.fixture(scope="module")
def checkpoint_runs(spawned, tmp_path_factory):
    """The JAX dp=2 checkpoint and the port's dp=1 one, then the spawned
    ranks' loads and saves (:func:`tests.torch_dp_workers.checkpoints`)."""
    root = tmp_path_factory.mktemp("dp_checkpoints")
    data = W.gpt2_samples()
    jeng = jax_engine("gpt2", W.ckpt_config(WORLD), data=data)
    for _ in range(3):
        jeng.train_batch()
    jeng.save_checkpoint(str(root / "jax"), sync=True)
    dp1 = W.loader_engine(1, None, micro=W.MICRO * WORLD)
    for _ in range(3):
        dp1.train_batch()
    dp1.save_checkpoint(str(root / "dp1"), sync=True)
    dp1_next = [float(dp1.train_batch()) for _ in range(3)]
    ranks = spawned(W.checkpoints, str(root / "jax"), str(root / "dp1"),
                    str(root))
    return {"root": root, "jax": jax_state(jeng),
            "jax_cursor": jeng.training_dataloader.state_dict(),
            "dp1_next": dp1_next, "ranks": ranks}


def test_jax_dp2_checkpoint_loads_into_the_port_at_dp2(checkpoint_runs):
    for got in checkpoint_runs["ranks"]:
        for name in ("master", "exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(got["loaded"][name],
                                          checkpoint_runs["jax"][name],
                                          err_msg=name)
        assert got["loaded"]["step"] == checkpoint_runs["jax"]["step"] == 3
        # the cursor the JAX engine saved, then two global batches of 4
        cursor = checkpoint_runs["jax_cursor"]
        assert got["cursor"] == {
            "epoch": cursor["epoch"],
            "samples_yielded": cursor["samples_yielded"] + 2 * 2 * W.MICRO}


def test_port_dp2_checkpoint_loads_into_the_jax_engine_at_dp2(
        checkpoint_runs):
    """Rank 0 wrote it, with the ``latest`` pointer; the JAX engine at
    dp=2 restores the ranks' gathered state bitwise."""
    root = checkpoint_runs["root"]
    assert (root / "port" / "latest").read_text().strip() == "global_step5"
    jeng = jax_engine("gpt2", W.ckpt_config(WORLD), data=W.gpt2_samples())
    jeng.load_checkpoint(str(root / "port"), strict=True)
    want = checkpoint_runs["ranks"][0]["saved"]
    got = jax_state(jeng)
    for name in ("master", "exp_avg", "exp_avg_sq", "step"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_port_checkpoint_resumes_across_dp2_and_dp1(checkpoint_runs):
    """dp=1 -> dp=2: the ranks' 3 steps after loading the dp=1 save
    follow the dp=1 run's own; dp=2 -> dp=1: a dp=1 engine loading the
    ranks' step-3 save takes their next 3 steps.  Both from the
    dataloader's cursor, counted in global samples."""
    ranks = checkpoint_runs["ranks"]
    np.testing.assert_allclose(ranks[0]["from_dp1_losses"],
                               checkpoint_runs["dp1_next"], rtol=TRAJ_RTOL,
                               atol=0)
    dp1 = W.loader_engine(1, None, micro=W.MICRO * WORLD)
    dp1.load_checkpoint(str(checkpoint_runs["root"] / "resume"), strict=True)
    got = [float(dp1.train_batch()) for _ in range(3)]
    np.testing.assert_allclose(got, ranks[0]["resume_losses"],
                               rtol=TRAJ_RTOL, atol=0)
    assert ranks[0]["files"] == ranks[1]["files"]
    assert "global_step3" in ranks[0]["files"]


def test_rollback_at_dp2_restores_every_rank(spawned, tmp_path_factory):
    """A NaN batch on rank 0 alone: the step's global flag makes both
    ranks skip, the guard escalates on both, and both load the
    checkpoint rank 0 wrote; the run then follows a fault-free one."""
    ckpt = tmp_path_factory.mktemp("dp_rollback")
    ranks = spawned(W.rollback, str(ckpt))
    for got in ranks:
        assert not any(np.isfinite(got["nan_losses"]))
        assert got["rollbacks"] == 1
        assert got["steps_after_rollback"] == 2
        assert got["skipped_after_rollback"] == 0
        np.testing.assert_allclose(got["losses"], got["ref_losses"],
                                   rtol=1e-6)
    assert ranks[0]["losses"] == ranks[1]["losses"]
