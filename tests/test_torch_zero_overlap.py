"""ZeRO's bucketed exchange (``overlap_comm``) and ZeRO-3 in the port
(ROADMAP A8) against the JAX package.

- :class:`BucketPlan`: boundaries, groups and the shard-major permutation
  equal the JAX plan's for the same leaf sizes (the cases of JAX
  ``tests/unit/test_comm_overlap.py:71-116``).
- dp=2: the port on two gloo processes (:mod:`tests.torch_zero_workers`)
  against the JAX engine at dp=2 on two virtual CPU devices, 10 steps of
  a tiny GPT-2 with Adam: ZeRO-2 bucketed, ZeRO-3 without and with
  overlap (and with overlap under remat), accumulation 1 and 2,
  clipping on and off.
- The port's bucketed exchange against its fused one, ZeRO-3 at one
  rank against ZeRO-2, the collectives and gathers of a step, the peak
  gathered bytes, checkpoints across stages, layouts, degrees and the
  two packages, and the config and its refusals (JAX
  ``test_comm_overlap.py:254-363``).
"""

import types

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
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JEngine
from deepspeed_tpu.runtime.zero.buckets import BucketPlan as JPlan
from deepspeed_tpu.runtime.zero.config import DeepSpeedZeroConfig as JZero
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.parallel import Mesh
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.runtime.zero.buckets import BucketPlan
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig

from . import torch_dp_workers as W
from . import torch_zero_workers as Z
from .torch_dist import run_ranks

WORLD = 2
# the losses against the JAX engine at dp=2 (the dp=1 trajectory tests'
# tolerance: XLA and gloo order the two ranks' sums differently)
TRAJ_RTOL = 1e-5
# the master after 10 steps against the JAX engine's, as the relative
# norm of the difference over the norm of the update, and elementwise.
# Measured on the tiny GPT-2 at most 4.0e-5 and 5.1e-5 for these cases
# (losses 1.7e-7), as the fused cases of test_torch_data_parallel.py
# measured 7.1e-5 and 3.5e-5: Adam's step on a near-zero gradient
# carries the engines' last-bit differences up.
MASTER_UPDATE_RTOL = 1e-4
MASTER_ATOL = 1e-4
# the port's bucketed exchange against its fused one, where the sums
# order differently: the clipped cases (the norm sums the shard-major
# rows in another order) and ZeRO-3 with overlap (its first step
# gathers the tied wte twice, at the embedding and the head, so its two
# gradients are reduced apart and then added).  Measured: at most 2.0e-5
# after 10 steps (losses 8.6e-8 relative).
REORDERED_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    return run_ranks(Z.overlap_trajectories, WORLD,
                     tmp_path_factory.mktemp("overlap"))


def jax_engine(config, dp=WORLD, model_kw=None):
    mesh = jax_mesh({"data": dp}, devices=jax.devices("cpu")[:dp])
    _, params = W.model_and_params("gpt2")
    engine, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JConfig(**dict(W.TINY, **(model_kw or {})))),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=dict(config), mesh=mesh)
    return engine


def jax_state(engine):
    flat, opt = engine.flat, engine.state["opt"]
    return {"master": flat.gather_master_unpadded(engine.state["master"]),
            "exp_avg": flat.gather_master_unpadded(opt.exp_avg),
            "exp_avg_sq": flat.gather_master_unpadded(opt.exp_avg_sq),
            "step": int(opt.step)}


# ----------------------------------------------------------------- plan
PLAN_CASES = [
    ([1024 * 3 + 5, 2048, 100, 4096 * 2, 7, 1024], 4, 5000, 9000, 1024),
    ([10 ** 6], 8, 10, 10, 1024),
    ([], 4, 10, 10, 1024),
    ([300, 5, 77, 1200, 64, 64, 9], 2, 400, 700, 32),
    ([4096 * 49 + 7, 192, 4096, 64, 64], 3, 5 * 10 ** 8, 5 * 10 ** 8, 1024),
]


@pytest.mark.parametrize("sizes,dp,rbs,abs_,lanes", PLAN_CASES,
                         ids=[f"case{i}" for i in range(len(PLAN_CASES))])
def test_bucket_plan_equals_the_jax_plan(sizes, dp, rbs, abs_, lanes):
    mine = BucketPlan(sizes, dp, rbs, abs_, lanes=lanes)
    ref = JPlan(sizes, dp=dp, reduce_bucket_size=rbs,
                allgather_bucket_size=abs_, lanes=lanes)
    assert mine.buckets == ref.buckets
    assert mine.ag_groups == ref.ag_groups
    assert mine.shape == ref.shape and mine.piece_rows == ref.piece_rows
    assert mine.leaf_rows() == ref.leaf_rows()
    assert mine.schedule() == ref.schedule()
    arr = np.random.default_rng(0).normal(size=sum(sizes)).astype(np.float32)
    storage = mine.scatter_unpadded(arr)
    assert np.array_equal(storage, ref.scatter_unpadded(arr))
    assert np.array_equal(mine.gather_unpadded(storage), arr)
    canon = mine.canonical_from_storage(storage)
    assert np.array_equal(canon, ref.canonical_from_storage(storage))
    assert np.array_equal(mine.storage_from_canonical(canon), storage)
    # the device helpers: leaves -> a bucket's block -> leaves
    leaves = [torch.from_numpy(np.random.default_rng(i).normal(size=s)
                               .astype(np.float32)) for i, s in
              enumerate(sizes)]
    shapes = [(s,) for s in sizes]
    for b in range(mine.n_buckets if sizes else 0):
        block = mine.bucket_block_from_leaves(leaves, b, torch.float32)
        bk = mine.buckets[b]
        want = ref.bucket_block_from_leaves([np.asarray(x) for x in leaves],
                                            b, jnp.float32)
        assert np.array_equal(block.numpy(), np.asarray(want))
        for i, t in zip(range(bk.leaf_lo, bk.leaf_hi),
                        mine.carve_bucket(block, b, shapes, torch.float32)):
            assert torch.equal(t, leaves[i])


# ----------------------------------------------------- dp=2 trajectories
CASE_IDS = [f"zero{s}-{'overlap' if o else 'fused'}-acc{a}-clip{c:g}"
            for s, o, a, c in Z.JAX_CASES]


@pytest.mark.parametrize("case", Z.JAX_CASES + [("remat", Z.REMAT_CASE)],
                         ids=CASE_IDS + ["zero3-overlap-remat"])
def test_dp2_trajectory_matches_the_jax_engine(case, trajectories):
    model_kw = None
    if case[0] == "remat":
        model_kw = Z.REMAT
    stage, overlap, acc, clip = case[-1] if model_kw else case
    jengine = jax_engine(Z.zero_config(stage, overlap, acc, clip, WORLD),
                         model_kw=model_kw)
    assert jengine.comm_overlap_enabled() == overlap
    start = jax_state(jengine)["master"].copy()
    it = iter(Z.gpt2_global(W.STEPS * acc, WORLD))
    want = [float(np.asarray(jengine.train_batch(it)))
            for _ in range(W.STEPS)]
    got = trajectories[0][case]
    for other in trajectories[1:]:
        assert other[case]["losses"] == got["losses"]
        assert np.array_equal(other[case]["master"], got["master"])
    np.testing.assert_allclose(got["losses"], want, rtol=TRAJ_RTOL)
    ref = jax_state(jengine)
    assert got["step"] == ref["step"] == W.STEPS
    update = np.linalg.norm(ref["master"] - start)
    assert np.linalg.norm(got["master"] - ref["master"]) \
        <= MASTER_UPDATE_RTOL * update
    np.testing.assert_allclose(got["master"], ref["master"], rtol=0,
                               atol=MASTER_ATOL)


@pytest.mark.parametrize("bucketed,fused,bitwise", [
    ((2, True, 2, 0.0), (2, False, 2, 0.0), True),
    ((3, False, 1, 1.0), (2, False, 1, 1.0), True),
    ((2, True, 1, 1.0), (2, False, 1, 1.0), False),
    ((3, True, 1, 0.0), (2, False, 1, 0.0), False),
], ids=["zero2-acc2", "zero3-fused", "zero2-clipped", "zero3-overlap"])
def test_bucketed_exchange_against_the_fused_one(bucketed, fused, bitwise,
                                                 trajectories):
    """Each element of the reduced gradient is the same two ranks' sum
    in both exchanges, so the steps are bitwise where nothing else sums
    in a new order; otherwise within the measured bound."""
    a, b = trajectories[0][bucketed], trajectories[0][fused]
    if bitwise:
        assert a["losses"] == b["losses"]
        for key in ("master", "exp_avg", "exp_avg_sq"):
            assert np.array_equal(a[key], b[key]), key
    else:
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
        np.testing.assert_allclose(a["master"], b["master"], rtol=0,
                                   atol=REORDERED_ATOL)


def test_collectives_a_step(trajectories):
    """One reduce-scatter a bucket and the step's stats all-reduce; the
    compute params come back in one all-gather per ``ag_group`` (ZeRO-2),
    or are gathered per group in the forward and again in the backward
    (ZeRO-3: the block-aligned groups are each used in one stretch of the
    forward and of the backward)."""
    for got in (r[("counts", 2)] for r in trajectories):
        nb, ng = got["n_buckets"], got["n_groups"]
        assert nb == ng == 3
        assert got["calls"]["reduce_scatter"] == nb
        assert got["calls"]["all_gather"] == ng
        # the stats all-reduce, and the loss's label count
        assert got["bytes"]["psum"] <= 16
        # the fp32 flat gradient, once
        assert got["bytes"]["reduce_scatter"] == got["rows"] * 1024 * 4
        assert got["schedule"] == {
            "overlap": True, "rs_buckets": nb, "ag_buckets": ng,
            "reduce_bucket_size": 50000, "allgather_bucket_size": 50000,
            "rows": got["rows"]}
    for got in (r[("counts", 3)] for r in trajectories):
        ng = got["n_groups"]
        assert got["gathers"] == {"forward": ng, "backward": ng}
        assert got["calls"]["all_gather"] == 2 * ng
        assert got["calls"]["reduce_scatter"] == got["n_buckets"]
        # twice the flat compute buffer (fp32 here) a step
        assert got["bytes"]["all_gather"] == 2 * got["rows"] * 1024 * 4


def test_zero3_overlap_under_remat(trajectories):
    """Activation checkpointing recomputes each block in the backward and
    reads its params again: the recompute takes the group the backward
    gathers for the block's gradient, so every group is still gathered
    once in the forward and once in the backward, and the steps are
    the run's without remat, bitwise (no dropout; the same sums)."""
    for got in (r[("counts", 3, "remat")] for r in trajectories):
        ng = got["n_groups"]
        assert got["gathers"] == {"forward": ng, "backward": ng}
        assert got["calls"]["all_gather"] == 2 * ng
        assert got["calls"]["reduce_scatter"] == got["n_buckets"]
        two = sum(sorted(got["group_bytes"])[-2:])
        assert 0 < got["peak"] <= two
    for r in trajectories:
        a, b = r[("remat", Z.REMAT_CASE)], r[Z.REMAT_CASE]
        assert a["losses"] == b["losses"]
        for key in ("master", "exp_avg", "exp_avg_sq"):
            assert np.array_equal(a[key], b[key]), key


def test_zero3_peak_gathered_bytes_is_two_groups(trajectories):
    for got in (r[("counts", 3)] for r in trajectories):
        two = sum(sorted(got["group_bytes"])[-2:])
        assert 0 < got["peak"] <= two < sum(got["group_bytes"])


def _one_rank(stage, acc=1, bf16=False, remat=False, offload=False):
    cfg = W.dp_config(stage, "Adam", acc, 1.0, 1)
    if bf16:
        cfg["bf16"] = {"enabled": True}
    if offload:
        cfg["zero_optimization"]["cpu_offload"] = True
    model = GPT2LMHead(GPT2Config(**dict(W.TINY, remat=remat)))
    _, params = W.model_and_params("gpt2")
    engine, *_ = tds.initialize(model=model, model_parameters=params,
                                config=cfg, device="cpu")
    it = iter(W.gpt2_batches(3 * acc, W.MICRO))
    losses = [float(engine.train_batch(it)) for _ in range(3)]
    return losses, engine.flat.gather_master_unpadded(engine.master), engine


@pytest.mark.parametrize("kw", [{}, {"acc": 2, "bf16": True},
                                {"remat": True}, {"offload": True}],
                         ids=["fp32", "bf16-acc2", "remat", "offload"])
def test_zero3_at_one_rank_is_bitwise_zero2(kw):
    """Without overlap (one rank) ZeRO-3 gathers the master's cast before
    each forward and frees it after the backward: the same numbers as
    ZeRO-2's persistent cast."""
    l2, m2, _ = _one_rank(2, **kw)
    l3, m3, engine = _one_rank(3, **kw)
    assert l2 == l3 and np.array_equal(m2, m3)
    # no compute params persist between the steps
    assert engine._compute.untyped_storage().nbytes() == 0
    assert engine.eval_batch(W.gpt2_batches(1, W.MICRO)[0]) is not None
    assert engine._compute.untyped_storage().nbytes() == 0


# ---------------------------------------------------------- checkpoints
@pytest.fixture(scope="module")
def checkpoint_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("overlap_ckpt")
    jeng = jax_engine(Z.zero_config(2, True, 1, 0.0, WORLD))
    it = iter(Z.gpt2_global(3, WORLD))
    for _ in range(3):
        jeng.train_batch(it)
    jeng.save_checkpoint(str(root / "jax"), sync=True)
    jeng.wait_checkpoint()
    ranks = run_ranks(Z.overlap_checkpoints, WORLD, root / "ranks",
                      str(root / "jax"), str(root))
    return {"root": root, "ranks": ranks, "jax": jax_state(jeng),
            "jax_next": float(np.asarray(jeng.train_batch(iter(
                Z.gpt2_global(1, WORLD, seed=3)))))}


def _same(a, b):
    for key in ("master", "exp_avg", "exp_avg_sq", "step"):
        assert np.array_equal(a[key], b[key]), key


def test_checkpoints_cross_stages_and_layouts_at_dp2(checkpoint_runs):
    for got in checkpoint_runs["ranks"]:
        for key in ((2, False), (2, True), (3, False)):
            _same(got[key], got["saved"])


def test_checkpoints_cross_between_the_packages(checkpoint_runs):
    """The JAX engine's bucketed ZeRO-2 file into the port's ZeRO-3 with
    overlap, and the port's file into the JAX engine's ZeRO-3 with
    overlap: bitwise, and the next step as the JAX engine's."""
    got = checkpoint_runs["ranks"][0]
    _same(got["from_jax"], checkpoint_runs["jax"])
    np.testing.assert_allclose(got["from_jax_loss"][0],
                               checkpoint_runs["jax_next"], rtol=TRAJ_RTOL)
    jeng = jax_engine(Z.zero_config(3, True, 1, 0.0, WORLD))
    jeng.load_checkpoint(str(checkpoint_runs["root"] / "z3"), strict=True)
    _same(jax_state(jeng), got["saved"])


def test_checkpoints_cross_to_one_rank(checkpoint_runs):
    saved = checkpoint_runs["ranks"][0]["saved"]
    for stage in (2, 3):
        model, params = W.model_and_params("gpt2")
        engine, *_ = tds.initialize(
            model=model, model_parameters=params,
            config=W.dp_config(stage, "Adam", 1, 0.0, 1), device="cpu")
        engine.load_checkpoint(str(checkpoint_runs["root"] / "z3"),
                               strict=True)
        _same(W.state(engine), saved)


# --------------------------------------------------------------- config
def test_overlap_comm_config_validation():
    for cls in (DeepSpeedZeroConfig, JZero):
        with pytest.raises(ValueError, match="overlap_comm"):
            cls({"zero_optimization": {"stage": 2, "overlap_comm": "yes"}})
        with pytest.raises(ValueError, match="reduce_bucket_size"):
            cls({"zero_optimization": {"stage": 2, "reduce_bucket_size": 0}})
        with pytest.raises(ValueError, match="allgather_bucket_size"):
            cls({"zero_optimization": {"stage": 2,
                                       "allgather_bucket_size": True}})
        with pytest.raises(ValueError, match="reduce_bucket_size"):
            cls({"zero_optimization": {"stage": 2,
                                       "reduce_bucket_size": 1.5}})
        cfg = cls({"zero_optimization": {"stage": 3}})
        assert cfg.overlap_comm == "auto" and cfg.stage == 3
        cfg = cls({"zero_optimization": {
            "stage": 2, "reduce_bucket_size": 5e8,
            "allgather_bucket_size": 2.5e8}})
        assert cfg.reduce_bucket_size == 500000000
        assert isinstance(cfg.reduce_bucket_size, int)
        assert cfg.allgather_bucket_size == 250000000


def _stub(engine_cls, stage, dp, opt, offload, sparse, jax_side):
    """What each engine's ``_resolve_comm_overlap`` reads, and nothing
    else."""
    config = types.SimpleNamespace(sparse_gradients_enabled=sparse,
                                   optimizer_name=opt)
    if jax_side:
        mesh = types.SimpleNamespace(axis_names=("data",),
                                     devices=np.zeros((dp,)))
    else:
        mesh = Mesh({"data": dp})
    return types.SimpleNamespace(zero_stage=stage, dp_world_size=dp,
                                 mesh=mesh, _config=config)


RESOLVE_GRID = [(stage, dp, opt, offload, sparse, overlap)
                for stage in (0, 1, 2, 3) for dp in (1, 2)
                for opt in ("Adam", "AdamW", "Lamb", "OneBitAdam")
                for offload, sparse in ((False, False), (True, False),
                                        (False, True))
                for overlap in ("auto", True, False)]


def test_auto_and_true_resolve_as_in_the_jax_package():
    """Over every stage, degree, optimizer, offload and sparse gradient
    setting: ``"auto"`` turns the bucketed exchange on exactly where the
    JAX package does, ``true`` raises the same message, ``false`` keeps
    the fused exchange."""
    for stage, dp, opt, offload, sparse, overlap in RESOLVE_GRID:
        zc = types.SimpleNamespace(overlap_comm=overlap, cpu_offload=offload)
        out = []
        for cls, jax_side in ((DeepSpeedEngine, False), (JEngine, True)):
            stub = _stub(cls, stage, dp, opt, offload, sparse, jax_side)
            try:
                out.append(cls._resolve_comm_overlap(stub, zc, None))
            except ValueError as e:
                out.append(str(e))
        assert out[0] == out[1], (stage, dp, opt, offload, sparse, overlap)


def _port(zero, mesh=None, **over):
    cfg = dict(W.dp_config(zero.get("stage", 0), "Adam", 1, 0.0, 1),
               zero_optimization=zero, **over)
    if mesh is not None:
        cfg["train_batch_size"] *= mesh.size("data")
    model, params = W.model_and_params("simple")
    return tds.initialize(model=model, model_parameters=params, config=cfg,
                          mesh=mesh, device="cpu")


def test_overlap_comm_true_raises_on_unsupported():
    mesh2 = Mesh({"data": 2})
    with pytest.raises(ValueError, match="stage 2"):
        _port({"stage": 1, "overlap_comm": True}, mesh2)
    with pytest.raises(ValueError, match="dp > 1"):
        _port({"stage": 2, "overlap_comm": True}, Mesh({"data": 1}))
    with pytest.raises(ValueError, match="cpu_offload"):
        _port({"stage": 2, "overlap_comm": True, "cpu_offload": True},
              mesh2)
    with pytest.raises(ValueError, match="Adam"):
        _port({"stage": 2, "overlap_comm": True}, mesh2,
              optimizer={"type": "Lamb", "params": {"lr": 1e-3}})


def test_stage3_unmet_requirements_raise_loudly():
    mesh2 = Mesh({"data": 2})
    with pytest.raises(ValueError,
                       match=r"sparse_gradients: true requires ZeRO stage 0"):
        _port({"stage": 3}, sparse_gradients=True)
    with pytest.raises(ValueError, match="dp > 1"):
        _port({"stage": 3, "overlap_comm": True}, Mesh({"data": 1}))
    with pytest.raises(ValueError, match="cpu_offload"):
        _port({"stage": 3, "overlap_comm": True, "cpu_offload": True},
              mesh2)
    with pytest.raises(ValueError, match="Adam"):
        _port({"stage": 3, "overlap_comm": True}, mesh2,
              optimizer={"type": "Lamb", "params": {"lr": 1e-3}})
    # offload above one rank (refused until A9 was ported) builds: its
    # host master is the rank's half of the rows, and ZeRO-3 gathers no
    # compute params before the first forward
    engine, *_ = _port({"stage": 3, "cpu_offload": True}, mesh2)
    assert engine.master.device.type == "cpu"
    assert 2 * engine.master.shape[0] == engine.segments.rows
    assert engine._compute.untyped_storage().nbytes() == 0


def test_overlap_off_keeps_the_fused_layout():
    engine, *_ = _port({"stage": 3})
    assert not engine.comm_overlap_enabled()
    assert engine.flat.plan is None and engine.collective_schedule() is None
    assert engine.flat.flat_shape == engine.segments.shape
