"""The port's ``PipelineEngine`` (ROADMAP A13) on gloo CPU ranks against
the JAX package's ``PipelineEngine`` on the virtual CPU mesh, the
cases of JAX ``tests/unit/test_pipe.py`` at the same topologies.

The rank functions are :mod:`tests.torch_pipe_workers`; a world of 2
ranks (every pipe = 2 case) and one of 4 (pipe = 4 and pipe = 2 × data
= 2) are spawned once each.  The JAX side draws the weights, which the
port's stages take from the same numpy tree, and trains on the same
micro-batches.  Losses agree to ``RTOL``: the two engines sum the
micro-batches' gradients (and a tied param's uses) in other orders.
"""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu.runtime.pipe import LayerSpec as JLayerSpec
from deepspeed_tpu.runtime.pipe import PipelineModule as JPipelineModule
from deepspeed_tpu.runtime.pipe import TiedLayerSpec as JTiedLayerSpec
from tests.unit.test_pipe import Embed as JEmbed
from tests.unit.test_pipe import Linear as JLinear
from tests.unit.test_pipe import MergeCarry as JMerge
from tests.unit.test_pipe import SplitCarry as JSplit
from tests.unit.test_pipe import _lm_head as j_lm_head
from tests.unit.test_pipe import mse_loss as j_mse
from tests.unit.test_pipe import xent_loss as j_xent
from deepspeed_tpu_torch.checkpoint.snapshot import load_model_states
from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine

from . import torch_pipe_workers as W
from .torch_dist import run_ranks

# the losses against the JAX engine (its own pipe tests hold 2e-4)
RTOL = 2e-5
ATOL = 1e-7
# bf16 and fp16 compute: the packages round their products apart (the
# fp16 engine tests' tolerance, tests/test_torch_fp16.py)
HALF_RTOL = 1e-2


def jax_linear_specs(n=8):
    return [JLayerSpec(JLinear, W.HIDDEN, W.HIDDEN) for _ in range(n)]


def jax_gpt_like_specs(n_blocks=8):
    return ([JTiedLayerSpec("emb", JEmbed, W.VOCAB, W.HIDDEN,
                            tied_weight_attr="table")]
            + [JLayerSpec(JLinear, W.HIDDEN, W.HIDDEN)
               for _ in range(n_blocks)]
            + [JTiedLayerSpec("emb", JEmbed, W.VOCAB, W.HIDDEN,
                              forward_fn=j_lm_head,
                              tied_weight_attr="table")])


def jax_carry_specs():
    return [JLayerSpec(JSplit), JLayerSpec(JSplit), JLayerSpec(JSplit),
            JLayerSpec(JMerge)]


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_train(engine, data, steps=W.STEPS):
    return [float(np.asarray(jax.device_get(engine.train_batch(iter(data)))))
            for _ in range(steps)]


@pytest.fixture(scope="module")
def weights():
    """Whole-tree weights drawn by the JAX modules."""
    lin = JPipelineModule(jax_linear_specs(), loss_fn=j_mse)
    gpt = JPipelineModule(jax_gpt_like_specs(), loss_fn=j_xent,
                          seed_layers=True)
    carry = JPipelineModule(jax_carry_specs(), loss_fn=j_mse,
                            seed_layers=True)
    return {"lin": numpy_tree(lin.init(jax.random.PRNGKey(0))),
            "gpt": numpy_tree(gpt.init(jax.random.PRNGKey(0))),
            "carry": numpy_tree(carry.init(jax.random.PRNGKey(0)))}


def jax_run(kind, topo, weights, steps=W.STEPS, dp=1, interleave=1,
            **cfg_extra):
    """The JAX ``PipelineEngine`` on ``topo`` from the shared weights."""
    cfg = W.config(dp, **cfg_extra)
    if kind == "lin":
        specs, loss, kw, data = jax_linear_specs(), j_mse, \
            {"interleave": interleave}, W.linear_data()
    elif kind == "carry":
        specs, loss, kw, data = jax_carry_specs(), j_mse, \
            {"seed_layers": True}, W.linear_data()
    else:
        specs, loss, data = jax_gpt_like_specs(), j_xent, W.token_data()
        kw = {"partition_method": "uniform"}
    n = int(np.prod(list(topo.values())))
    mesh = jax_mesh(topo, devices=jax.devices("cpu")[:n])
    module = JPipelineModule(specs, loss_fn=loss, **kw)
    engine, *_ = jds.initialize(
        model=module, config=cfg, mesh=mesh,
        model_parameters=jax.tree_util.tree_map(jax.numpy.asarray,
                                                weights[kind]))
    return engine, jax_train(engine, data, steps)


@pytest.fixture(scope="module")
def jax_pipe4_checkpoint(weights, tmp_path_factory):
    """The JAX engine at pipe = 4 on the GPT-like stack: saved after 2
    steps; the losses of the 2 steps after."""
    path = str(tmp_path_factory.mktemp("jax_pipe4"))
    engine, _ = jax_run("gpt", {"pipe": 4}, weights, steps=2)
    engine.save_checkpoint(path)
    engine.wait_checkpoint()
    return path, jax_train(engine, W.token_data(), 2)


@pytest.fixture(scope="module")
def pipe2(weights, jax_pipe4_checkpoint, tmp_path_factory):
    save_dir = str(tmp_path_factory.mktemp("port_pipe2"))
    out = run_ranks(W.pipe2_world, 2, tmp_path_factory.mktemp("pipe2"),
                    weights["lin"], weights["gpt"], save_dir,
                    jax_pipe4_checkpoint[0])
    return out, save_dir


@pytest.fixture(scope="module")
def pipe4(weights, pipe2, tmp_path_factory):
    return run_ranks(W.pipe4_world, 4, tmp_path_factory.mktemp("pipe4"),
                     weights["lin"], weights["gpt"], weights["carry"],
                     pipe2[1])


def same_on_every_rank(ranks, case, key="losses"):
    first = ranks[0][case][key]
    for r in ranks[1:]:
        assert r[case][key] == first, (case, [x[case][key] for x in ranks])
    return first


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("case,kind,extra", [
    ("plain", "lin", {}),
    ("tied", "gpt", {}),
    ("interleave", "lin", {"interleave": 2}),
], ids=["pipe2", "pipe2-tied", "pipe2-interleave2"])
def test_pipe2_losses_match_the_jax_engine(pipe2, weights, case, kind,
                                           extra):
    ranks, _ = pipe2
    got = same_on_every_rank(ranks, case)
    _, want = jax_run(kind, {"pipe": 2}, weights, **extra)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("case,topo,kind,dp,extra", [
    ("pipe4", {"pipe": 4}, "lin", 1, {}),
    ("carry", {"pipe": 4}, "carry", 1, {}),
    ("pipe2_data2", {"pipe": 2, "data": 2}, "lin", 2,
     {"zero_optimization": {"stage": 2}}),
    ("pipe2_data2_tied_clip", {"pipe": 2, "data": 2}, "gpt", 2,
     {"zero_optimization": {"stage": 2}, "gradient_clipping": W.CLIP,
      "optimizer": W.CLIP_ADAM}),
    ("pipe2_data2_zero1_tied_clip", {"pipe": 2, "data": 2}, "gpt", 2,
     {"zero_optimization": {"stage": 1}, "gradient_clipping": W.CLIP,
      "optimizer": W.CLIP_ADAM}),
], ids=["pipe4", "pipe4-tuple-boundary", "pipe2-data2-zero2",
        "pipe2-data2-zero2-tied-clip", "pipe2-data2-zero1-tied-clip"])
def test_pipe4_world_losses_match_the_jax_engine(pipe4, weights, case, topo,
                                                 kind, dp, extra):
    got = same_on_every_rank(pipe4, case)
    steps = len(got)
    _, want = jax_run(kind, topo, weights, steps=steps, dp=dp, **extra)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("precision", list(W.HALF))
def test_pipe2_half_precision_matches_the_jax_engine(pipe2, weights,
                                                      precision):
    """bf16, and fp16 under the dynamic scaler, at pipe = 2 on the tied
    stack: the JAX engine's losses to the fp16 tests' tolerance.  The
    JAX pipeline program in bf16 at pipe = 2 aborts inside XLA's CPU
    compiler on this jaxlib, so bf16 is held to the JAX pipeline
    engine at one stage (the same math; fp16 at pipe = 2 compiles)."""
    ranks, _ = pipe2
    got = same_on_every_rank(ranks, f"tied_{precision}")
    topo = {"pipe": 2} if precision == "fp16" else {"data": 1}
    _, want = jax_run("gpt", topo, weights, **W.HALF[precision])
    np.testing.assert_allclose(got, want, rtol=HALF_RTOL, atol=0)
    assert all(np.isfinite(got))


def test_interleave_and_remat_match_their_plain_runs(pipe2):
    """Virtual stages (interleave 2) train as the plain schedule, and per
    layer remat as none: the same sums in the same order, so equal."""
    ranks, _ = pipe2
    np.testing.assert_allclose(same_on_every_rank(ranks, "interleave"),
                               same_on_every_rank(ranks, "plain"),
                               rtol=1e-6, atol=0)
    assert same_on_every_rank(ranks, "tied_remat") == \
        same_on_every_rank(ranks, "tied")
    for r in ranks:
        np.testing.assert_array_equal(r["tied_remat"]["master"],
                                      r["tied"]["master"])


def test_clipping_counts_the_tied_leaf_once(pipe2, weights):
    """The clip binds (the losses leave the unclipped run's), the JAX
    engine (the tied table once in its tree) agrees, and the two
    stages' copies of the tied table stay equal."""
    ranks, _ = pipe2
    clipped = same_on_every_rank(ranks, "tied_clip")
    free = same_on_every_rank(ranks, "tied_noclip")
    assert not np.allclose(clipped, free, rtol=1e-4)
    _, want = jax_run("gpt", {"pipe": 2}, weights, gradient_clipping=W.CLIP,
                      optimizer=W.CLIP_ADAM)
    np.testing.assert_allclose(clipped, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ranks[0]["tied_clip"]["tied_copy"],
                                  ranks[1]["tied_clip"]["tied_copy"])


def test_fp16_overflow_on_one_stage_skips_on_every_stage(pipe2):
    """An inf in stage 0's gradient at step 3: both stages skip that
    step (the master unchanged on each), halve the scale alike, and
    train on."""
    ranks, _ = pipe2
    traces = [r["fp16"] for r in ranks]
    for trace in traces:
        assert [t["skipped"] for t in trace] == [0, 0, 1, 1, 1]
        assert [t["unchanged"] for t in trace] == [False, False, True,
                                                   False, False]
        assert trace[2]["scale"] == trace[1]["scale"] / 2
        assert all(np.isfinite(t["loss"]) for t in trace)
    assert [t["scale"] for t in traces[0]] == [t["scale"] for t in traces[1]]
    assert [t["loss"] for t in traces[0]] == [t["loss"] for t in traces[1]]


def test_executed_stream_equals_schedule_trace(pipe2, pipe4):
    """Every rank's executed instructions are its ``schedule_trace``, and
    the activations in flight never exceed ``num_pipe_buffers``."""
    ranks, _ = pipe2
    cases = [(r, c) for r in ranks for c in ("plain", "interleave",
                                              "tied", "tied_remat")]
    cases += [(r, c) for r in pipe4 for c in ("pipe4", "pipe2_data2")]
    for r, case in cases:
        got = r[case]
        assert got["executed"] == got["trace"], case
        assert 1 <= got["max_live"] <= got["buffers"], case
    # 1F1B holds at most stages - stage + 1 micro-batches
    assert [r["pipe4"]["max_live"] for r in pipe4] == [4, 3, 2, 1]


def test_activation_metadata_crosses_each_boundary_once_a_batch(pipe2,
                                                                pipe4):
    """A batch's first activation across each stage boundary carries the
    metadata; every later one goes alone (4 micro-batches a batch)."""
    ranks, _ = pipe2
    M = W.MICRO_BATCHES

    def seen(case, rs):
        return [(r[case]["meta"]["encoded"], r[case]["meta"]["decoded"])
                for r in rs]

    # pipe 2: stage 0 sends M activations and one metadata tensor
    assert seen("plain", ranks) == [(1, 0), (0, 1)]
    assert [r["plain"]["meta"]["sends"] for r in ranks] == [M + 1, M]
    # interleave 2: rank 0 sends from logical stages 0 and 2, rank 1
    # from 1 (3 is the last) and receives into 1 and 3
    assert seen("interleave", ranks) == [(2, 1), (1, 2)]
    assert seen("pipe4", pipe4) == [(1, 0), (1, 1), (1, 1), (0, 1)]


def test_each_stage_holds_only_its_layers(pipe2, pipe4, weights):
    """A stage's flat master covers its layers and its copy of each tied
    param the layers use, and nothing else."""
    ranks, _ = pipe2
    gpt = weights["gpt"]

    def count(tree):
        return int(sum(np.prod(np.shape(x))
                       for x in jax.tree_util.tree_leaves(tree)))

    table = count(gpt["tied"])
    for r in ranks:
        layers = r["tied"]["layers"]
        want = sum(count(gpt["layers"][i]) for i in layers) + table
        assert r["tied"]["flat_params"] == want
        assert r["tied"]["master"].size == want
    assert ranks[0]["tied"]["layers"] == list(range(5))
    assert ranks[1]["tied"]["layers"] == list(range(5, 10))
    lin = weights["lin"]
    for r in pipe4:
        assert r["pipe4"]["flat_params"] == sum(
            count(lin["layers"][i]) for i in r["pipe4"]["layers"])


def test_interleave_refuses_ragged_micro_batches_and_too_few_layers(pipe2):
    """As the JAX engine asserts (``engine.py:117-126``): interleave 2
    at pipe 2 needs micro-batches divisible by the stages and a layer
    for each of the 4 logical stages."""
    ranks, _ = pipe2
    for r in ranks:
        ragged, few = r["interleave_refused"]
        assert ragged is not None and "divisible" in ragged
        assert few is not None and "logical stages" in few


def test_nonuniform_boundaries_raise_on_every_rank(pipe4):
    for r in pipe4:
        assert r["ragged"] is not None and "uniform" in r["ragged"]


# ----------------------------------------------------------- checkpoints
def test_port_pipe2_checkpoint_loads_in_jax_and_at_other_stage_counts(
        pipe2, pipe4, weights):
    """A checkpoint the port wrote at pipe = 2 holds the whole tree in the
    JAX package's layout (the tied table once, under ``tied/``); the
    JAX engine resumes from it at pipe 1 and 2, and the port at pipe 1
    and 4, each with the saving run's next losses."""
    ranks, save_dir = pipe2
    want = same_on_every_rank(ranks, "ckpt", "after")
    for topo in ({"data": 1}, {"pipe": 2}):
        engine, _ = jax_run("gpt", topo, weights, steps=0)
        engine.load_checkpoint(save_dir)
        np.testing.assert_allclose(jax_train(engine, W.token_data(), 2),
                                   want, rtol=RTOL, atol=ATOL)
    eng = W.engine(W.gpt_like_specs(), weights["gpt"], W.config(), None,
                   loss=W.xent_loss, partition_method="uniform")
    eng.load_checkpoint(save_dir, strict=True)
    np.testing.assert_allclose(W.train(eng, W.token_data(), 2), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(same_on_every_rank(pipe4, "from_pipe2",
                                                  "after"), want,
                               rtol=RTOL, atol=ATOL)
    tag = open(os.path.join(save_dir, "latest")).read().strip()
    keys = set(load_model_states(os.path.join(save_dir, tag)))
    jax_keys = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path)
                for path, _ in jax.tree_util.tree_flatten_with_path(
                    weights["gpt"])[0]}
    assert keys == jax_keys and "tied/emb" in keys


def test_jax_pipe4_checkpoint_resumes_in_the_port_at_pipe2(
        pipe2, jax_pipe4_checkpoint):
    ranks, _ = pipe2
    _, want = jax_pipe4_checkpoint
    got = same_on_every_rank(ranks, "from_jax", "after")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert ranks[0]["from_jax"]["global_steps"] == 4


# ------------------------------------------------------------------ comm
def test_offload_under_a_pipe_keeps_its_a9_refusal(tmp_path):
    """Refused until A9 was ported: offload at pipe 2 is bitwise the
    run without it, each stage's host master its own rows."""
    ranks = run_ranks(W.offload_pipe2, 2, tmp_path)
    for r in ranks:
        assert r[True]["losses"] == r[False]["losses"]
        np.testing.assert_array_equal(r[True]["master"], r[False]["master"])
        assert r[True]["host"] == ("cpu", r[True]["host"][1])
    assert ranks[0][True]["losses"] == ranks[1][True]["losses"]


def test_pipe_engine_at_one_stage_matches_the_jax_engine(weights):
    """At one stage the engine is gradient accumulation over the
    micro-batches (JAX ``engine.py:103-113``): the GPT-like stack's
    losses agree, the executed stream is ``DataParallelSchedule``'s."""
    eng = W.engine(W.gpt_like_specs(), weights["gpt"], W.config(), None,
                   loss=W.xent_loss, partition_method="uniform")
    got = W.train(eng, W.token_data())
    _, want = jax_run("gpt", {"data": 1}, weights)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert eng.executed == eng.schedule_trace(0)
    # one train_batch counts its micro-batches (JAX engine.py:380-385)
    assert eng.global_steps == W.STEPS
    assert eng.micro_steps == W.STEPS * W.MICRO_BATCHES
    assert eng.global_samples == W.STEPS * W.MICRO_BATCHES * W.MB_SIZE
    assert eng.is_gradient_accumulation_boundary()
    assert [c.name for c in eng.executed[-1]] == [
        "LoadMicroBatch", "ForwardPass", "BackwardPass", "ReduceGrads",
        "OptimizerStep"]
    loss = eng.eval_batch(iter(W.token_data()))
    assert torch.isfinite(loss) and loss.dim() == 0
    with pytest.raises(RuntimeError, match="train_batch"):
        eng.forward(W.token_data()[0])
    assert isinstance(eng, PipelineEngine)
