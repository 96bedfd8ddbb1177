"""The port's pipeline schedules, module and config (ROADMAP A13) against
the JAX package's, in one process: the instruction streams, the
partitioner, the layers' application on carried weights, the param tree
across the packages, the per-layer files and the ``pipeline`` block.
The engine on gloo ranks is ``tests/test_torch_pipe.py``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.runtime.pipe import PipelineModule as JPipelineModule
from deepspeed_tpu.runtime.pipe import schedule as jsched
from deepspeed_tpu.runtime.pipe.module import split_batch as jsplit
import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.layers import TransformerLayer
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.runtime.config import get_pipeline_config
from deepspeed_tpu_torch.runtime.pipe import PipelineModule, schedule
from deepspeed_tpu_torch.runtime.pipe.engine import InterleavedSchedule
from deepspeed_tpu_torch.runtime.pipe.module import split_batch
from deepspeed_tpu_torch.utils.params import (params_from_numpy,
                                              params_to_numpy, tree_leaves)

from . import torch_pipe_workers as W
from . import torch_tp_workers as TW
from .test_torch_pipe import (jax_carry_specs, jax_gpt_like_specs,
                              jax_linear_specs)
from tests.unit.test_pipe import mse_loss as j_mse
from tests.unit.test_pipe import xent_loss as j_xent

KINDS = {"train": "TrainSchedule", "inference": "InferenceSchedule",
         "dp": "DataParallelSchedule"}


def stream(sched):
    return [[(c.name, c.kwargs) for c in step] for step in sched]


@pytest.mark.parametrize("stages", range(1, 9))
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_streams_equal_the_jax_package(kind, stages):
    """Every stage's stream at 1-8 micro-batches is the JAX package's,
    and so are ``num_pipe_buffers`` and the 1F1B tick map."""
    for micro_batches in range(1, 9):
        for stage_id in range(stages):
            mine = getattr(schedule, KINDS[kind])(micro_batches, stages,
                                                  stage_id)
            ref = getattr(jsched, KINDS[kind])(micro_batches, stages,
                                               stage_id)
            assert stream(mine) == stream(ref)
            assert mine.num_pipe_buffers() == ref.num_pipe_buffers()
            if kind == "train":
                for t in range(2 * (micro_batches + stages - 1)):
                    assert mine._step_to_micro_batch(t) == \
                        ref._step_to_micro_batch(t)


def pairs_match(streams, stages, ring=False):
    """In every step each send has its receive on the neighbour (the
    next stage for activations, the previous for gradients; mod stages
    on a ring)."""
    for t in range(max(len(s) for s in streams)):
        want, got = [], []
        for s, st in enumerate(streams):
            step = st[t] if t < len(st) else []
            nxt = (s + 1) % stages if ring else s + 1
            prv = (s - 1) % stages if ring else s - 1
            for c in step:
                if isinstance(c, schedule.SendActivation):
                    want.append(("act", s, nxt))
                elif isinstance(c, schedule.RecvActivation):
                    got.append(("act", prv, s))
                elif isinstance(c, schedule.SendGrad):
                    want.append(("grad", s, prv))
                elif isinstance(c, schedule.RecvGrad):
                    got.append(("grad", nxt, s))
        assert sorted(want) == sorted(got), (t, want, got)


@pytest.mark.parametrize("stages,micro_batches,interleave", [
    (2, 1, 1), (2, 4, 1), (3, 5, 1), (4, 4, 1), (8, 3, 1),
    (2, 4, 2), (4, 8, 2), (3, 6, 3), (2, 2, 4)])
def test_every_send_meets_its_receive_in_the_same_step(stages, micro_batches,
                                                        interleave):
    """The engine batches each step's transfers (``batch_isend_irecv``),
    so the streams must pair up step by step, or a rank waits for ever.
    The interleaved stream also runs every (micro-batch, logical stage)
    forward once and backward once, in the JAX program's tick map
    (``engine.py:226-235``)."""
    if interleave == 1:
        for cls in (schedule.TrainSchedule, schedule.InferenceSchedule):
            pairs_match([list(cls(micro_batches, stages, s))
                         for s in range(stages)], stages)
        return
    scheds = [InterleavedSchedule(micro_batches, stages, s, interleave)
              for s in range(stages)]
    pairs_match([list(x) for x in scheds], stages, ring=True)
    seen = []
    for sch in scheds:
        for t in range(interleave * micro_batches + stages - 1):
            got = sch.work(t)
            w = t - sch.stage_id
            if not 0 <= w < interleave * micro_batches:
                assert got is None
                continue
            c = (w // stages) % interleave
            micro = (w // (stages * interleave)) * stages + (w % stages)
            assert got == (w, micro, c * stages + sch.stage_id)
            seen.append(got[1:])
        fwd = [c for step in sch for c in step
               if isinstance(c, schedule.ForwardPass)]
        bwd = [c for step in sch for c in step
               if isinstance(c, schedule.BackwardPass)]
        assert len(fwd) == len(bwd) == interleave * micro_batches
    assert sorted(seen) == sorted(
        (m, l) for m in range(micro_batches)
        for l in range(stages * interleave))


# ------------------------------------------------------------ partitioner
def test_partition_math_equals_the_jax_package():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n, parts = int(rng.integers(1, 40)), int(rng.integers(1, 9))
        weights = [int(x) for x in rng.integers(0, 1000, size=n)]
        assert tutils.partition_uniform(n, parts) == \
            jutils.partition_uniform(n, parts)
        assert tutils.partition_balanced(weights, parts) == \
            jutils.partition_balanced(weights, parts)
    assert tutils.tree_path_key(("layers", 3, "w")) == "layers/3/w"


@pytest.mark.parametrize("method", ["uniform", "parameters", "type:linear",
                                    "type:embed"])
@pytest.mark.parametrize("stages", [1, 2, 3, 4, 5])
def test_partition_layers_equals_the_jax_package(method, stages):
    """The GPT-like stack (a tied embedding, eight blocks, the tied head)
    split as the JAX module splits it; 'parameters' counts a tied table
    at its owning layer."""
    jmod = JPipelineModule(jax_gpt_like_specs(), loss_fn=j_xent)
    jparams = jmod.init(jax.random.PRNGKey(0))
    mod = PipelineModule(W.gpt_like_specs(), loss_fn=W.xent_loss)
    params = jax.tree_util.tree_map(np.asarray, jparams)
    counts = mod.layer_param_counts(params)
    assert counts == jmod.layer_param_counts(jparams)
    # drawn layer by layer, the counts are the same
    assert mod.layer_param_counts() == counts
    assert outcome(mod.partition_layers, stages, counts, method) == \
        outcome(jmod.partition_layers, stages, counts, method)


def outcome(fn, *args):
    """``fn``'s result, or the type of what it raised (the copied search
    fails alike on a weight vector of two ones among zeros)."""
    try:
        return fn(*args)
    except ValueError as e:
        return type(e)


# ---------------------------------------------------------------- module
def jax_and_port(kind):
    if kind == "lin":
        jmod = JPipelineModule(jax_linear_specs(), loss_fn=j_mse)
        mod = PipelineModule(W.linear_specs(), loss_fn=W.mse_loss)
        data = W.linear_data(1)[0]
    elif kind == "gpt":
        jmod = JPipelineModule(jax_gpt_like_specs(), loss_fn=j_xent)
        mod = PipelineModule(W.gpt_like_specs(), loss_fn=W.xent_loss)
        data = W.token_data(1)[0]
    else:
        jmod = JPipelineModule(jax_carry_specs(), loss_fn=j_mse)
        mod = PipelineModule(W.carry_specs(), loss_fn=W.mse_loss)
        data = W.linear_data(1)[0]
    jparams = jmod.init(jax.random.PRNGKey(1))
    return jmod, jparams, mod, data


@pytest.mark.parametrize("interval", [0, 1, 3])
@pytest.mark.parametrize("kind", ["lin", "gpt", "carry"])
def test_apply_range_and_sequential_apply_equal_jax(kind, interval):
    """On weights carried from the JAX module: every stage slice's output
    and the whole loss, and (recomputed every ``interval`` layers in
    backward) the loss's gradients, to rtol 1e-5."""
    jmod, jparams, mod, (x, y) = jax_and_port(kind)
    mod.activation_checkpoint_interval = interval
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    parts = jmod.partition_layers(2, method="uniform")
    want = jmod.apply_range(jparams, parts[0], parts[1], jnp.asarray(x))
    got = mod.apply_range(params, parts[0], parts[1], torch.from_numpy(x))
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    [got] if isinstance(got, torch.Tensor) else list(got)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jmod.sequential_apply(p, (jnp.asarray(x),
                                            jnp.asarray(y))))(jparams)
    leaves = tree_leaves(params)[1]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = mod.sequential_apply(params, (torch.from_numpy(x),
                                         torch.from_numpy(y)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(jgrad), leaves):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)
    for batch in ((x, y), {"inputs": x, "labels": y}, {"inputs": x}, x):
        assert [id(t) for t in split_batch(batch)] == \
            [id(t) for t in jsplit(batch)]


def test_pipe_tree_crosses_the_packages():
    """The ``{"layers": (...), "tied": {...}}`` tree: its leaves in the
    JAX order under the JAX checkpoint keys, the tuple kept, each
    ``[in, out]`` kernel as it is, and back to numpy bitwise."""
    jmod = JPipelineModule(jax_gpt_like_specs(), loss_fn=j_xent)
    jparams = jmod.init(jax.random.PRNGKey(2))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    assert isinstance(params["layers"], tuple)
    paths, leaves = tree_leaves(params)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert [tutils.tree_path_key(p) for p in paths] == \
        [jutils.tree_path_key(p) for p, _ in jflat]
    for leaf, (_, ref) in zip(leaves, jflat):
        assert tuple(leaf.shape) == ref.shape
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref))
    back = params_to_numpy(params)
    assert isinstance(back["layers"], tuple)
    np.testing.assert_array_equal(back["tied"]["emb"],
                                  np.asarray(jparams["tied"]["emb"]))


def test_stage_init_draws_only_its_layers_and_the_tied_copy():
    """``init_stage`` of the last two layers draws the head's bias and
    the tied table from the owner's seed: equal to the whole tree's."""
    mod = PipelineModule(W.gpt_like_specs(), loss_fn=W.xent_loss,
                         seed_layers=True)
    whole = mod.init(0)
    stage = PipelineModule(W.gpt_like_specs(), loss_fn=W.xent_loss,
                           seed_layers=True).init_stage(0, [8, 9])
    assert sorted(stage["layers"]) == [8, 9]
    np.testing.assert_array_equal(stage["tied"]["emb"], whole["tied"]["emb"])
    np.testing.assert_array_equal(stage["layers"][9]["bias"],
                                  whole["layers"][9]["bias"])
    assert "table" not in stage["layers"][9]
    # layers without partition_specs are replicated (A10's model axis:
    # the specs are the tree's, tied keys by their owner)
    specs = mod.partition_specs()
    assert specs["layers"] == (None,) * mod.num_layers
    assert specs["tied"] == {"emb": None}
    gpt, _ = TW.pipe_module()
    specs = gpt.partition_specs()
    assert specs["tied"] == {"embed": ("model", None)}
    assert specs["layers"][0] == {"wpe": (None, None)}
    assert specs["layers"][1] == TransformerLayer.partition_specs()
    # the final norm has no specs; the head's use of the tied embedding
    # keeps its own wpe, replicated
    assert specs["layers"][-2] is None
    assert specs["layers"][-1] == {"wpe": (None, None)}
    stage = gpt.stage_specs([0, 1])
    assert sorted(stage["layers"]) == [0, 1]
    assert stage["tied"] == {"embed": ("model", None)}


def test_per_layer_files_cross_the_packages(tmp_path):
    """``layer_NN-model_states.npz`` and ``tied_<key>-model_states.npz``
    written by either package load in the other."""
    jmod = JPipelineModule(jax_gpt_like_specs(), loss_fn=j_xent)
    jparams = jmod.init(jax.random.PRNGKey(3))
    mod = PipelineModule(W.gpt_like_specs(), loss_fn=W.xent_loss)
    jmod.save_state_dict(jparams, str(tmp_path / "jax"))
    template = params_from_numpy(mod.init(7), "cpu")
    got = mod.load_state_dir(template, str(tmp_path / "jax"))
    for a, b in zip(tree_leaves(got)[1], jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    mod.save_state_dict(got, str(tmp_path / "port"))
    back = jmod.load_state_dir(jmod.init(jax.random.PRNGKey(9)),
                               str(tmp_path / "port"))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------- config
def test_pipeline_block_parses_with_the_jax_defaults():
    cfg = get_pipeline_config({"train_batch_size": 8,
                               "pipeline": {"interleave": 2}})
    assert cfg == {"stages": None, "partition": "best",
                   "seed_layers": False, "activation_checkpoint_interval": 0,
                   "interleave": 2}


def test_pipeline_block_fills_the_module_defaults(caplog):
    """The JAX engine's precedence (``engine.py:303-330``): the block
    fills what the constructor left at its default, and a constructor
    interleave wins, with the block's value logged as ignored."""
    mod = PipelineModule(W.linear_specs(4), loss_fn=W.mse_loss)
    tds.initialize(model=mod, config=W.config(pipeline={
        "activation_checkpoint_interval": 1, "partition": "uniform",
        "interleave": 2}), device="cpu")
    assert mod.activation_checkpoint_interval == 1
    assert mod.partition_method == "uniform" and mod.interleave == 2
    mod = PipelineModule(W.linear_specs(4), loss_fn=W.mse_loss, interleave=3,
                         partition_method="type:linear")
    with caplog.at_level(logging.INFO):
        tds.initialize(model=mod, config=W.config(pipeline={
            "interleave": 2}), device="cpu")
    assert mod.interleave == 3 and mod.partition_method == "type:linear"
    assert "interleave=2 ignored" in caplog.text


# the ids are the ones these cases had while they held ZeRO-3 and
# OneBitAdam's refusals, which tests/test_torch_pipe_zero3.py now holds
# to the JAX engine
@pytest.mark.parametrize("extra,dims,item", [
    ({"zero_optimization": {"stage": 2, "cpu_offload": True}},
     {"pipe": 2}, None),
    ({}, {"pipe": 2, "expert": 2}, "A21"),
], ids=["extra0-A13 remainder", "extra1-A13 remainder"])
def test_unported_combinations_raise_naming_their_item(extra, dims, item,
                                                       monkeypatch):
    """What stays refused under a pipeline, before any collective: MoE
    under a pipeline, which the JAX package has no path for (A21).
    Offload under a pipe of 2, refused until A9 was ported, builds: the
    stage's host master is its own layers' rows (the construction's one
    collective, the pipe group's barrier, is stubbed: there is no
    process group here; tests/test_torch_offload_dp.py trains it)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import Mesh

    mod = PipelineModule(W.linear_specs(4), loss_fn=W.mse_loss)
    if item is None:
        monkeypatch.setattr(comm, "barrier", lambda *a, **k: None)
        eng, *_ = tds.initialize(model=mod, config=W.config(**extra),
                                 device="cpu", mesh=Mesh(dims))
        assert eng.stage_layers == [0, 1] and eng.master.device.type == "cpu"
        assert tuple(eng.master.shape) == eng.flat.shard_shape
        assert sum(eng.segments.sizes) == 2 * (W.HIDDEN + 1) * W.HIDDEN
        return
    with pytest.raises(NotImplementedError, match=item):
        tds.initialize(model=mod, config=W.config(**extra), device="cpu",
                       mesh=Mesh(dims))


def test_dropout_streams_replay_under_remat():
    """GPT-2 as a ``PipelineModule`` (``examples/train_torch_pipe.py``) at
    dropout 0.1: each (micro-batch, stage) draws its own stream, the
    same in every run, and per-layer remat replays it, so the losses and
    the master are bitwise the run without remat."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, random_params
    from examples import train_torch_pipe as tp

    cfg = GPT2Config(vocab_size=128, hidden_size=32, num_layers=2,
                     num_heads=4, max_position_embeddings=16,
                     embd_dropout=0.1, attn_dropout=0.1, resid_dropout=0.1)
    batches = tp.token_batches(cfg.vocab_size, 8, 16, 4, seed=5)
    runs = []
    for interval in (0, 1, 0):
        engine, *_ = tds.initialize(
            model=tp.gpt2_pipeline_module(
                cfg, activation_checkpoint_interval=interval),
            model_parameters=tp.pipe_params_from_gpt2(
                random_params(cfg, 0)),
            config=W.config(mb_size=2), device="cpu")
        losses = [float(engine.train_batch(iter(batches)))
                  for _ in range(3)]
        runs.append((losses, engine.master.clone()))
    assert runs[0][0] == runs[1][0] == runs[2][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert len(set(runs[0][0])) == 3
