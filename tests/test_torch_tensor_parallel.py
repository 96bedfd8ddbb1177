"""Tensor parallelism of the port (ROADMAP A10, the ``model`` axis)
against the JAX engine on the same mesh.

The port runs on two gloo processes (:func:`tests.torch_dist.run_ranks`,
the rank functions in :mod:`tests.torch_tp_workers`), each holding its
Megatron slices of the params, through ``initialize(mesh=make_mesh(
{"model": 2}))``; the JAX engine runs in this process on ``{"model":
2}`` over two of the conftest's virtual CPU devices, where GSPMD slices
the same math.  One spawn serves every case; the JAX trajectories are
built once for the module (the JAX package's own TP test is marked slow,
so these run at tiny widths).

- GPT-2 at ZeRO-2 with Adam and with Lamb, a clip that binds, at ZeRO-3
  (held to the JAX ZeRO-2 Adam run), and BERT (Lamb, ZeRO-1, the MLM
  gather: the last layer's rank-sliced QKV read at the labeled rows):
  losses within ``RTOL`` of the JAX engine's over
  5 steps, the whole master close (the sums over the two ranks are
  ordered otherwise than XLA's), the leaves no axis cuts bitwise equal
  on both ranks (their gradients are the same there, with no exchange).
- Against the port's own one-rank run: the chunked LM loss, dropout
  0.1 (the ranks draw the masks of their global heads, so the run is
  the one-rank run's), and ``eval_batch``'s gathered logits.
- ``partition_activations``: bitwise the remat run without it, keeping
  half of the checkpointed inputs' bytes.
- Checkpoints: saved at model 2, loaded at model 1 in the port and in
  the JAX package (the whole-tree layout); the JAX engine's checkpoint
  loaded at model 2, then two steps as the JAX engine takes them.
- In one process: ``tp_slice`` / ``tp_gather`` round trips over GPT-2,
  BERT and MoE trees, the per-head QKV cut against a contiguous one,
  the refusals that remain (ROADMAP A21, A9) and the combinations A18
  ported, and a strided all-reduce buffer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models import BertConfig as JBertConfig
from deepspeed_tpu.models import BertForPreTrainingTPU
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu_torch.comm import axis_size
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from deepspeed_tpu_torch.models.layers import TransformerLayer
from deepspeed_tpu_torch.parallel import Mesh, current_mesh
from deepspeed_tpu_torch.utils.params import (EXPERT, MODEL, QKV,
                                              params_from_numpy, tp_gather,
                                              tp_slice, tree_leaves)

from . import torch_tp_workers as W
from .torch_dist import run_ranks

WORLD = 2
# losses against the JAX engine on the same mesh, and against the port's
# own one-rank run
RTOL = 1e-5
# the whole master after 5 steps: Adam's step on near-zero gradients
# carries the last-bit differences of the two ranks' sums up (2.0e-5
# measured against the port's one-rank run at model 2)
MASTER_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def restore_jax_current_mesh():
    """The JAX engines built here make their mesh the JAX package's
    current mesh, which its MoE layer and ring attention read when given
    none: the module puts back the mesh it found, so the test files run
    after it in this process see that one."""
    from deepspeed_tpu.parallel import mesh as jax_mesh_state

    prev = jax_mesh_state.get_current_mesh()
    yield
    jax_mesh_state.set_current_mesh(prev)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_engine(model, params, cfg, dims):
    n = int(np.prod(list(dims.values())))
    mesh = jax_mesh(dims, devices=jax.devices("cpu")[:n])
    engine, *_ = jds.initialize(
        model=model, model_parameters=jax.tree_util.tree_map(
            jnp.asarray, params), config=dict(cfg), mesh=mesh)
    return engine


def jax_train(engine, batches, steps=W.STEPS):
    it = iter(batches)
    return [float(np.asarray(engine.train_batch(it))) for _ in range(steps)]


def jax_master(engine):
    return engine.flat.gather_master_unpadded(engine.state["master"])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX trajectories at ``{model: 2}``, the JAX engine's
    checkpoint after the Adam run, and the port's two ranks."""
    out = {}
    dims = {"model": WORLD}
    for name, opt in (("adam", W.ADAM), ("lamb", W.LAMB)):
        _, params = W.gpt2()
        eng = jax_engine(GPT2LMHeadTPU(JConfig(**W.TINY)), params,
                         W.config(opt), dims)
        out[name] = {"losses": jax_train(eng, W.gpt2_batches(W.STEPS)),
                     "master": jax_master(eng)}
        if name == "adam":
            jax_dir = str(tmp_path_factory.mktemp("jax_ckpt"))
            eng.save_checkpoint(jax_dir)
            eng.wait_checkpoint()
            out["jax_dir"] = jax_dir
            out["resumed"] = {"master": jax_master(eng),
                              "losses": jax_train(eng, W.gpt2_batches(
                                  W.RESUME_STEPS, seed=4), W.RESUME_STEPS)}
    _, params = W.bert()
    eng = jax_engine(BertForPreTrainingTPU(JBertConfig(**W.BERT_TINY)),
                     params, W.config(W.LAMB, stage=1), dims)
    out["bert"] = {"losses": jax_train(eng, W.bert_batches(W.STEPS)),
                   "master": jax_master(eng)}
    save_dir = str(tmp_path_factory.mktemp("port_ckpt"))
    out["save_dir"] = save_dir
    out["ranks"] = run_ranks(W.model2_world, WORLD,
                             tmp_path_factory.mktemp("ranks"), save_dir,
                             out["jax_dir"])
    return out


def port_one_rank(model, params, cfg, batches, steps=W.STEPS):
    eng = W.engine(model, params, cfg)
    return eng, W.train(eng, batches, steps)


@pytest.mark.parametrize("name", ["adam", "lamb", "bert", "zero3"])
def test_model2_matches_the_jax_engine_on_the_same_mesh(ref, name):
    """ZeRO-3 at model 2 (each rank's flat its own slices) is held to the
    JAX engine's ZeRO-2 Adam trajectory: the stage does not change the
    math."""
    got0, got1 = (r[name] for r in ref["ranks"])
    want = ref["adam" if name == "zero3" else name]
    assert got0["losses"] == got1["losses"]
    np.testing.assert_array_equal(got0["master"], got1["master"])
    np.testing.assert_allclose(got0["losses"], want["losses"], rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(got0["master"], want["master"], rtol=0,
                               atol=MASTER_ATOL)


@pytest.mark.parametrize("name", ["adam", "lamb"])
def test_replicated_leaves_stay_identical_on_every_model_rank(ref, name):
    """Layernorms, row-parallel biases and ``wpe`` take the same gradient
    on both ranks (no exchange), so their masters stay bitwise equal."""
    a, b = (r[name]["replicated"] for r in ref["ranks"])
    assert set(a) == set(b) and any("ln_attn" in k for k in a)
    assert "wpe" in a and not any(k.startswith("wte") for k in a)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_model2_dropout_and_chunked_loss_equal_one_rank(ref):
    """At dropout 0.1 the ranks drop their global heads' entries, so the
    model-2 run is the one-rank run; so is the chunked LM loss."""
    got = ref["ranks"][0]
    model, params = W.gpt2(**W.DROPOUT)
    _, want = port_one_rank(model, params, W.config(W.ADAM),
                            W.gpt2_batches(W.STEPS))
    np.testing.assert_allclose(got["dropout"], want, rtol=RTOL, atol=0)
    model, params = W.gpt2()
    _, want = port_one_rank(model, params, W.config(W.ADAM),
                            W.gpt2_batches(W.STEPS))
    np.testing.assert_allclose(got["chunk"], want, rtol=RTOL, atol=0)


def test_eval_batch_gathers_the_logits_whole(ref):
    model, params = W.gpt2()
    eng, _ = port_one_rank(model, params, W.config(W.ADAM),
                           W.gpt2_batches(W.STEPS))
    want = eng.eval_batch(W.gpt2_batches(1, seed=9)[0]).numpy()
    for r in ref["ranks"]:
        assert r["eval_logits"].shape == want.shape
        np.testing.assert_allclose(r["eval_logits"], want, rtol=0,
                                   atol=1e-4)
    model, params = W.bert()
    eng, _ = port_one_rank(model, params, W.config(W.LAMB, stage=1),
                           W.bert_batches(W.STEPS))
    batch = W.bert_batches(1, seed=6)[0]
    batch.pop("masked_lm_labels")
    want = eng.eval_batch(batch).numpy()
    np.testing.assert_allclose(ref["ranks"][0]["bert"]["logits"], want,
                               rtol=0, atol=1e-4)
    want = float(eng.eval_batch(W.bert_batches(1, seed=5)[0]))
    np.testing.assert_allclose(ref["ranks"][0]["bert"]["eval"], want,
                               rtol=RTOL)


def test_partition_activations_is_bitwise_and_keeps_half(ref):
    for r in ref["ranks"]:
        off, on = r["remat"][False], r["remat"][True]
        assert on["losses"] == off["losses"]
        np.testing.assert_array_equal(on["master"], off["master"])
        assert off["stats"]["full_bytes"] == 0
        assert on["stats"]["full_bytes"] > 0
        assert on["stats"]["kept_bytes"] * WORLD == on["stats"]["full_bytes"]


def test_checkpoint_at_model2_loads_at_model1_and_in_jax(ref):
    """The model-2 save is the JAX whole-tree layout: the port at one
    rank and the JAX engine load it, master bitwise the ranks' gathered
    master."""
    want = ref["ranks"][0]["adam"]["master"]
    model, params = W.gpt2()
    eng = W.engine(model, params, W.config(W.ADAM))
    eng.load_checkpoint(ref["save_dir"], strict=True)
    np.testing.assert_array_equal(W.whole_master(eng), want)
    _, params = W.gpt2()
    jeng = jax_engine(GPT2LMHeadTPU(JConfig(**W.TINY)), params,
                      W.config(W.ADAM), {"data": 1})
    jeng.load_checkpoint(ref["save_dir"])
    np.testing.assert_array_equal(jax_master(jeng), want)


def test_jax_checkpoint_loads_at_model2_and_resumes(ref):
    for r in ref["ranks"]:
        np.testing.assert_array_equal(r["resumed"]["master"],
                                      ref["resumed"]["master"])
        np.testing.assert_allclose(r["resumed"]["losses"],
                                   ref["resumed"]["losses"], rtol=RTOL)


# ------------------------------------------------------- one process
def _trees():
    g = GPT2Config(**W.TINY)
    moe = GPT2Config(**dict(W.TINY, **W.MOE))
    b = BertConfig(**W.BERT_TINY)
    return {"gpt2": (GPT2LMHead(g), W.gpt2()[1]),
            "moe": (GPT2LMHead(moe), W.gpt2(**W.MOE)[1]),
            "bert": (BertForPreTraining(b), W.bert()[1])}


@pytest.mark.parametrize("kind", ["gpt2", "moe", "bert"])
@pytest.mark.parametrize("sizes", [{MODEL: 2}, {MODEL: 4}, {EXPERT: 2},
                                   {MODEL: 2, EXPERT: 2}],
                         ids=["m2", "m4", "e2", "m2e2"])
def test_tp_slice_and_gather_round_trip(kind, sizes):
    model, tree = _trees()[kind]
    specs = model.partition_specs()
    m, e = sizes.get(MODEL, 1), sizes.get(EXPERT, 1)
    pieces = {(i, j): tp_slice(tree, specs, {MODEL: i, EXPERT: j}, sizes)
              for i in range(m) for j in range(e)}
    whole = tp_gather(pieces, specs, sizes)
    paths, want = tree_leaves(tree)
    got_paths, got = tree_leaves(whole)
    assert got_paths == paths
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # a rank holds less where a leaf is cut over these axes (the dense
    # models have no expert leaves)
    _, local = tree_leaves(pieces[(m - 1, e - 1)])
    cut = m > 1 or kind == "moe"
    assert (sum(x.size for x in local) < sum(x.size for x in want)) == cut


def test_qkv_is_cut_by_heads_inside_q_k_and_v():
    """Rank r of m holds heads [r·h/m, (r+1)·h/m) of each of Q, K and V:
    the ranks' row-parallel partials of the attention sublayer sum to the
    whole sublayer's output; a contiguous cut of the 3·hidden columns
    (rank 0: all of Q and half of K) does not."""
    layer = TransformerLayer(64, 4, causal=True, attn_dropout_ratio=0.0,
                             hidden_dropout_ratio=0.0, pre_layer_norm=True)
    tree = layer.init(5)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 64), dtype=np.float32))
    p = params_from_numpy(tree, "cpu")
    with torch.no_grad():
        want = layer.attention_core(p, y) @ p["attn_out"]["kernel"]

    def summed(contiguous):
        total = 0
        for r in range(2):
            part = tp_slice(tree, TransformerLayer.partition_specs(),
                            {MODEL: r, EXPERT: 0}, {MODEL: 2})
            if contiguous:
                cols = slice(96 * r, 96 * (r + 1))
                part["qkv"] = {"kernel": tree["qkv"]["kernel"][:, cols],
                               "bias": tree["qkv"]["bias"][cols]}
            part = params_from_numpy(part, "cpu")
            # rank r of a 2-rank model axis; its forward collectives are
            # identities here, so the partial is the rank's own
            with torch.no_grad(), current_mesh(Mesh({"model": 2}, rank=r)):
                assert axis_size("model") == 2
                assert layer.local_heads(part) == (2, 2 * r)
                total = total + layer.attention_core(part, y) \
                    @ part["attn_out"]["kernel"]
        return total

    torch.testing.assert_close(summed(False), want, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(summed(True), want, atol=1e-3)
    assert TransformerLayer.partition_specs()["qkv"]["kernel"] == (None, QKV)


@pytest.mark.parametrize("case", ["sparse", "onebit", "sparse_gradients",
                                  "moe_pipe", "offload", "overlap"])
def test_what_tp_does_not_compose_raises_naming_its_item(case):
    """What the model axis does not compose with raises naming its item
    (MoE under a pipeline, absent from the JAX package: A21;
    ``overlap_comm: true`` above one model rank gets the JAX engine's
    message, and ``"auto"`` takes the fused exchange there), none
    needing a process group.  The sparse core, OneBitAdam and
    ``sparse_gradients`` compose since A18, and offload since A9: they
    build at model 2, offload with the rank's slices in host memory
    (their parity is tests/test_torch_tp_sparse.py,
    tests/test_torch_tp_onebit.py and tests/test_torch_offload_dp.py)."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
        FixedSparsityConfig

    if case == "sparse":
        layer = TransformerLayer(64, 4, attn_impl="sparse",
                                 sparsity_config=FixedSparsityConfig(
                                     num_heads=4, block=16))
        part = params_from_numpy(tp_slice(
            layer.init(0), TransformerLayer.partition_specs(),
            {MODEL: 0, EXPERT: 0}, {MODEL: 2}), "cpu")
        with current_mesh(Mesh({"model": 2})):
            ctx = layer.attention_core(part, torch.zeros(1, 32, 64))
        assert ctx.shape == (1, 32, 32)
        return
    if case == "moe_pipe":
        from deepspeed_tpu_torch import initialize

        module, _ = W.pipe_module()
        with pytest.raises(NotImplementedError, match="A21"):
            initialize(model=module, model_parameters=W.pipe_params(),
                       config=W.pipe_config(),
                       mesh=Mesh({"pipe": 2, "expert": 2}), device="cpu")
        return
    extra = {"onebit": {"optimizer": {"type": "OneBitAdam",
                                      "params": {"lr": 1e-3}},
                        "zero_optimization": {"stage": 0}},
             "sparse_gradients": {"sparse_gradients": True,
                                  "zero_optimization": {"stage": 0}},
             "offload": {"zero_optimization": {"stage": 2,
                                               "cpu_offload": True}},
             "overlap": {"zero_optimization": {"stage": 2,
                                               "overlap_comm": True}}}[case]
    model, params = W.gpt2()
    if case == "overlap":
        with pytest.raises(ValueError,
                           match="requires a pure data-parallel mesh"):
            W.engine(model, params, dict(W.config(W.ADAM, dp=2), **extra),
                     Mesh({"data": 2, "model": 2}))
        return
    if case == "offload":
        eng = W.engine(model, params, dict(W.config(W.ADAM), **extra),
                       Mesh({"model": 2}))
        whole = W.engine(model, params, dict(W.config(W.ADAM), **extra))
        assert eng.mp_world_size == 2 and eng.master.device.type == "cpu"
        assert tuple(eng.master.shape) == eng.flat.shard_shape
        assert sum(eng.segments.sizes) < sum(whole.segments.sizes)
        return
    eng = W.engine(model, params, dict(W.config(W.ADAM, clip=0.0), **extra),
                   Mesh({"model": 2}))
    assert eng.mp_world_size == 2
    if case == "onebit":
        assert type(eng.optimizer).__name__ == "OnebitAdam"
        assert eng._onebit_scale_axes() == ("model",)
    else:
        assert eng.sparse_gradients_enabled()


def test_regions_hand_nccl_a_contiguous_buffer():
    """An einsum's strided output through ``reduce_from`` / ``psum``
    comes back contiguous with its values (NCCL refuses a strided
    buffer; gloo took it, so the four-card MoE run found it)."""
    from deepspeed_tpu_torch import comm

    x = torch.arange(24.0).view(2, 3, 4).permute(2, 0, 1)
    assert not x.is_contiguous()
    y = comm.psum(x, "model", Mesh({"model": 1}))
    assert y.is_contiguous() and torch.equal(y, x)
