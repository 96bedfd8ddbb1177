"""The port's GPT-2 and weight plumbing against the JAX package's: params
carried across bit-exactly, logits on the same weights at fp32 1e-5
(the tiny model of ``tests/unit/test_inference.py``), the GPT-2
injection/cast surgery, and the training loss and gradients with the
dense and the block-sparse attention core."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHeadTPU
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.utils.params import params_from_numpy, \
    params_to_numpy

# both packages re-export a function named replace_module over the module
jrm = importlib.import_module("deepspeed_tpu.module_inject.replace_module")
trm = importlib.import_module(
    "deepspeed_tpu_torch.module_inject.replace_module")

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: intra-op threads gain nothing here and
    would only take cores from the tests running beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def jax_model_and_params():
    model = GPT2LMHeadTPU(JConfig(**TINY))
    return model, np_tree(model.init(jax.random.PRNGKey(0)))


def test_params_round_trip_bit_exact(jax_model_and_params):
    _, params = jax_model_and_params
    tree = dict(params, step=np.arange(5, dtype=np.int32))
    back = params_to_numpy(params_from_numpy(tree, "cpu"))
    for (pa, a), (pb, b) in zip(leaves(tree), leaves(back)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_params_from_numpy_takes_jax_bf16_leaves():
    x = jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(x)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
    casted = params_from_numpy({"w": np.ones(3, np.float32),
                                "i": np.arange(3)}, "cpu", torch.bfloat16)
    assert casted["w"].dtype == torch.bfloat16
    assert casted["i"].dtype == torch.int64


def test_random_params_have_the_jax_tree_shapes(jax_model_and_params):
    _, params = jax_model_and_params
    ours = random_params(GPT2Config(**TINY), seed=0)
    got = [(p, x.shape, x.dtype) for p, x in leaves(ours)]
    want = [(p, x.shape, x.dtype) for p, x in leaves(params)]
    assert got == want


@pytest.mark.parametrize("seq", [1, 7, 33])
def test_logits_match_jax(jax_model_and_params, seq):
    jmodel, params = jax_model_and_params
    ids = np.random.RandomState(seq).randint(0, 256, size=(2, seq))
    want = np.asarray(jmodel.logits(params, jnp.asarray(ids, jnp.int32)))
    model = GPT2LMHead(GPT2Config(**TINY), params_from_numpy(params, "cpu"))
    got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_presets_match_jax():
    for name in ("gpt2_small", "gpt2_medium", "gpt2_large", "gpt2_xl"):
        ours, theirs = getattr(GPT2Config, name)(), getattr(JConfig, name)()
        for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                      "max_position_embeddings", "layer_norm_eps"):
            assert getattr(ours, field) == getattr(theirs, field), (name,
                                                                   field)


def hf_gpt2_tree(params):
    """An HF-layout GPT-2 tree holding ``params``' weights."""
    return {"transformer": {
        "wte": {"embedding": params["wte"]},
        "wpe": {"embedding": params["wpe"]},
        "h": {str(i): jrm.revert_gpt2_layer(params["blocks"][f"layer_{i}"])
              for i in range(len(params["blocks"]))},
        "ln_f": params["ln_f"]}}


def test_ingest_gpt2_model_matches_jax(jax_model_and_params):
    _, params = jax_model_and_params
    hf = np_tree(hf_gpt2_tree(params))
    want = np_tree(jrm.ingest_gpt2_model(hf))
    got = trm.ingest_gpt2_model(hf)
    assert [p for p, _ in leaves(got)] == [p for p, _ in leaves(want)]
    for (_, a), (_, b) in zip(leaves(got), leaves(want)):
        np.testing.assert_array_equal(a, b)
    # torch leaves go through the same surgery
    got_t = trm.ingest_gpt2_model(params_from_numpy(hf, "cpu"))
    for (_, a), (_, b) in zip(leaves(got_t), leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b)
    back = trm.replace_gpt2_transformer_layer(got["blocks"], revert=True)
    assert back.keys() == hf["transformer"]["h"].keys()


def test_cast_weights_matches_jax():
    tree = {"w": np.linspace(-3, 3, 17, dtype=np.float32),
            "ids": np.arange(4, dtype=np.int32)}
    want = np_tree(jrm.cast_weights(tree, jnp.bfloat16))
    got = trm.cast_weights(params_from_numpy(tree, "cpu"), torch.bfloat16)
    assert got["w"].dtype == torch.bfloat16 and got["ids"].dtype == torch.int32
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  want["w"].astype(np.float32))
    np.testing.assert_array_equal(got["ids"].numpy(), want["ids"])
    got_np = trm.cast_weights(tree, np.float16)
    assert got_np["w"].dtype == np.float16 and got_np["ids"].dtype == np.int32


def torch_params(params):
    return {k: (torch_params(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)).requires_grad_())
            for k, v in params.items()}


def grad_leaves(tree, prefix=""):
    for path, t in leaves(tree, prefix):
        yield path, t.grad.numpy()


@pytest.mark.parametrize("labels", [False, True], ids=["shifted", "labels"])
def test_training_loss_and_all_grads_match_jax(jax_model_and_params, labels):
    """``apply(params, batch, train=True)`` with dropout off, fp32: the
    loss at 2e-5 and every gradient at 5e-4 against
    ``jax.value_and_grad`` of ``GPT2LMHeadTPU.apply`` (the flash tests'
    tolerances)."""
    jmodel, params = jax_model_and_params
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 256, size=(2, 24))
    batch = {"input_ids": ids}
    if labels:
        lab = rng.randint(0, 256, size=(2, 24))
        lab[:, :5] = -100
        batch["labels"] = lab
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply(p, jbatch, rng=None, train=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
    tp = torch_params(params)
    model = GPT2LMHead(GPT2Config(**TINY))
    loss = model.apply(tp, {k: torch.from_numpy(v) for k, v in
                            batch.items()}, rng=None, train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=2e-5,
                               rtol=2e-5)
    want = dict(leaves(np_tree(jgrads)))
    got = dict(grad_leaves(tp))
    assert got.keys() == want.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], atol=5e-4, rtol=5e-4,
                                   err_msg=path)


def test_sparse_training_loss_and_all_grads_match_jax():
    """A 2-layer GPT-2 with ``attn_impl="sparse"`` and a Fixed
    unidirectional layout (block 16, seq 64), dropout off, fp32: the loss
    at 2e-5 and every gradient at 5e-4 against ``jax.value_and_grad`` of
    ``GPT2LMHeadTPU.apply``."""
    from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as J
    from deepspeed_tpu_torch.ops.sparse_attention import \
        FixedSparsityConfig as T

    skw = dict(num_heads=4, block=16, num_local_blocks=2,
               num_global_blocks=1, attention="unidirectional")
    jmodel = GPT2LMHeadTPU(JConfig(**dict(TINY, attn_impl="sparse",
                                          sparsity_config=J(**skw))))
    params = np_tree(jmodel.init(jax.random.PRNGKey(1)))
    ids = np.random.RandomState(6).randint(0, 256, size=(2, 64))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply(p, {"input_ids": jnp.asarray(ids, jnp.int32)},
                               rng=None, train=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
    tp = torch_params(params)
    model = GPT2LMHead(GPT2Config(**dict(TINY, attn_impl="sparse",
                                         sparsity_config=T(**skw))))
    loss = model.apply(tp, {"input_ids": torch.from_numpy(ids)}, rng=None,
                       train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=2e-5,
                               rtol=2e-5)
    want = dict(leaves(np_tree(jgrads)))
    got = dict(grad_leaves(tp))
    assert got.keys() == want.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], atol=5e-4, rtol=5e-4,
                                   err_msg=path)
    # sparse and dense attention differ on these inputs
    dense = GPT2LMHead(GPT2Config(**TINY)).apply(
        params_from_numpy(params, "cpu"), {"input_ids": torch.from_numpy(ids)},
        rng=None, train=True)
    assert abs(float(dense) - float(loss.detach())) > 1e-6


def test_4096_positions_size_wpe_and_carry_across():
    """``max_position_embeddings=4096`` sizes ``wpe`` in both packages'
    trees; a JAX tree with the long table drops into the port, and a
    sequence past 1024 tokens reads its rows."""
    kw = dict(TINY, max_position_embeddings=4096, num_layers=1)
    ours = random_params(GPT2Config(**kw), seed=0)
    theirs = np_tree(GPT2LMHeadTPU(JConfig(**kw)).init(jax.random.PRNGKey(0)))
    assert ours["wpe"].shape == theirs["wpe"].shape == (4096, 64)
    assert [(p, x.shape) for p, x in leaves(ours)] == \
        [(p, x.shape) for p, x in leaves(theirs)]
    medium = GPT2Config.gpt2_medium(max_position_embeddings=4096)
    assert (medium.max_position_embeddings, medium.hidden_size,
            medium.num_layers) == (4096, 1024, 24)
    tp = params_from_numpy(theirs, "cpu")
    model = GPT2LMHead(GPT2Config(**kw))
    ids = np.random.RandomState(7).randint(0, 256, size=(1, 1040))
    hidden = model.hidden(tp, torch.from_numpy(ids))
    assert hidden.shape == (1, 1040, 64) and bool(torch.isfinite(hidden).all())
    moved = dict(tp, wpe=tp["wpe"].clone())
    moved["wpe"][1030:] += 1.0
    assert not torch.equal(model.hidden(moved, torch.from_numpy(ids))[:, 1030:],
                           hidden[:, 1030:])


def test_eval_apply_without_labels_returns_logits(jax_model_and_params):
    jmodel, params = jax_model_and_params
    ids = np.random.RandomState(4).randint(0, 256, size=(1, 9))
    want = np.asarray(jmodel.apply(params, {"input_ids": jnp.asarray(ids)},
                                   train=False))
    got = GPT2LMHead(GPT2Config(**TINY)).apply(
        params_from_numpy(params, "cpu"),
        {"input_ids": torch.from_numpy(ids)}, train=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("knob,value,item", [
    pytest.param("moe_experts", 4, None, id="moe_experts-4-None"),
    pytest.param("attn_impl", "ring", None, id="attn_impl-ring-A10")])
def test_unported_knobs_raise_naming_their_roadmap_item(knob, value, item):
    """Both knobs are ported (A10): MoE blocks (A10's expert part) build
    and give a finite training loss with the aux term (their parity with
    the JAX model is ``tests/test_torch_moe.py``); the ring core (A10's
    seq part) builds, and at one seq rank runs FlashAttention's plain
    versions here, so its loss is the dense core's to 1e-6 (its parity
    over seq ranks is ``tests/test_torch_sequence_parallel.py``)."""
    cfg = GPT2Config(**dict(TINY, **{knob: value}))
    assert item is None
    model = GPT2LMHead(cfg)
    params = params_from_numpy(random_params(cfg, seed=1), "cpu")
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 16)))
    loss = model.apply(params, {"input_ids": ids}, train=True)
    assert torch.isfinite(loss)
    if knob == "attn_impl":
        dense = GPT2LMHead(GPT2Config(**TINY)).apply(
            params, {"input_ids": ids}, train=True)
        np.testing.assert_allclose(float(loss), float(dense), rtol=1e-6)
        return
    assert model._last_moe_aux is not None
    assert "moe" in params["blocks"]["layer_1"]


@pytest.mark.parametrize("knob,value", [
    ("remat", True), ("loss_chunk", 8), ("normalize_invertible", True),
    ("gelu_checkpoint", True), ("attn_dropout_checkpoint", True)])
def test_memory_knobs_match_the_model_without_them(knob, value):
    """Each memory knob builds the model, and with dropout on at every
    site its loss and gradients equal the model's without it: bit for
    bit for the recomputed regions (they replay the layer's generator),
    to 1e-6 in the loss and 1e-6 + 1e-5 relative in the gradients for
    ``loss_chunk`` (the chunked head sums in another order)."""
    kw = dict(TINY, embd_dropout=0.1, attn_dropout=0.1, resid_dropout=0.1)
    params = random_params(GPT2Config(**kw), seed=2)
    ids = {"input_ids": torch.from_numpy(
        np.random.RandomState(6).randint(0, 256, size=(2, 32)))}
    runs = []
    for cfg in (GPT2Config(**kw), GPT2Config(**dict(kw, **{knob: value}))):
        tp = params_from_numpy(params, "cpu")
        for _, leaf in leaves(tp):
            leaf.requires_grad_()
        loss = GPT2LMHead(cfg).apply(tp, ids, rng=3, train=True)
        loss.backward()
        runs.append((loss.detach(), [t.grad for _, t in leaves(tp)]))
    if knob == "loss_chunk":
        torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-6,
                                   atol=0)
        for a, b in zip(runs[1][1], runs[0][1]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        return
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_training_dropout_is_seeded_and_active():
    """With dropout on, one seed gives one loss and another seed another;
    eval (train=False) ignores the seed."""
    cfg = GPT2Config(**dict(TINY, embd_dropout=0.1, attn_dropout=0.1,
                            resid_dropout=0.1))
    params = params_from_numpy(random_params(cfg, seed=1), "cpu")
    model = GPT2LMHead(cfg)
    ids = {"input_ids": torch.from_numpy(
        np.random.RandomState(5).randint(0, 256, size=(2, 16)))}
    a, b, c = (float(model.apply(params, ids, rng=r, train=True))
               for r in (7, 7, 8))
    assert a == b and a != c
    e1 = float(model.apply(params, dict(ids, labels=ids["input_ids"]),
                           rng=7, train=False))
    e2 = float(model.apply(params, dict(ids, labels=ids["input_ids"]),
                           rng=None, train=False))
    assert e1 == e2
