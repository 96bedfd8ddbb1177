"""The port's GPT-2 and weight plumbing against the JAX package's: params
carried across bit-exactly, logits on the same weights at fp32 1e-5
(the tiny model of ``tests/unit/test_inference.py``), and the GPT-2
injection/cast surgery."""

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
from deepspeed_tpu_torch.module_inject import replace_module as trm
from deepspeed_tpu_torch.utils.params import params_from_numpy, \
    params_to_numpy

# the package re-exports a function named replace_module over the module
jrm = importlib.import_module("deepspeed_tpu.module_inject.replace_module")

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
