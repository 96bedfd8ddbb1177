"""The port's BERT injection policy against the JAX package's.

HF BERT layer params (the HF Flax layout, drawn from a numpy seed, so
no ``transformers`` is needed; the HF-parity test of the JAX package
waits for that package) injected into the fused layer: the same fused
tree as the JAX ``inject_bert_layer``, exact, on numpy and on torch
leaves; the injected post-LN layer's output against the JAX layer on
the JAX-injected tree at 2e-5; the revert round trip exact; the encoder
walker and the generic walker (the JAX tests ``test_revert_roundtrip_exact``,
``test_replace_transformer_layer_walks_encoder`` and
``test_replace_module_generic_walker``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.layers import TransformerLayer as JLayer
from deepspeed_tpu.module_inject import inject_bert_layer as j_inject
from deepspeed_tpu.module_inject import \
    replace_transformer_layer as j_replace
from deepspeed_tpu_torch.models.layers import TransformerLayer
from deepspeed_tpu_torch.module_inject import (inject_bert_layer,
                                               replace_module,
                                               replace_transformer_layer,
                                               revert_bert_layer)
from deepspeed_tpu_torch.utils.params import params_from_numpy, tree_leaves

H, HEADS, INTER = 64, 4, 128


def hf_bert_layer(seed=0):
    """An HF Flax BERT layer's param tree with random leaves."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    def dense(n_in, n_out):
        return {"kernel": w(n_in, n_out), "bias": w(n_out)}

    def ln():
        return {"scale": 1.0 + w(H), "bias": w(H)}

    return {"attention": {"self": {"query": dense(H, H), "key": dense(H, H),
                                   "value": dense(H, H)},
                          "output": {"dense": dense(H, H), "LayerNorm": ln()}},
            "intermediate": {"dense": dense(H, INTER)},
            "output": {"dense": dense(INTER, H), "LayerNorm": ln()}}


def flat(tree):
    return dict(zip(*tree_leaves(tree)))


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_injected_tree_equals_the_jax_one(leaves):
    hf = hf_bert_layer(1)
    want = flat(jax.tree_util.tree_map(np.asarray, j_inject(
        jax.tree_util.tree_map(jnp.asarray, hf))))
    src = hf if leaves == "numpy" else params_from_numpy(hf, "cpu")
    got = flat(inject_bert_layer(src))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        if leaves == "torch":
            assert isinstance(leaf, torch.Tensor)
            leaf = leaf.numpy()
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))


@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
def test_injected_layer_matches_the_jax_layer(pre_ln):
    """The port's layer on the port-injected params against the JAX layer
    on the JAX-injected params, on the same input: 2e-5."""
    hf = hf_bert_layer(2)
    kw = dict(intermediate_size=INTER, attn_dropout_ratio=0.0,
              hidden_dropout_ratio=0.0, pre_layer_norm=pre_ln)
    x = np.random.default_rng(3).normal(size=(2, 16, H)).astype(np.float32)
    want = JLayer(H, HEADS, **kw).apply(
        j_inject(jax.tree_util.tree_map(jnp.asarray, hf)), jnp.asarray(x))
    got = TransformerLayer(H, HEADS, **kw).apply(
        inject_bert_layer(params_from_numpy(hf, "cpu")), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_revert_roundtrip_exact(leaves):
    hf = hf_bert_layer(3)
    src = hf if leaves == "numpy" else params_from_numpy(hf, "cpu")
    back = flat(revert_bert_layer(inject_bert_layer(src), hidden_size=H))
    want = flat(hf)
    assert back.keys() == want.keys()
    for path, leaf in back.items():
        leaf = leaf.numpy() if leaves == "torch" else leaf
        np.testing.assert_array_equal(leaf, want[path], err_msg=str(path))


def test_replace_transformer_layer_walks_encoder():
    hf = hf_bert_layer(4)
    encoder = {"layer": {"0": hf, "1": hf_bert_layer(5)}}
    ours = replace_transformer_layer(encoder)
    assert set(ours) == {"layer_0", "layer_1"}
    assert ours["layer_0"]["qkv"]["kernel"].shape == (H, 3 * H)
    theirs = j_replace(jax.tree_util.tree_map(jnp.asarray, encoder))
    assert set(theirs) == set(ours)
    back = replace_transformer_layer(ours, revert=True, hidden_size=H)
    assert set(back) == {"0", "1"}
    np.testing.assert_array_equal(
        back["0"]["attention"]["self"]["query"]["kernel"],
        hf["attention"]["self"]["query"]["kernel"])
    with pytest.raises(ValueError, match="hidden_size"):
        replace_transformer_layer(ours, revert=True)


def test_replace_module_generic_walker():
    tree = {"a": {"hit": {"x": 1}}, "b": {"x": 2}}
    out = replace_module(tree,
                         policy=lambda sub: {"x": sub["x"] * 10},
                         match=lambda path, sub: path.endswith("hit"))
    assert out == {"a": {"hit": {"x": 10}}, "b": {"x": 2}}
