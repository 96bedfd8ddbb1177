"""The port's sparse attention modules against the JAX package's on the
same numpy inputs: ``SparseSelfAttention`` (mask modes, the layout cache,
its errors) and ``BertSparseSelfAttention`` with the weights carried
across at 2e-5 (fp32, the same operations), and ``SparseAttentionUtils``
(equal outputs: padding and tiling move values, they compute nothing)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.utils.params import params_from_numpy, \
    params_to_numpy

TOL = 2e-5


def test_the_subpackage_exports_what_the_jax_one_does():
    theirs = {n for n in vars(jsa) if not n.startswith("_")
              and not isinstance(getattr(jsa, n), types.ModuleType)}
    ours = {n for n in vars(tsa) if not n.startswith("_")
            and not isinstance(getattr(tsa, n), types.ModuleType)}
    assert theirs <= ours, theirs - ours


def qkv(seed, b=2, h=4, s=64, d=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(3)]


def pair(**kw):
    attention = kw.pop("attention", "bidirectional")
    return (jsa.SparseSelfAttention(jsa.FixedSparsityConfig(
                num_heads=4, block=16, num_local_blocks=2,
                attention=attention), max_seq_length=128, **kw),
            tsa.SparseSelfAttention(tsa.FixedSparsityConfig(
                num_heads=4, block=16, num_local_blocks=2,
                attention=attention), max_seq_length=128, **kw))


@pytest.mark.parametrize("kpm_mode,attn_mode,attention", [
    ("add", "mul", "bidirectional"), ("mul", "add", "bidirectional"),
    ("mul", "mul", "unidirectional"), ("add", "add", "unidirectional")])
def test_sparse_self_attention_mask_modes(kpm_mode, attn_mode, attention):
    jmod, tmod = pair(key_padding_mask_mode=kpm_mode,
                      attn_mask_mode=attn_mode, attention=attention)
    q, k, v = qkv(0)
    rng = np.random.RandomState(1)
    keep = np.ones((2, 64), np.float32)
    keep[1, 40:] = 0.0
    kpm = keep if kpm_mode == "mul" else (1.0 - keep) * np.float32(-1e9)
    allow = (rng.rand(64, 64) < 0.9).astype(np.float32)
    am = allow if attn_mode == "mul" else (1.0 - allow) * np.float32(-1e9)
    rpe = rng.randn(4, 64, 64).astype(np.float32)
    want = np.asarray(jmod(*(jnp.asarray(x) for x in (q, k, v)),
                           rpe=jnp.asarray(rpe),
                           key_padding_mask=jnp.asarray(kpm),
                           attn_mask=jnp.asarray(am)))
    got = tmod(*(torch.from_numpy(x) for x in (q, k, v)),
               rpe=torch.from_numpy(rpe),
               key_padding_mask=torch.from_numpy(kpm),
               attn_mask=torch.from_numpy(am[None, None])).numpy()
    assert got.shape == (2, 4, 64, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_sparse_self_attention_layout_cache_and_errors():
    jmod, tmod = pair()
    for s in (32, 64, 128):
        layout = tmod.get_layout(s)
        np.testing.assert_array_equal(layout, jmod.get_layout(s))
        assert tmod.get_layout(s) is layout          # cached per length
        assert layout.shape == (4, s // 16, s // 16)
    with pytest.raises(ValueError, match="multiple of block"):
        tmod.get_layout(40)
    with pytest.raises(ValueError, match="exceeds max_seq_length"):
        tmod.get_layout(256)
    q, k, v = (torch.from_numpy(x) for x in qkv(2))
    with pytest.raises(NotImplementedError, match="self-attention"):
        tmod(q, k[:, :, :32], v)
    for bad in (dict(key_padding_mask_mode="or"), dict(attn_mask_mode="x")):
        with pytest.raises(ValueError):
            tsa.SparseSelfAttention(**bad)
    default = tsa.SparseSelfAttention()
    assert isinstance(default.sparsity_config, tsa.FixedSparsityConfig)
    assert default.sparsity_config.num_heads == 4
    assert default.forward.__func__ is tsa.SparseSelfAttention.__call__


@pytest.mark.parametrize("masked", [False, True])
def test_bert_sparse_self_attention_with_weights_carried_across(masked):
    config = types.SimpleNamespace(hidden_size=64, num_attention_heads=4,
                                   initializer_range=0.02)
    tmod = tsa.BertSparseSelfAttention(
        config, tsa.FixedSparsityConfig(num_heads=4, block=16,
                                        num_local_blocks=2))
    jmod = jsa.BertSparseSelfAttention(
        config, jsa.FixedSparsityConfig(num_heads=4, block=16,
                                        num_local_blocks=2))
    params = tmod.init(seed=3)
    assert sorted(params) == ["key", "query", "value"]
    assert params["query"]["kernel"].shape == (64, 64)
    assert float(params["query"]["kernel"].std()) == pytest.approx(0.02,
                                                                   rel=0.1)
    assert not torch.equal(params["query"]["kernel"], params["key"]["kernel"])
    # the weights go across as numpy, and come back bit-exact
    as_numpy = params_to_numpy(params)
    for name in params:
        as_numpy[name]["bias"] = np.random.RandomState(4).randn(64) \
            .astype(np.float32) * 0.1
    params = params_from_numpy(as_numpy, "cpu")
    jparams = {n: {k: jnp.asarray(a) for k, a in p.items()}
               for n, p in as_numpy.items()}
    x = np.random.RandomState(5).randn(2, 64, 64).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((2, 64), np.float32)
        mask[0, 50:] = 0.0
    want = np.asarray(jmod.apply(
        jparams, jnp.asarray(x),
        attention_mask=None if mask is None else jnp.asarray(mask)))
    got = tmod.apply(params, torch.from_numpy(x),
                     attention_mask=None if mask is None
                     else torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 64, 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="not a multiple"):
        tsa.BertSparseSelfAttention(types.SimpleNamespace(
            hidden_size=65, num_attention_heads=4))


def test_utils_extend_position_embedding():
    table = np.random.RandomState(6).randn(8, 4).astype(np.float32)
    for max_position in (5, 8, 20):
        want = np.asarray(jsa.SparseAttentionUtils.extend_position_embedding(
            jnp.asarray(table), max_position))
        got = tsa.SparseAttentionUtils.extend_position_embedding(
            torch.from_numpy(table), max_position)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seq", [48, 50])
def test_utils_pad_and_unpad(seq):
    rng = np.random.RandomState(seq)
    ids = rng.randint(1, 99, size=(2, seq))
    mask = np.ones((2, seq), np.int64)
    types_ = rng.randint(0, 2, size=(2, seq))
    pos = np.tile(np.arange(seq), (2, 1))
    embeds = rng.randn(2, seq, 8).astype(np.float32)
    table = rng.randn(100, 8).astype(np.float32)
    want = jsa.SparseAttentionUtils.pad_to_block_size(
        16, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types_),
        jnp.asarray(pos), jnp.asarray(embeds), pad_token_id=7,
        model_embeddings=lambda i: jnp.asarray(table)[i])
    got = tsa.SparseAttentionUtils.pad_to_block_size(
        16, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(types_), torch.from_numpy(pos),
        torch.from_numpy(embeds), pad_token_id=7,
        model_embeddings=lambda i: torch.from_numpy(table)[i.long()])
    assert got[0] == want[0] == (16 - seq % 16) % 16
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    out = torch.zeros(2, seq + got[0], 3)
    assert tsa.SparseAttentionUtils.unpad_sequence_output(
        got[0], out).shape == (2, seq, 3)


def test_utils_tokenizer_and_module_surgery():
    tok = types.SimpleNamespace(model_max_length=512, init_kwargs={})
    out = tsa.SparseAttentionUtils.update_tokenizer_model_max_length(tok, 4096)
    assert out is tok and tok.model_max_length == 4096
    assert tok.init_kwargs["model_max_length"] == 4096
    for mod, name in ((jsa, "deepspeed_tpu.module_inject"),
                      (tsa, "deepspeed_tpu_torch.module_inject")):
        with pytest.raises(NotImplementedError, match=name):
            mod.SparseAttentionUtils \
                .replace_model_self_attention_with_sparse_self_attention(
                    object(), 4096)
