"""The port's layer math and dense attention against the JAX package's,
on the same numpy inputs, fp32 at 1e-6 (the same ops in the same
dtype; only the summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import layers as jl
from deepspeed_tpu.ops.transformer import attention as ja
from deepspeed_tpu_torch.models import layers as tl
from deepspeed_tpu_torch.ops.transformer import attention as ta

TOL = 1e-6


def rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def to_j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def to_t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_dense():
    rng = np.random.RandomState(0)
    p = {"kernel": rand(rng, 32, 48, scale=0.1), "bias": rand(rng, 48)}
    x = rand(rng, 2, 5, 32)
    np.testing.assert_allclose(
        tl.dense(to_t(p), torch.from_numpy(x)).numpy(),
        np.asarray(jl.dense(to_j(p), jnp.asarray(x))), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_layer_norm(eps):
    rng = np.random.RandomState(1)
    p = {"scale": rand(rng, 64) + 1.0, "bias": rand(rng, 64)}
    x = rand(rng, 3, 7, 64, scale=3.0) + 0.5
    np.testing.assert_allclose(
        tl.layer_norm(to_t(p), torch.from_numpy(x), eps).numpy(),
        np.asarray(jl.layer_norm(to_j(p), jnp.asarray(x), eps)),
        atol=TOL, rtol=TOL)


def test_layer_norm_bf16_returns_input_dtype():
    rng = np.random.RandomState(2)
    p = {"scale": np.ones(16, np.float32), "bias": np.zeros(16, np.float32)}
    x = torch.from_numpy(rand(rng, 4, 16)).bfloat16()
    y = tl.layer_norm(to_t(p), x, 1e-5)
    assert y.dtype == torch.bfloat16
    ref = np.asarray(jl.layer_norm(
        to_j(p), jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), 1e-5)
        .astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), ref, atol=1e-2, rtol=1e-2)


def test_gelu():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(tl.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.gelu(jnp.asarray(x))),
                               atol=TOL, rtol=TOL)


def test_key_padding_to_additive():
    m = np.array([[1, 1, 0, 1], [0, 0, 1, 1]], np.float32)
    np.testing.assert_array_equal(
        ta.key_padding_to_additive(torch.from_numpy(m)).numpy(),
        np.asarray(ja.key_padding_to_additive(jnp.asarray(m))))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s,kv_len,causal", [(9, 9, False), (9, 9, True),
                                             (1, 12, False)])
def test_reference_attention(s, kv_len, causal, masked):
    rng = np.random.RandomState(s * 10 + kv_len)
    q, k, v = (rand(rng, 2, n, 3, 16) for n in (s, kv_len, kv_len))
    mask = None
    if masked:
        kpm = (rng.rand(2, kv_len) > 0.3).astype(np.float32)
        kpm[:, 0] = 1.0
        mask = np.array(ja.key_padding_to_additive(
            jnp.asarray(kpm)))[:, None, None, :]
    got = ta.reference_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        mask=None if mask is None else torch.from_numpy(mask),
        causal=causal).numpy()
    want = np.asarray(ja.reference_attention(
        *(jnp.asarray(x) for x in (q, k, v)),
        mask=None if mask is None else jnp.asarray(mask), causal=causal))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=1e-5)


def test_dot_product_attention_on_cpu_takes_the_dense_path():
    """CPU tensors with a key-padding mask give the JAX CPU dispatch's
    answer (dense attention over the additive mask)."""
    rng = np.random.RandomState(4)
    q, k, v = (rand(rng, 1, 12, 2, 16) for _ in range(3))
    kpm = np.ones((1, 12), np.float32)
    kpm[0, 9:] = 0.0
    got = ta.dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        key_padding_mask=torch.from_numpy(kpm), causal=True).numpy()
    want = np.asarray(ja.dot_product_attention(
        *(jnp.asarray(x) for x in (q, k, v)),
        key_padding_mask=jnp.asarray(kpm), causal=True))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=1e-5)


def test_dot_product_attention_rejects_dropout_and_two_masks():
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="dropout"):
        ta.dot_product_attention(x, x, x, dropout_rate=0.1)
    with pytest.raises(ValueError, match="not both"):
        ta.dot_product_attention(x, x, x, mask=torch.zeros(1, 1, 1, 4),
                                 key_padding_mask=torch.ones(1, 4))
