"""The port's layer math and dense attention against the JAX package's,
on the same numpy inputs, fp32 at 1e-6 (the same ops in the same
dtype; only the summation order differs); ``TransformerLayer`` forward
and every gradient at the flash tests' 2e-5 / 5e-4, with the dense and
the block-sparse attention core; the dropouts by
rate and unbiasedness (torch generators and ``jax.random`` draw
different bits)."""

import math

import jax
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


def test_dot_product_attention_rejects_two_masks():
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="not both"):
        ta.dot_product_attention(x, x, x, mask=torch.zeros(1, 1, 1, 4),
                                 key_padding_mask=torch.ones(1, 4))


def layer_params(rng, h, inter):
    def dense_p(i, o):
        return {"kernel": rand(rng, i, o, scale=0.05),
                "bias": rand(rng, o, scale=0.05)}

    def ln_p():
        return {"scale": rand(rng, h, scale=0.1) + 1.0,
                "bias": rand(rng, h, scale=0.1)}

    return {"qkv": dense_p(h, 3 * h), "attn_out": dense_p(h, h),
            "fc1": dense_p(h, inter), "fc2": dense_p(inter, h),
            "ln_attn": ln_p(), "ln_mlp": ln_p()}


def nested(tree, fn):
    return {k: nested(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def flat_items(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat_items(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


@pytest.mark.parametrize("pre_ln,causal,masked", [
    (True, True, False), (False, False, True), (True, False, True)],
    ids=["gpt_pre_ln_causal", "bert_post_ln_kv_mask", "pre_ln_kv_mask"])
def test_transformer_layer_forward_and_grads_match_jax(pre_ln, causal,
                                                       masked):
    """``TransformerLayer.apply`` (dropout off, fp32) and the grads of
    sum(out * w) w.r.t. x and every param, against ``jax.grad`` of the
    JAX layer: forward 2e-5, grads 5e-4."""
    from deepspeed_tpu.models.layers import TransformerLayer as JLayer
    from deepspeed_tpu_torch.models.layers import TransformerLayer

    h, heads, b, s = 64, 4, 2, 12
    rng = np.random.RandomState(int(pre_ln) + 2 * causal + 4 * masked)
    params = layer_params(rng, h, 4 * h)
    x = rand(rng, b, s, h)
    w = rand(rng, b, s, h)
    kpm = None
    if masked:
        kpm = np.ones((b, s), np.float32)
        kpm[1, 8:] = 0.0
    kw = dict(hidden_size=h, heads=heads, causal=causal,
              attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
              pre_layer_norm=pre_ln, layer_norm_eps=1e-5)
    jlayer = JLayer(**kw)

    def jloss(p, x_):
        out = jlayer.apply(p, x_, key_padding_mask=None if kpm is None
                           else jnp.asarray(kpm))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(nested(params, jnp.asarray),
                                              jnp.asarray(x))
    tp = nested(params, lambda a: torch.from_numpy(a).requires_grad_())
    tx = torch.from_numpy(x).requires_grad_()
    out = TransformerLayer(**kw).apply(
        tp, tx, key_padding_mask=None if kpm is None
        else torch.from_numpy(kpm))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=5e-4,
                               rtol=5e-4)
    want = dict(flat_items(nested(jgp, np.asarray)))
    for path, t in flat_items(tp):
        np.testing.assert_allclose(t.grad.numpy(), want[path], atol=5e-4,
                                   rtol=5e-4, err_msg=path)


def sparse_configs(heads, attention):
    kw = dict(num_heads=heads, block=16, num_local_blocks=2,
              num_global_blocks=1, attention=attention)
    from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as J
    from deepspeed_tpu_torch.ops.sparse_attention import \
        FixedSparsityConfig as T
    return J(**kw), T(**kw)


@pytest.mark.parametrize("attention,causal,masked", [
    ("unidirectional", True, False), ("bidirectional", False, False),
    ("bidirectional", False, True), ("unidirectional", False, True)],
    ids=["gpt_uni", "bert_bi", "bert_bi_kv_mask", "uni_kv_mask"])
def test_sparse_transformer_layer_forward_and_grads_match_jax(attention,
                                                              causal, masked):
    """``attn_impl="sparse"``, dropout off, fp32, with and without a
    key-padding mask (the mask takes the gather path in both packages;
    without it the port's CPU path is the gather path too and the JAX
    layer's, on CPU, as well): forward 2e-5, grads 5e-4."""
    from deepspeed_tpu.models.layers import TransformerLayer as JLayer
    from deepspeed_tpu_torch.models.layers import TransformerLayer

    h, heads, b, s = 64, 4, 2, 64
    rng = np.random.RandomState(11 + 2 * causal + 4 * masked)
    params = layer_params(rng, h, 4 * h)
    x, w = rand(rng, b, s, h), rand(rng, b, s, h)
    kpm = None
    if masked:
        kpm = np.ones((b, s), np.float32)
        kpm[1, 40:] = 0.0
    jcfg, tcfg = sparse_configs(heads, attention)
    kw = dict(hidden_size=h, heads=heads, causal=causal,
              attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
              pre_layer_norm=True, layer_norm_eps=1e-5, attn_impl="sparse")
    jlayer = JLayer(sparsity_config=jcfg, **kw)

    def jloss(p, x_):
        out = jlayer.apply(p, x_, key_padding_mask=None if kpm is None
                           else jnp.asarray(kpm))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(nested(params, jnp.asarray),
                                              jnp.asarray(x))
    tp = nested(params, lambda a: torch.from_numpy(a).requires_grad_())
    tx = torch.from_numpy(x).requires_grad_()
    layer = TransformerLayer(sparsity_config=tcfg, **kw)
    out = layer.apply(tp, tx, key_padding_mask=None if kpm is None
                      else torch.from_numpy(kpm))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=5e-4,
                               rtol=5e-4)
    want = dict(flat_items(nested(jgp, np.asarray)))
    for path, t in flat_items(tp):
        np.testing.assert_allclose(t.grad.numpy(), want[path], atol=5e-4,
                                   rtol=5e-4, err_msg=path)
    assert layer._sparse_layout(s) is layer._sparse_layout(s)
    # the additive [b, 1, 1, s] mask form collapses to the same call
    if masked:
        add = ta.key_padding_to_additive(torch.from_numpy(kpm))
        again = layer.apply(nested(params, torch.from_numpy),
                            torch.from_numpy(x), mask=add[:, None, None, :])
        assert torch.equal(again, out.detach())
        with pytest.raises(ValueError, match="key-padding masks"):
            layer.apply(nested(params, torch.from_numpy), torch.from_numpy(x),
                        mask=torch.zeros(b, 1, s, s))


class _FakeCudaTensor:
    """Shape, dtype and device flags of a tensor, for the dispatch rule
    (there is no card where the tests run)."""

    def __init__(self, head_dim=64, dtype=torch.bfloat16, is_cuda=True):
        self.shape = (2, 128, 4, head_dim)
        self.dtype = dtype
        self.is_cuda = is_cuda


@pytest.mark.parametrize("tensor,kpm,env,want", [
    (_FakeCudaTensor(), False, None, "kernel"),
    (_FakeCudaTensor(128, torch.float32), False, "auto", "kernel"),
    (_FakeCudaTensor(), True, None, "gather"),
    (_FakeCudaTensor(), False, "never", "gather"),
    (_FakeCudaTensor(head_dim=32), False, None, "raises"),
    (_FakeCudaTensor(dtype=torch.float16), False, None, "raises"),
    (_FakeCudaTensor(head_dim=32), False, "never", "gather"),
    (_FakeCudaTensor(head_dim=32), True, None, "gather"),
    (_FakeCudaTensor(is_cuda=False), False, None, "gather")],
    ids=["card", "card_d128_fp32", "key_padding", "env_never", "head_dim_32",
         "fp16", "head_dim_32_env_never", "head_dim_32_key_padding", "cpu"])
def test_sparse_core_dispatch(monkeypatch, caplog, tensor, kpm, env, want):
    """The JAX layer's rule in the port's terms: the gather path takes a
    call with a key-padding mask or on the CPU; any other call is the
    kernels', which launch or raise (a type or head_dim they do not
    take), unless ``DS_SPARSE_FLASH=never`` (read at call time) diverts
    it to the gather path, with one warning."""
    if env is None:
        monkeypatch.delenv("DS_SPARSE_FLASH", raising=False)
    else:
        monkeypatch.setenv("DS_SPARSE_FLASH", env)
    if want == "raises":
        with pytest.raises(NotImplementedError, match="DS_SPARSE_FLASH"):
            tl.sparse_core(tensor, kpm)
        return
    tl._log_gather_once.cache_clear()
    with caplog.at_level("WARNING", logger=tl.logger.name):
        assert tl.sparse_core(tensor, kpm) == want
        assert tl.sparse_core(tensor, kpm) == want
    diverted = env == "never" and not kpm
    assert len(caplog.records) == (1 if diverted else 0)


def test_sparse_layer_needs_a_config_and_ring_still_raises():
    from deepspeed_tpu_torch.models.layers import TransformerLayer

    with pytest.raises(ValueError, match="SparsityConfig"):
        TransformerLayer(64, 4, attn_impl="sparse")
    with pytest.raises(NotImplementedError, match="A10"):
        TransformerLayer(64, 4, attn_impl="ring")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        TransformerLayer(64, 4, attn_impl="flash")


def test_sparse_attention_dropout_is_applied_to_the_context():
    """The sparse cores drop nothing inside, so the layer drops the
    context with the layer's generator, first of its three sites: the
    kept share is the byte-mask rate, kept values are scaled, and the
    draw order (attention, attention output, MLP) is the dense layer's."""
    from deepspeed_tpu_torch.models.layers import TransformerLayer, generator

    _, tcfg = sparse_configs(4, "unidirectional")
    layer = TransformerLayer(64, 4, causal=True, attn_dropout_ratio=0.25,
                             hidden_dropout_ratio=0.0, pre_layer_norm=True,
                             attn_impl="sparse", sparsity_config=tcfg)
    rng = np.random.RandomState(12)
    params = nested(layer_params(rng, 64, 256), torch.from_numpy)
    y = torch.from_numpy(rand(rng, 2, 64, 64))
    plain = layer.attention_core(params, y)
    dropped = layer.attention_core(params, y, attn_rng=generator(1, 0, "cpu"),
                                   deterministic=False)
    kept = dropped != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    np.testing.assert_allclose(dropped[kept].numpy(),
                               (plain[kept] * (256 / 192)).numpy(), rtol=1e-6)
    same = layer.attention_core(params, y, attn_rng=generator(1, 0, "cpu"),
                                deterministic=True)
    assert torch.equal(same, plain)
    # the context's draw is the generator's first
    g = generator(1, 0, "cpu")
    first = torch.randint(0, 256, (2, 64, 4, 16), dtype=torch.uint8,
                          generator=g)
    assert torch.equal(first.reshape(2, 64, 64) >= 64, kept)


@pytest.mark.parametrize("ignored", [0, 7])
def test_cross_entropy_matches_jax(ignored):
    from deepspeed_tpu.models.layers import cross_entropy_with_logits as jce
    from deepspeed_tpu_torch.models.layers import cross_entropy_with_logits

    rng = np.random.RandomState(ignored)
    logits = rand(rng, 2, 9, 33, scale=3.0)
    labels = rng.randint(0, 33, size=(2, 9))
    labels.reshape(-1)[:ignored] = -100
    np.testing.assert_allclose(
        float(cross_entropy_with_logits(torch.from_numpy(logits),
                                        torch.from_numpy(labels))),
        float(jce(jnp.asarray(logits), jnp.asarray(labels))),
        atol=TOL, rtol=TOL)


def test_dropout_rate_and_unbiasedness():
    """``layers.dropout`` keeps round(256(1-rate))/256 of the elements
    within 5 sigma, and its scale makes keep * scale average 1 (the JAX
    byte-mask contract; the bits differ, so the law is what is held);
    deterministic, rate 0 and no generator are the identity."""
    from deepspeed_tpu_torch.models.layers import dropout, generator

    x = torch.ones(256, 1024)
    y = dropout(generator(3, 0, "cpu"), x, 0.1, deterministic=False)
    thresh = round(0.1 * 256)
    p = 1 - thresh / 256
    n = x.numel()
    kept = float((y != 0).double().mean())
    assert abs(kept - p) < 5 * math.sqrt(p * (1 - p) / n)
    assert float(y[y != 0][0]) == pytest.approx(256 / (256 - thresh))
    assert abs(float(y.double().mean()) - 1.0) \
        < 5 * math.sqrt(p * (1 - p) / n) / p
    for args in ((generator(3, 0, "cpu"), x, 0.1, True),
                 (None, x, 0.1, False),
                 (generator(3, 0, "cpu"), x, 0.0, False)):
        assert dropout(*args) is x


def test_generators_are_reproducible_and_independent():
    from deepspeed_tpu_torch.models.layers import generator

    a = torch.rand(8, generator=generator(5, 1, "cpu"))
    b = torch.rand(8, generator=generator(5, 1, "cpu"))
    c = torch.rand(8, generator=generator(5, 2, "cpu"))
    d = torch.rand(8, generator=generator(6, 1, "cpu"))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_attention_dropout_on_cpu_takes_the_flash_function():
    """With dropout on, CPU tensors go through ``FlashAttention`` with
    the Philox mask, so one seed gives the card's dropped entries; a
    fixed generator gives a fixed output, and the mean over the dropped
    softmax stays the undropped one in expectation."""
    from deepspeed_tpu_torch.models.layers import generator

    rng = np.random.RandomState(8)
    q, k, v = (torch.from_numpy(rand(rng, 2, 16, 2, 8)) for _ in range(3))
    outs = [ta.dot_product_attention(q, k, v, causal=True, dropout_rate=0.25,
                                     dropout_rng=generator(1, i % 2, "cpu"),
                                     deterministic=False)
            for i in range(3)]
    assert torch.equal(outs[0], outs[2]) and not torch.equal(outs[0],
                                                             outs[1])
    plain = ta.dot_product_attention(q, k, v, causal=True)
    assert not torch.equal(outs[0], plain)
    same = ta.dot_product_attention(q, k, v, causal=True, dropout_rate=0.25,
                                    dropout_rng=generator(1, 0, "cpu"),
                                    deterministic=True)
    assert torch.equal(same, plain)


def test_reference_attention_dropout_with_an_additive_mask():
    """An additive mask keeps the dense path, dropping probs by
    ``random_keep`` bytes as the JAX CPU path does."""
    from deepspeed_tpu_torch.models.layers import generator

    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rand(rng, 1, 6, 2, 8)) for _ in range(3))
    mask = torch.zeros(1, 1, 1, 6)
    a = ta.dot_product_attention(q, k, v, mask=mask, dropout_rate=0.5,
                                 dropout_rng=generator(2, 0, "cpu"),
                                 deterministic=False)
    b = ta.dot_product_attention(q, k, v, mask=mask)
    assert a.shape == b.shape and not torch.equal(a, b)
