"""The port's gather path (``block_sparse_attention``) against the JAX
package's on the same numpy inputs: out at 2e-5 and the gradients of
sum(out · w) w.r.t. q, k and v at 5e-4 (fp32, the same operations; only
the summation order differs), with the causal mask, a key-padding mask,
an ``attn_mask``, a relative position bias, shared and per-head layouts
and fully masked rows; ``layout_gather_indices`` equal."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import block_sparse as jbs
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as tbs

OUT_TOL, GRAD_TOL = 2e-5, 5e-4


def layouts():
    random.seed(0)
    rs = np.random.RandomState(0)
    per_head = (rs.rand(3, 8, 8) < 0.35).astype(np.int64)
    per_head[1, 2] = 0           # a q block with no active key block
    per_head[:, :, 0] |= per_head.sum(-1) == 0   # others keep one block
    per_head[1, 2] = 0
    return {
        "fixed_shared": jsc.FixedSparsityConfig(
            num_heads=3, block=16, num_local_blocks=2).make_layout(128)[:1],
        "fixed_uni": jsc.FixedSparsityConfig(
            num_heads=3, block=16, num_local_blocks=2,
            attention="unidirectional").make_layout(128),
        "bigbird": jsc.BigBirdSparsityConfig(
            num_heads=3, block=16, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1,
            different_layout_per_head=True).make_layout(128),
        "per_head_empty_row": per_head,
    }


LAYOUTS = layouts()


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_gather_indices_equal(name):
    want = jbs.layout_gather_indices(LAYOUTS[name])
    got = tbs.layout_gather_indices(LAYOUTS[name])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def make_inputs(seed, b=2, s=128, h=3, d=16):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


def both(layout, q, k, v, w, causal=False, kpm=None, am=None, rpe=None,
         scale=None):
    """(out, dq, dk, dv) of each package for loss = sum(out · w)."""
    def jloss(q_, k_, v_):
        out = jbs.block_sparse_attention(
            q_, k_, v_, layout, causal=causal,
            key_padding_mask=None if kpm is None else jnp.asarray(kpm),
            attn_mask=None if am is None else jnp.asarray(am),
            rpe=None if rpe is None else jnp.asarray(rpe), scale=scale)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tbs.block_sparse_attention(
        tq, tk, tv, layout, causal=causal,
        key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
        attn_mask=None if am is None else torch.from_numpy(am),
        rpe=None if rpe is None else torch.from_numpy(rpe), scale=scale)
    (out * torch.from_numpy(w)).sum().backward()
    theirs = [np.asarray(jout)] + [np.asarray(g) for g in jg]
    ours = [out.detach().numpy()] + [t.grad.numpy() for t in (tq, tk, tv)]
    return ours, theirs


def assert_match(ours, theirs):
    np.testing.assert_allclose(ours[0], theirs[0], atol=OUT_TOL, rtol=OUT_TOL)
    for a, b, name in zip(ours[1:], theirs[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_gather_path_matches_jax(name, causal):
    layout = LAYOUTS[name]
    ours, theirs = both(layout, *make_inputs(1), causal=causal)
    assert_match(ours, theirs)
    if name == "per_head_empty_row":
        # head 1, q block 2 (rows 32..47) attends nothing: exactly zero
        assert not ours[0][:, 32:48, 1].any()
        assert not ours[1][:, 32:48, 1].any()


@pytest.mark.parametrize("extra", ["key_padding", "attn_mask", "rpe",
                                   "all_and_scale"])
def test_gather_path_masks_match_jax(extra):
    rng = np.random.RandomState(5)
    b, s, h = 2, 128, 3
    kpm = am = rpe = scale = None
    if extra in ("key_padding", "all_and_scale"):
        keep = np.ones((b, s), np.float32)
        keep[0, 100:] = 0.0
        keep[1, :] = 0.0          # every key of batch 1 masked: zero rows
        kpm = (1.0 - keep) * np.float32(jbs.NEG_INF)
    if extra in ("attn_mask", "all_and_scale"):
        am = np.where(rng.rand(s, s) < 0.8, 0.0, jbs.NEG_INF) \
            .astype(np.float32)
    if extra in ("rpe", "all_and_scale"):
        rpe = rng.randn(h, s, s).astype(np.float32)
    if extra == "all_and_scale":
        scale = 0.3
    ours, theirs = both(LAYOUTS["bigbird"], *make_inputs(2), causal=False,
                        kpm=kpm, am=am, rpe=rpe, scale=scale)
    assert_match(ours, theirs)
    if kpm is not None:
        assert not ours[0][1].any()   # the fully masked batch row


def test_gather_path_rejects_bad_layouts():
    q = torch.zeros(1, 64, 2, 8)
    with pytest.raises(ValueError, match="layout heads"):
        tbs.block_sparse_attention(q, q, q, np.ones((3, 4, 4), np.int64))
    with pytest.raises(ValueError, match="not divisible"):
        tbs.block_sparse_attention(q, q, q, np.ones((1, 5, 5), np.int64))
