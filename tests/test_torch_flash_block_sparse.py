"""The port's block-sparse flash attention against the JAX package's.

The host tables (``build_block_luts``) and ``_pick_q_agg`` are EQUAL, entry
for entry.  The
plain versions of B5a and B5b, which the wrappers run for CPU tensors,
match the Pallas kernels in interpret mode on the same numpy inputs: out
and lse at 2e-5, the gradients at 5e-4 (fp32: the same operations, another
summation order), over random irregular, BigBird, Fixed-unidirectional and
empty-row layouts, blocks of 16 to 128 rows, causal and not, shared and
per-head layouts.  The autograd function on the CPU equals autograd
through the gather path, and a call that the JAX package resolves to an
aggregation factor above 1 ("auto" at blocks of up to 128 rows, or an
explicit factor) raises, naming the roadmap item of the kernels that are
still to be ported."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import flash_block_sparse as jfbs
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as tbs
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_block_sparse as tfbs

OUT_TOL, GRAD_TOL = 2e-5, 5e-4


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_layouts():
    """name -> (layout, seq, heads)."""
    random.seed(3)
    rs = np.random.RandomState(3)
    irregular = (rs.rand(4, 8, 8) < 0.3).astype(np.int64)
    irregular[0, 0] = 1                      # one dense row
    irregular[2, 5] = 0                      # one empty row
    empty = np.zeros((1, 4, 4), np.int64)
    empty[0, 0, 0] = empty[0, 2, 1] = empty[0, 3, 3] = 1   # row 1 empty
    upper = np.triu(np.ones((1, 4, 4), np.int64))   # causal empties tiles
    return {
        "irregular_perhead_blk16": (irregular, 128, 4),
        "irregular_perhead_blk32": (irregular, 256, 4),
        "bigbird_blk16": (jsc.BigBirdSparsityConfig(
            num_heads=2, block=16, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1)
            .make_layout(128)[:1], 128, 2),
        "bigbird_perhead_blk64": (jsc.BigBirdSparsityConfig(
            num_heads=2, block=64, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1,
            different_layout_per_head=True).make_layout(512), 512, 2),
        "fixed_uni_blk128": (jsc.FixedSparsityConfig(
            num_heads=2, block=128, num_local_blocks=2, num_global_blocks=1,
            attention="unidirectional").make_layout(512)[:1], 512, 2),
        "empty_row_blk32": (empty, 128, 2),
        "upper_triangle_blk32": (upper, 128, 2),
    }


LAYOUTS = make_layouts()
NAMES = sorted(LAYOUTS)


# ------------------------------------------------------------ host tables
@pytest.mark.parametrize("name", NAMES)
def test_block_luts_equal(name):
    layout = LAYOUTS[name][0]
    for a, b in zip(tfbs.build_block_luts(layout),
                    jfbs.build_block_luts(layout)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("blk,nb,q_agg", [
    (16, 64, "auto"), (64, 32, "auto"), (128, 6, "auto"), (256, 8, "auto"),
    (512, 8, None), (16, 8, "never"), (128, 8, 2), (128, 9, 2), (64, 12, 8),
    (256, 4, 4), (32, 3, "3"), (16, 1, 4), (128, 32, "auto"),
    (128, 1, "auto"), (128, 7, None), (256, 16, "auto"), (384, 4, "auto"),
    (512, 32, "auto"), (64, 8, "never"), (256, 16, 2), (16, 128, None)])
def test_pick_q_agg_equal(blk, nb, q_agg):
    assert tfbs._pick_q_agg(blk, nb, q_agg) == \
        jfbs._pick_q_agg(blk, nb, q_agg)


# --------------------------------------------------------- plain versions
def inputs(seed, b, s, h, d=32):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(4)]


def jax_forward(q, k, v, layout, causal):
    jq, jk, fl = jfbs.build_work_luts(layout)
    out, res = jfbs._fbs_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(jq),
        jnp.asarray(jk), jnp.asarray(fl), int(layout.shape[1]), causal, True)
    return np.asarray(out), np.asarray(res[-1])[:, 0]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_forward_matches_the_pallas_kernel(name, causal):
    """out AND lse, the empty rows' NEG_INF and the causally emptied
    rows' MAX_FLOOR included (both compare equal at rtol 2e-5)."""
    layout, s, h = LAYOUTS[name]
    q, k, v, _ = inputs(1, 2, s, h)
    want_out, want_lse = jax_forward(q, k, v, layout, causal)
    out, lse = tfbs.flash_block_sparse_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), layout, causal)
    np.testing.assert_allclose(out.numpy(), want_out, atol=OUT_TOL,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=OUT_TOL,
                               rtol=OUT_TOL)
    assert np.isfinite(out.numpy()).all()
    if name == "empty_row_blk32":
        assert not out.numpy()[:, 32:64].any()          # exactly zero
        assert (lse.numpy()[:, 32:64] == tfbs.NEG_INF).all()
    if name == "upper_triangle_blk32" and causal:
        # rows 32.. see only the diagonal tile; nothing above it adds
        assert (lse.numpy() > tfbs.MAX_FLOOR).all()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_backward_matches_jax_grad_of_the_pallas_kernels(name, causal):
    layout, s, h = LAYOUTS[name]
    q, k, v, w = inputs(2, 2, s, h)
    want = jax.grad(
        lambda q_, k_, v_: jnp.sum(jfbs.flash_block_sparse_attention(
            q_, k_, v_, layout, causal=causal, interpret=True,
            q_agg="never") * jnp.asarray(w)), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = tfbs.flash_block_sparse_fwd(tq, tk, tv, layout, causal)
    got = tfbs.flash_block_sparse_bwd(tq, tk, tv, out, lse,
                                      torch.from_numpy(w), layout, causal)
    for g, j, nm in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=nm)
    if name == "empty_row_blk32":
        assert not got[0].numpy()[:, 32:64].any()       # zero dq


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name", ["irregular_perhead_blk16",
                                  "fixed_uni_blk128", "empty_row_blk32"])
def test_autograd_function_equals_the_gather_path(name, causal):
    """``flash_block_sparse_attention`` on CPU tensors (the plain
    versions under ``FlashBlockSparse``), on strided views of one fused
    QKV tensor, against autograd through ``block_sparse_attention``."""
    layout, s, h = LAYOUTS[name]
    rng = np.random.RandomState(4)
    qkv = rng.randn(2, s, 3, h, 32).astype(np.float32)
    w = torch.from_numpy(rng.randn(2, s, h, 32).astype(np.float32))
    results = []
    for fn in (functools.partial(tfbs.flash_block_sparse_attention,
                                 q_agg="never"),
               tbs.block_sparse_attention):
        t = torch.from_numpy(qkv.copy()).requires_grad_()
        out = fn(t[:, :, 0], t[:, :, 1], t[:, :, 2], layout, causal=causal)
        (out * w).sum().backward()
        results.append((out.detach().numpy(), t.grad.numpy()))
    np.testing.assert_allclose(results[0][0], results[1][0], atol=OUT_TOL,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(results[0][1], results[1][1], atol=GRAD_TOL,
                               rtol=GRAD_TOL)


def test_bf16_plain_versions_round_where_the_kernels_do():
    """In bf16 the plain forward stays within bf16 rounding (2e-2) of the
    fp32 one, and the backward within 1e-2 relative to the gradient's
    scale: P and dS are rounded to bf16 before their products, nothing
    else."""
    layout, s, h = LAYOUTS["bigbird_blk16"]
    q, k, v, w = (torch.from_numpy(x) for x in inputs(5, 1, s, h))
    out32, lse32 = tfbs.flash_block_sparse_reference(q, k, v, layout, True)
    qb, kb, vb, wb = (x.bfloat16() for x in (q, k, v, w))
    out16, lse16 = tfbs.flash_block_sparse_reference(qb, kb, vb, layout, True)
    assert out16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    assert float((out16.float() - out32).abs().max()) < 5e-2
    g16 = tfbs.flash_block_sparse_bwd_reference(qb, kb, vb, out16, lse16, wb,
                                                layout, True)
    g32 = tfbs.flash_block_sparse_bwd_reference(q, k, v, out32, lse32, w,
                                                layout, True)
    for a, b in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        assert float((a.float() - b).abs().max()) < 0.1 * float(b.abs().max())


# ---------------------------------------------------------------- checks
@pytest.mark.parametrize("blk,nb,q_agg,runs", [
    (16, 8, "auto", False), (16, 8, None, False), (16, 8, 2, False),
    (128, 4, "auto", False), (256, 4, 2, False), (16, 8, "never", True),
    (16, 8, 1, True), (16, 1, "auto", True), (256, 4, "auto", True),
    (512, 2, None, True)])
def test_aggregation_above_one_raises_naming_the_roadmap_item(blk, nb, q_agg,
                                                              runs):
    """The entry point runs where the JAX one runs its work-list kernels
    (G == 1) and raises where it runs the super-tile kernels (G > 1)."""
    assert (jfbs._pick_q_agg(blk, nb, q_agg) == 1) == runs
    q = torch.zeros(1, blk * nb, 2, 8)
    layout = np.tril(np.ones((1, nb, nb), np.int64))
    if runs:
        out = tfbs.flash_block_sparse_attention(q, q, q, layout, q_agg=q_agg)
        assert out.shape == q.shape
    else:
        with pytest.raises(NotImplementedError, match="B6"):
            tfbs.flash_block_sparse_attention(q, q, q, layout, q_agg=q_agg)


def test_entry_point_checks_shapes_like_the_jax_one():
    q = torch.zeros(1, 64, 2, 32)
    with pytest.raises(ValueError, match="not divisible"):
        tfbs.flash_block_sparse_attention(q, q, q, np.ones((1, 5, 5)))
    with pytest.raises(ValueError, match="layout heads"):
        tfbs.flash_block_sparse_attention(q, q, q, np.ones((3, 4, 4)))
    with pytest.raises(ValueError, match="self-attention"):
        tfbs.flash_block_sparse_attention(q, q[:, :32], q, np.ones((1, 4, 4)))
    with pytest.raises(ValueError, match="dtypes"):
        tfbs.flash_block_sparse_attention(q, q.bfloat16(), q,
                                          np.ones((1, 4, 4)))


def test_device_luts_are_built_once_per_layout_and_device(monkeypatch):
    """The kernels' tables are cached on the layout array's identity, so
    a step copies nothing to the device; a new array is a new entry, and
    an entry goes when its array does."""
    calls = []
    real = tfbs.build_block_luts
    monkeypatch.setattr(tfbs, "build_block_luts",
                        lambda lay: calls.append(1) or real(lay))
    layout = LAYOUTS["bigbird_blk16"][0].copy()
    a = tfbs.device_luts(layout, "cpu")
    assert tfbs.device_luts(layout, torch.device("cpu")) is a
    assert len(calls) == 1
    assert (a.layout_heads, a.nb, a.kmax, a.qmax) == (
        1, 8, int(layout.sum(-1).max()), int(layout.sum(-2).max()))
    for got, want in zip((a.lut, a.cnt, a.tlut, a.tcnt), real(layout)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    other = layout.copy()
    assert tfbs.device_luts(other, "cpu") is not a and len(calls) == 2
    key = id(other)
    assert key in tfbs._lut_cache
    del other
    assert key not in tfbs._lut_cache
    tfbs.device_luts(layout.tolist(), "cpu")     # not cacheable: rebuilt
    assert len(calls) == 3
