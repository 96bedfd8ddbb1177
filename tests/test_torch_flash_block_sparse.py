"""The port's block-sparse flash attention against the JAX package's.

The host tables (``build_block_luts``, ``build_super_luts``) and
``_pick_q_agg`` are EQUAL, entry for entry.  The plain versions of B5a
and B5b, and of the super-tile kernels B6a, B6b and B6c, which the
wrappers run for CPU tensors, match the Pallas kernels in interpret mode
on the same numpy inputs: out and lse at 2e-5 (the MAX_FLOOR and NEG_INF
rows exactly), the gradients at 5e-4 (fp32: the same operations, another
summation order), over random irregular, BigBird, Fixed-unidirectional and
empty-row layouts, blocks of 16 to 128 rows, causal and not, shared and
per-head layouts.  The autograd functions on the CPU equal autograd
through the gather path, and a call that the JAX package resolves to an
aggregation factor above 1 ("auto" at blocks of up to 128 rows, or an
explicit factor) goes through the super-tile functions."""

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
def one_torch_thread():
    """The plain versions run on one intra-op thread.  torch's CPU exp
    goes through MKL's vector math; when two intra-op threads make a
    process's first such call at once under CPU contention (an xdist
    worker beside five others), the second thread's half of the tensor
    can come out of a reduced-accuracy path, up to 1.5e-4 relative,
    which sends out and lse past the 2e-5 tolerance.  One thread never
    makes that call concurrently.  Set here and restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
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


def test_plain_versions_run_on_one_thread_with_an_exact_exp():
    """Regression for the flake of the plain forward at bigbird_blk16:
    the module runs on one intra-op thread, and torch's exp of the first
    forward's shifted scores is within two ulps of float64 exp (the
    reduced-accuracy path it came out of was up to 1.5e-4 off)."""
    assert torch.get_num_threads() == 1
    layout, s, h = LAYOUTS["bigbird_blk16"]
    q, k, _, _ = (torch.from_numpy(x) for x in inputs(1, 2, s, h))
    visible, _ = tfbs.expand_layout(layout, s, False, torch.device("cpu"))
    sc = tfbs._masked_scores(q, k, visible)
    x = (sc - sc.amax(-1, keepdim=True))[visible.expand_as(sc)]
    np.testing.assert_allclose(torch.exp(x).numpy(),
                               np.exp(x.numpy().astype(np.float64)),
                               rtol=2.0 ** -22, atol=0)


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
# ------------------------------------------------------ super-tile (B6)
def super_layouts():
    """name -> (layout, G): the JAX test's 4x4 example, and layouts at
    G = 2, 3, 4, shared and per-head, one with an empty super-row."""
    example = np.zeros((1, 4, 4), np.int64)
    example[0, 0, [0, 2]] = 1
    example[0, 1, [1]] = 1
    example[0, 2, [2, 3]] = 1
    example[0, 3, [3]] = 1
    rs = np.random.RandomState(7)
    per_head = (rs.rand(3, 12, 12) < 0.3).astype(np.int64)
    per_head[1, 4:8] = 0                     # head 1: super-row 1 empty at G=4
    return {"jax_example_G2": (example, 2),
            "irregular_perhead_G2": (LAYOUTS["irregular_perhead_blk16"][0], 2),
            "irregular_perhead_G4": (LAYOUTS["irregular_perhead_blk16"][0], 4),
            "bigbird_shared_G4": (LAYOUTS["bigbird_blk16"][0], 4),
            "perhead_empty_super_row_G3": (per_head, 3),
            "perhead_empty_super_row_G4": (per_head, 4)}


SUPER = super_layouts()


@pytest.mark.parametrize("name", sorted(SUPER))
def test_super_luts_equal(name):
    layout, G = SUPER[name]
    got = tfbs.build_super_luts(layout, G)
    want = jfbs.build_super_luts(layout, G)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if name == "jax_example_G2":             # bit row_g·G + col_g
        assert got[2][0, 0, :2].tolist() == [0b1001, 0b0001]
    if name == "perhead_empty_super_row_G4":
        assert got[1][1, 1] == 0


def agg_cases():
    """name -> (layout, b, s, h, G).  An empty row inside an active
    super-row (lse MAX_FLOOR) and an empty super-row (NEG_INF) in
    ``perhead_blk32``, whose heads have a layout each."""
    rs = np.random.RandomState(8)
    per_head = (rs.rand(2, 8, 8) < 0.4).astype(np.int64)
    per_head[:, :, 0] = 1
    per_head[0, 5] = 0              # row 5 empty, super-row 1 active
    per_head[1, 4:8] = 0            # head 1: super-row 1 empty
    return {"perhead_blk32_G4": (per_head, 1, 256, 2, 4),
            "bigbird_blk16_G4": (LAYOUTS["bigbird_blk16"][0], 1, 128, 2, 4),
            "triangle_nb6_G3": (np.tril(np.ones((1, 6, 6), np.int64)), 1,
                                192, 2, 3)}


AGG = agg_cases()


def jax_agg_forward(q, k, v, layout, G, causal):
    luts = [jnp.asarray(a) for a in jfbs.build_super_luts(layout, G)]
    out, res = jfbs._fbs_fwd_agg(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), *luts, causal, True, G)
    return np.asarray(out), np.asarray(res[-1])[:, 0]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name", sorted(AGG))
def test_plain_agg_versions_match_the_pallas_agg_kernels(name, causal):
    """``flash_block_sparse_agg_fwd`` and ``_agg_bwd`` on CPU tensors (the
    plain versions of B6a, B6b, B6c) against ``_fwd_kernel_agg`` and
    ``jax.grad`` of ``flash_block_sparse_attention(q_agg=G)``, both in
    interpret mode: out and lse at 2e-5 with the rows that see no pair
    equal exactly (MAX_FLOOR inside an active super-row, NEG_INF in an
    empty one), dq, dk, dv at 5e-4."""
    layout, b, s, h, G = AGG[name]
    q, k, v, w = inputs(9, b, s, h, d=64)
    want_out, want_lse = jax_agg_forward(q, k, v, layout, G, causal)
    want = jax.grad(
        lambda q_, k_, v_: jnp.sum(jfbs.flash_block_sparse_attention(
            q_, k_, v_, layout, causal=causal, interpret=True, q_agg=G)
            * jnp.asarray(w)), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    out, lse = tfbs.flash_block_sparse_agg_fwd(tq, tk, tv, layout, G, causal)
    np.testing.assert_allclose(out.numpy(), want_out, atol=OUT_TOL,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=OUT_TOL,
                               rtol=OUT_TOL)
    for special in (tfbs.MAX_FLOOR, tfbs.NEG_INF):
        np.testing.assert_array_equal(lse.numpy() == special,
                                      want_lse == special)
    got = tfbs.flash_block_sparse_agg_bwd(tq, tk, tv, out, lse, tw, layout,
                                          G, causal)
    for g, j, nm in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=nm)
    if name == "perhead_blk32_G4":
        lse_h = lse.numpy().reshape(b, h, s)
        assert (lse_h[:, 0, 160:192] == tfbs.MAX_FLOOR).all()
        assert (lse_h[:, 1, 128:] == tfbs.NEG_INF).all()
        assert not out.numpy()[:, 160:192, 0].any()
        assert not got[0].numpy()[:, 128:, 1].any()     # zero dq


@pytest.mark.parametrize("blk,nb,q_agg,G", [
    (16, 8, "auto", 4), (16, 8, None, 4), (16, 8, 2, 2),
    (128, 4, "auto", 4), (256, 4, 2, 2), (16, 8, "never", 1),
    (16, 8, 1, 1), (16, 1, "auto", 1), (256, 4, "auto", 1),
    (512, 2, None, 1)])
def test_aggregation_above_one_raises_naming_the_roadmap_item(
        monkeypatch, blk, nb, q_agg, G):
    """(The name is the one this test had while the super-tile kernels
    were not ported and ``G > 1`` raised.)  The entry point resolves G as
    the JAX one does: ``G > 1`` goes
    through the super-tile functions (the plain version of B6a here) and
    ``G == 1`` through B5's; either way the result and the gradients
    equal the gather path's."""
    assert jfbs._pick_q_agg(blk, nb, q_agg) == G
    calls = []
    for name in ("flash_block_sparse_agg_reference",
                 "flash_block_sparse_reference"):
        real = getattr(tfbs, name)
        monkeypatch.setattr(tfbs, name, lambda *a, _n=name, _r=real, **kw:
                            calls.append(_n) or _r(*a, **kw))
    rng = np.random.RandomState(blk + nb)
    qkv = rng.randn(1, blk * nb, 3, 2, 8).astype(np.float32)
    layout = np.tril(np.ones((1, nb, nb), np.int64))
    results = []
    for fn in (lambda *a: tfbs.flash_block_sparse_attention(*a, q_agg=q_agg),
               tbs.block_sparse_attention):
        t = torch.from_numpy(qkv.copy()).requires_grad_()
        out = fn(t[:, :, 0], t[:, :, 1], t[:, :, 2], layout)
        out.square().sum().backward()
        results.append((out.detach().numpy(), t.grad.numpy()))
    assert calls == ["flash_block_sparse_agg_reference" if G > 1
                     else "flash_block_sparse_reference"]
    np.testing.assert_allclose(results[0][0], results[1][0], atol=OUT_TOL,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(results[0][1], results[1][1], atol=GRAD_TOL,
                               rtol=GRAD_TOL)


def test_super_tile_wrappers_check_the_factor():
    q = torch.zeros(1, 96, 2, 64)
    layout = np.ones((1, 6, 6), np.int64)
    for G in (4, 0, 6, 2.0):
        with pytest.raises(ValueError, match="aggregation factor"):
            tfbs.flash_block_sparse_agg_fwd(q, q, q, layout, G)
    out, lse = tfbs.flash_block_sparse_agg_fwd(q, q, q, layout, 3)
    assert out.shape == q.shape and lse.shape == (2, 96)


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
    st = a.super_tables(4)
    assert a.super_tables(4) is st and a.super_tables(2) is not st
    for got, want in zip((st.slut, st.scnt, st.smask, st.stlut, st.stcnt,
                          st.stmask), tfbs.build_super_luts(layout, 4)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------- launch order of bf16 B6b/B6c
def element_tile_counts(layout, G, s, causal):
    """The 64-wide tiles each block of B6b (per 64-row part of a super
    q-row) and of B6c (per 64-key part of a super key column) has to
    visit, counted from the element-level layout: a tile of a super-tile
    counts where one of its pairs is visible (under ``causal`` too).
    Returns ``(dq_tiles, dkv_tiles)``, each ``[H, ns, parts]``."""
    active = np.asarray(layout) != 0
    H, nb = active.shape[:2]
    blk, n = s // nb, G * (s // nb)
    ns, parts = nb // G, -(-n // 64)
    dq, dkv = (np.zeros((H, ns, parts), np.int64) for _ in range(2))
    pos = np.arange(s)
    for h in range(H):
        vis = active[h].repeat(blk, 0).repeat(blk, 1)
        if causal:
            vis &= pos[:, None] >= pos[None, :]
        for sq in range(ns):
            for sk in range(ns):
                sub = np.zeros((64 * parts, 64 * parts), bool)
                sub[:n, :n] = vis[sq * n:(sq + 1) * n, sk * n:(sk + 1) * n]
                tiles = sub.reshape(parts, 64, parts, 64).any(axis=(1, 3))
                dq[h, sq] += tiles.sum(1)
                dkv[h, sk] += tiles.sum(0)
    return dq, dkv


def order_layouts():
    """name -> (layout, G, s, causal): the sparse BERT layout at its
    training length, a random per-head layout with an empty super-row,
    causal and not, and a causal one whose 72-row super-tiles are cut
    into 64 + 8."""
    rs = np.random.RandomState(11)
    per_head = (rs.rand(4, 16, 16) < 0.3).astype(np.int64)
    per_head[:, :, 0] = 1
    per_head[1, 4:8] = 0
    bert = jsc.FixedSparsityConfig(
        num_heads=16, block=128, num_local_blocks=4, num_global_blocks=1,
        attention="bidirectional", different_layout_per_head=True,
        num_different_global_patterns=4).make_layout(4096)
    return {"bert_s4096_G4": (np.asarray(bert), 4, 4096, False),
            "perhead_blk16_G4": (per_head, 4, 256, False),
            "perhead_blk16_G4_causal": (per_head, 4, 256, True),
            "triangle_blk24_G3_causal": (np.tril(np.ones((1, 6, 6),
                                                         np.int64)), 3,
                                         144, True)}


ORDERS = order_layouts()


@pytest.mark.parametrize("name", sorted(ORDERS))
def test_launch_order_is_a_permutation_sorted_by_tiles(name):
    """Each launch order is a permutation of the grid's units, sorted by
    the tiles its block visits (counted here from the element-level
    layout), the most first and ties by unit, and two builds give the
    same order; the device copy is built once per (G, blk, causal)."""
    layout, G, s, causal = ORDERS[name]
    blk = s // layout.shape[1]
    orders = tfbs.build_launch_order(layout, G, blk, causal)
    again = tfbs.build_launch_order(layout.copy(), G, blk, causal)
    for order, tiles, other in zip(orders, element_tile_counts(
            layout, G, s, causal), again):
        flat = tiles.ravel()
        assert order.dtype == np.int32
        np.testing.assert_array_equal(np.sort(order), np.arange(flat.size))
        key = np.stack([-flat[order], order])
        assert (np.diff(key[0]) >= 0).all()
        ties = np.diff(key[0]) == 0
        assert (np.diff(key[1])[ties] > 0).all()
        np.testing.assert_array_equal(order, other)
    luts = tfbs.device_luts(layout, "cpu")
    cached = luts.launch_order(G, blk, causal)
    assert luts.launch_order(G, blk, causal) is cached
    for got, want in zip(cached, orders):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    if name == "bert_s4096_G4":
        dq_tiles, dkv_tiles = element_tile_counts(layout, G, s, causal)
        # every layout row sees 11 of 32 key blocks: even dq blocks; the
        # global key columns are seen by all 32 query blocks, the rest by 4
        assert set(dq_tiles.ravel()) == {22}
        assert sorted(set(dkv_tiles.ravel())) == [8, 64]
        assert dkv_tiles.ravel()[orders[1][:256]].min() == 64


def test_super_tile_visits_match_the_element_level_count():
    """:func:`super_tile_visits` (from the G×G group bits) marks exactly
    the tiles that hold a visible pair, at G = 2..5 and blocks whose
    super-tiles are not a multiple of 64 rows."""
    rs = np.random.RandomState(12)
    for G, nb, s, causal in ((2, 8, 256, True), (3, 6, 144, False),
                             (5, 10, 160, True), (4, 8, 1024, True)):
        layout = (rs.rand(2, nb, nb) < 0.35).astype(np.int64)
        visits = tfbs.super_tile_visits(layout, G, s // nb, causal)
        dq, dkv = element_tile_counts(layout, G, s, causal)
        np.testing.assert_array_equal(visits.sum(axis=(2, 4)), dq)
        np.testing.assert_array_equal(visits.sum(axis=(1, 3)), dkv)


def test_bf16_super_tile_backward_names_the_kernel_on_misaligned_views():
    """The rule the bf16 tensor-core wrappers (B5b, B6a, B6b, B6c) apply
    on the card before a launch: fused-QKV slices and contiguous tensors
    pass, a view off 16-byte alignment or with a head stride that is not
    a multiple of 8 elements raises a ValueError naming the kernel; fp32
    is not held to it."""
    qkv = torch.zeros(2, 64, 3, 2, 64, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.zeros(2, 64, 2, 64, dtype=torch.bfloat16)
    base = torch.zeros(2 * 64 * 2 * 64 + 4, dtype=torch.bfloat16)
    shifted = base[4:].view(2, 64, 2, 64)
    wide = torch.zeros(2, 64, 2, 68, dtype=torch.bfloat16)[..., :64]
    for name, grads in (("B5b", True), ("B6a", False), ("B6b", True),
                        ("B6c", True)):
        extra = (dout,) if grads else ()
        tfbs._mma_views(name, q, k, v, *extra)
        for bad in (shifted, wide):
            with pytest.raises(ValueError, match=f"bf16 {name} kernel"):
                tfbs._mma_views(name, q, k, bad, *extra)
            tfbs._mma_views(name, q.float(), k.float(), bad.float(),
                            *(t.float() for t in extra))
        if grads:
            with pytest.raises(ValueError, match=f"bf16 {name} kernel"):
                tfbs._mma_views(name, q, k, v, shifted)


# ------------------------------------------------- the bf16 B5b at G = 1
def g1_layouts():
    """name -> layout: the Fixed unidirectional layout of the sparse
    GPT-2 run in 256-row blocks, BigBird, and a per-head layout with
    empty block rows."""
    rs = np.random.RandomState(13)
    per_head = (rs.rand(4, 12, 12) < 0.3).astype(np.int64)
    per_head[1, 3] = 0                       # head 1, q block 3 empty
    per_head[:, 5] = 0                       # q block 5 empty everywhere
    return {"fixed_uni_blk256": jsc.FixedSparsityConfig(
                num_heads=16, block=256, num_local_blocks=4,
                num_global_blocks=1, attention="unidirectional")
            .make_layout(4096),
            "bigbird_blk64": jsc.BigBirdSparsityConfig(
                num_heads=2, block=64, num_random_blocks=1,
                num_sliding_window_blocks=3, num_global_blocks=1)
            .make_layout(1024),
            "perhead_empty_rows": per_head}


G1 = g1_layouts()


@pytest.mark.parametrize("name", sorted(G1))
def test_super_luts_at_g1_express_the_block_luts(name):
    """At G = 1 a super-tile is one layout block: ``build_super_luts``
    lists per row the same active blocks as ``build_block_luts`` (and per
    key column the same query blocks), with ``scnt == cnt`` and exactly
    one mask bit (bit 0) on each active entry, 0 past the count."""
    layout = np.asarray(G1[name])
    lut, cnt, tlut, tcnt = tfbs.build_block_luts(layout)
    slut, scnt, smask, stlut, stcnt, stmask = tfbs.build_super_luts(layout, 1)
    for a, b in ((scnt, cnt), (stcnt, tcnt)):
        np.testing.assert_array_equal(a, b)
    for table, count, mask, want in ((slut, scnt, smask, lut),
                                     (stlut, stcnt, stmask, tlut)):
        valid = np.arange(table.shape[-1]) < count[..., None]
        np.testing.assert_array_equal(np.where(valid, table, -1),
                                      np.where(valid, want[..., :table.shape[
                                          -1]], -1))
        np.testing.assert_array_equal(mask, valid.astype(np.int32))
    if name == "perhead_empty_rows":
        assert scnt[1, 3] == 0 and (scnt[:, 5] == 0).all()


G1_CASES = [("irregular_perhead_blk16", False), ("irregular_perhead_blk16",
                                                 True),
            ("empty_row_blk32", False), ("empty_row_blk32", True),
            ("fixed_uni_blk128", True), ("upper_triangle_blk32", True)]


@pytest.mark.parametrize("name,causal", G1_CASES)
def test_agg_plain_versions_at_g1_equal_b5s_and_the_pallas_kernels(name,
                                                                   causal):
    """The bf16 B5b runs the super-tile kernels at G = 1, so the
    super-tile plain versions at G = 1 must be B5's function: out, lse
    (NEG_INF for a block row with no active block, MAX_FLOOR for a row
    the causal mask empties) and dq, dk, dv EQUAL to the plain B5a and
    B5b, and within 2e-5 / 5e-4 of the Pallas ``_fbs_fwd`` and
    ``jax.grad`` of the work-list kernels in interpret mode."""
    layout, s, h = LAYOUTS[name]
    q, k, v, w = inputs(14, 2, s, h)
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    out, lse = tfbs.flash_block_sparse_agg_reference(tq, tk, tv, layout, 1,
                                                     causal)
    b5_out, b5_lse = tfbs.flash_block_sparse_reference(tq, tk, tv, layout,
                                                       causal)
    assert torch.equal(out, b5_out) and torch.equal(lse, b5_lse)
    want_out, want_lse = jax_forward(q, k, v, layout, causal)
    np.testing.assert_allclose(out.numpy(), want_out, atol=OUT_TOL,
                               rtol=OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=OUT_TOL,
                               rtol=OUT_TOL)
    for special in (tfbs.MAX_FLOOR, tfbs.NEG_INF):
        np.testing.assert_array_equal(lse.numpy() == special,
                                      want_lse == special)
    got = tfbs.flash_block_sparse_agg_bwd_reference(tq, tk, tv, out, lse, tw,
                                                    layout, 1, causal)
    b5 = tfbs.flash_block_sparse_bwd_reference(tq, tk, tv, out, lse, tw,
                                               layout, causal)
    want = jax.grad(
        lambda q_, k_, v_: jnp.sum(jfbs.flash_block_sparse_attention(
            q_, k_, v_, layout, causal=causal, interpret=True,
            q_agg="never") * jnp.asarray(w)), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r, j, nm in zip(got, b5, want, ("dq", "dk", "dv")):
        assert torch.equal(g, r), nm
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=nm)
    if name == "empty_row_blk32":
        assert (lse.numpy()[:, 32:64] == tfbs.NEG_INF).all()
        assert not got[0].numpy()[:, 32:64].any()


def test_launch_order_at_g1_puts_the_global_key_columns_first():
    """The bf16 B5b's launch order (G = 1) at the sparse GPT-2 layout
    shrunk to s=1024 in 256-row blocks (two local blocks a window, one
    global): each order is a permutation of the H·nb·parts units, and
    the dk/dv kernel starts with every 64-key part of each head's global
    key column, the one the most query blocks see."""
    layout = np.asarray(jsc.FixedSparsityConfig(
        num_heads=16, block=256, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional").make_layout(1024))
    H, nb = layout.shape[:2]
    parts = 256 // 64
    dq_order, dkv_order = tfbs.build_launch_order(layout, 1, 256, True)
    for order in (dq_order, dkv_order):
        assert order.dtype == np.int32
        np.testing.assert_array_equal(np.sort(order),
                                      np.arange(H * nb * parts))
    seen = layout.sum(axis=1)                # [H, nb]: query blocks a column
    glob = seen.argmax(axis=1)
    assert (seen.max(axis=1) > seen.min(axis=1)).all()
    first = dkv_order[:H * parts]
    heads, cols = first // (nb * parts), first // parts % nb
    np.testing.assert_array_equal(np.sort(heads), np.repeat(np.arange(H),
                                                            parts))
    np.testing.assert_array_equal(cols, glob[heads])
    # the order counts the same tiles as the element-level layout
    dq_tiles, dkv_tiles = element_tile_counts(layout, 1, 1024, True)
    assert dkv_tiles.ravel()[dkv_order[0]] == dkv_tiles.max()
    assert dq_tiles.ravel()[dq_order[0]] == dq_tiles.max()
