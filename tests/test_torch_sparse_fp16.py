"""fp16 in the port's block-sparse attention against the JAX package, on
the CPU.

The Pallas block-sparse kernels give their output ``q.dtype``, so the
JAX engine trains the sparse core in fp16 under its loss scaler; the
port's B5a/B5b and B6a/B6b/B6c take fp16 too (a template on the 16-bit
type on the card).  Here their plain versions, which the wrappers run for
CPU tensors, are held to the Pallas kernels in interpret mode on the same
fp16 inputs: out and dq, dk, dv to ``FP16_ATOL`` + ``FP16_RTOL``·|want|
(one fp16 ulp at the values' size: P and dS are rounded to fp16 before
their products in both, the sums run in another order), lse (fp32) to
2e-5 with the MAX_FLOOR and NEG_INF rows equal.  A non-finite input
gives non-finite outputs in the slices it reaches, as in the JAX
kernel, so the loss scaler sees the overflow.  Then a tiny sparse GPT-2
trains 10 fp16 steps on both engines with one forced overflow: the same
steps skipped, the same scale trace, losses to rtol 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import flash_block_sparse as jfbs
from deepspeed_tpu_torch.ops.sparse_attention import \
    flash_block_sparse as tfbs

from .test_torch_flash_block_sparse import AGG, LAYOUTS, inputs
from .test_torch_fp16 import (GPT2_TINY, LOSS_RTOL, POISON_STEP,
                              fp16_config, gpt2_batches, poison_jax,
                              poison_port, run)

# one fp16 ulp at |x| < 2 is 2^-10 ≈ 9.8e-4: out and the gradients of
# unit-scale inputs agree to about one ulp of their size
FP16_ATOL, FP16_RTOL = 2e-3, 1e-3
LSE_TOL = 2e-5
FP16_CASES = [("irregular_perhead_blk16", False),
              ("irregular_perhead_blk16", True),
              ("bigbird_perhead_blk64", True),
              ("fixed_uni_blk128", True),
              ("empty_row_blk32", False),
              ("upper_triangle_blk32", True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fp16_inputs(seed, b, s, h, d=32):
    return [x.astype(np.float16) for x in inputs(seed, b, s, h, d)]


def close16(got, want, name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=FP16_ATOL, rtol=FP16_RTOL, err_msg=name)


def jax_grads(q, k, v, w, layout, causal, q_agg):
    """``jax.grad`` of Σ w·attention in fp16 through the Pallas kernels in
    interpret mode (the sum in fp32)."""
    return jax.grad(
        lambda q_, k_, v_: jnp.sum(jfbs.flash_block_sparse_attention(
            q_, k_, v_, layout, causal=causal, interpret=True, q_agg=q_agg)
            .astype(jnp.float32) * jnp.asarray(w, jnp.float32)),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("name,causal", FP16_CASES)
def test_fp16_plain_work_list_versions_match_the_pallas_kernels(name,
                                                               causal):
    """B5a and B5b's plain versions on fp16 CPU tensors against
    ``_fbs_fwd`` and ``jax.grad`` of the work-list kernels in interpret
    mode on the same fp16 inputs: out fp16 within one ulp, lse fp32 at
    2e-5 with its special rows equal, dq, dk, dv fp16 within one ulp."""
    layout, s, h = LAYOUTS[name]
    q, k, v, w = fp16_inputs(21, 2, s, h)
    jq, jk, fl = jfbs.build_work_luts(layout)
    want_out, res = jfbs._fbs_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(jq),
        jnp.asarray(jk), jnp.asarray(fl), int(layout.shape[1]), causal, True)
    want_lse = np.asarray(res[-1])[:, 0]
    assert want_out.dtype == jnp.float16
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    out, lse = tfbs.flash_block_sparse_fwd(tq, tk, tv, layout, causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    close16(out, want_out, "out")
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=LSE_TOL,
                               rtol=LSE_TOL)
    for special in (tfbs.MAX_FLOOR, tfbs.NEG_INF):
        np.testing.assert_array_equal(lse.numpy() == special,
                                      want_lse == special)
    got = tfbs.flash_block_sparse_bwd(tq, tk, tv, out, lse, tw, layout,
                                      causal)
    want = jax_grads(q, k, v, w, layout, causal, "never")
    for g, j, nm in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float16
        close16(g, j, nm)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("name", sorted(AGG))
def test_fp16_plain_agg_versions_match_the_pallas_agg_kernels(name, causal):
    """B6a, B6b and B6c's plain versions on fp16 CPU tensors against
    ``_fwd_kernel_agg`` and ``jax.grad`` of ``q_agg=G`` in interpret mode:
    the same tolerances as the work-list case."""
    layout, b, s, h, G = AGG[name]
    q, k, v, w = fp16_inputs(22, b, s, h, d=64)
    luts = [jnp.asarray(a) for a in jfbs.build_super_luts(layout, G)]
    want_out, res = jfbs._fbs_fwd_agg(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), *luts, causal, True, G)
    want_lse = np.asarray(res[-1])[:, 0]
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    out, lse = tfbs.flash_block_sparse_agg_fwd(tq, tk, tv, layout, G, causal)
    close16(out, want_out, "out")
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=LSE_TOL,
                               rtol=LSE_TOL)
    for special in (tfbs.MAX_FLOOR, tfbs.NEG_INF):
        np.testing.assert_array_equal(lse.numpy() == special,
                                      want_lse == special)
    got = tfbs.flash_block_sparse_agg_bwd(tq, tk, tv, out, lse, tw, layout,
                                          G, causal)
    want = jax_grads(q, k, v, w, layout, causal, G)
    for g, j, nm in zip(got, want, ("dq", "dk", "dv")):
        close16(g, j, nm)


@pytest.mark.parametrize("G", [1, 4])
def test_fp16_non_finite_inputs_reach_the_outputs_as_in_the_jax_kernels(G):
    """An inf in one row of q (batch 0, head 1) and a NaN in one row of dO
    (batch 1, head 0): the (batch, head) slices with a non-finite out or
    gradient are the JAX kernels', and every such slice holds one, so an
    fp16 step that overflows in the sparse core is skipped by the loss
    scaler; the other slices stay finite."""
    layout, s, h = LAYOUTS["irregular_perhead_blk16"]
    q, k, v, w = fp16_inputs(23, 2, s, h, d=64)
    q[0, 3, 1, :] = np.inf
    w[1, 5, 0, :] = np.nan
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    if G == 1:
        out, lse = tfbs.flash_block_sparse_fwd(tq, tk, tv, layout)
        got = tfbs.flash_block_sparse_bwd(tq, tk, tv, out, lse, tw, layout)
        jq, jk, fl = jfbs.build_work_luts(layout)
        want_out, _ = jfbs._fbs_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(jq),
            jnp.asarray(jk), jnp.asarray(fl), int(layout.shape[1]), False,
            True)
        want = jax_grads(q, k, v, w, layout, False, "never")
    else:
        out, lse = tfbs.flash_block_sparse_agg_fwd(tq, tk, tv, layout, G)
        got = tfbs.flash_block_sparse_agg_bwd(tq, tk, tv, out, lse, tw,
                                              layout, G)
        luts = [jnp.asarray(a) for a in jfbs.build_super_luts(layout, G)]
        want_out, _ = jfbs._fbs_fwd_agg(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), *luts, False, True,
                                        G)
        want = jax_grads(q, k, v, w, layout, False, G)

    def bad_slices(x):
        x = np.asarray(x, np.float32)
        return ~np.isfinite(x).all(axis=(1, 3))      # [b, h]

    assert bad_slices(out.float().numpy())[0, 1]
    np.testing.assert_array_equal(bad_slices(out.float().numpy()),
                                  bad_slices(want_out))
    for g, j, nm in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_array_equal(bad_slices(g.float().numpy()),
                                      bad_slices(j), err_msg=nm)
        assert bad_slices(g.float().numpy()).any(), nm
        assert not bad_slices(g.float().numpy()).all(), nm


def test_tiny_sparse_gpt2_fp16_matches_the_jax_engine():
    """A 2-layer sparse GPT-2 (Fixed unidirectional, block 16, seq 64,
    head_dim 64, dropout 0) trains 10 fp16 steps under the dynamic loss
    scaler on both engines, an inf written into a compute parameter
    before step 3: the same steps skipped, the same scale after every
    step, the losses of the other steps to rtol 1e-2 (fp16 products round
    at other places in XLA's CPU matmuls and torch's)."""
    import deepspeed_tpu as jds
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu.models import GPT2Config as JGPT2
    from deepspeed_tpu.models import GPT2LMHeadTPU
    from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JF
    from deepspeed_tpu.parallel import make_mesh
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHead,
                                                 random_params)
    from deepspeed_tpu_torch.ops.sparse_attention import \
        FixedSparsityConfig as TF

    skw = dict(num_heads=2, block=16, num_local_blocks=2,
               num_global_blocks=1, attention="unidirectional")
    params = random_params(GPT2Config(**GPT2_TINY), seed=0)
    jengine, *_ = jds.initialize(
        model=GPT2LMHeadTPU(JGPT2(**dict(GPT2_TINY, attn_impl="sparse",
                                         sparsity_config=JF(**skw)))),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=fp16_config(),
        mesh=make_mesh({"data": 1}, devices=jax.devices("cpu")[:1]))
    tengine, *_ = tds.initialize(
        model=GPT2LMHead(GPT2Config(**dict(GPT2_TINY, attn_impl="sparse",
                                           sparsity_config=TF(**skw)))),
        model_parameters=params, config=fp16_config(), device="cpu")
    assert tengine.compute_dtype == torch.float16
    poison = ("blocks", "layer_0", "fc1", "bias")
    batches = gpt2_batches(10)
    jl, js, jk = run(jengine, batches, poison, poison_jax)
    tl, ts, tk = run(tengine, batches, poison, poison_port)
    assert tk == jk and tk[-1] == 1 and tk.index(1) == POISON_STEP
    assert ts == js and len(set(ts)) > 1
    keep = [i for i in range(10) if i != POISON_STEP]
    assert np.isfinite(np.array(tl)[keep]).all()
    np.testing.assert_allclose(np.array(tl)[keep], np.array(jl)[keep],
                               rtol=LOSS_RTOL, atol=0)
