"""Mixture-of-Experts and expert parallelism of the port (ROADMAP A10,
the ``expert`` axis) against the JAX package.

- ``_router_dispatch`` against the JAX function, dispatch and combine
  equal and aux to 1e-6, at k = 1 (Switch: the raw gate probability)
  and k = 2 (GShard: renormalized), with a capacity that overflows and
  with ties, which take the lowest expert index (``jnp.argmax``).
- ``MoEFFN``: output, aux and every gradient against the JAX layer's.
- MoE GPT-2 (every second block routed, E = 4, k = 2): the training
  loss with ``moe_aux_coef`` × the blocks' mean aux, and every gradient,
  against ``GPT2LMHeadTPU``.
- One expert at k = 1 is the dense FFN: a MoE block with the dense
  block's FFN weights gives the dense block's output.
- The trajectories of 5 steps at ``{data: 2, expert: 2}`` and ``{expert:
  2, model: 2}`` on 4 gloo ranks (:func:`tests.torch_tp_workers.moe_world`)
  against the JAX engine on the same mesh, losses within ``RTOL``; the
  router and the other replicated leaves stay bitwise equal on every
  rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.models import moe as jmoe
from deepspeed_tpu_torch.models import moe
from deepspeed_tpu_torch.models.layers import TransformerLayer
from deepspeed_tpu_torch.utils.params import params_from_numpy, tree_leaves

from . import torch_tp_workers as W
from .test_torch_tensor_parallel import (MASTER_ATOL, RTOL, jax_engine,
                                         jax_master, jax_train)
from .torch_dist import run_ranks

# forward values and gradients against the JAX layers (fp32, the same
# einsums in another summation order)
TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def restore_jax_current_mesh():
    """The JAX engines built here make their mesh the JAX package's
    current mesh, which its MoE layer and ring attention read when given
    none: the module puts back the mesh it found, so the test files run
    after it in this process see that one."""
    from deepspeed_tpu.parallel import mesh as jax_mesh_state

    prev = jax_mesh_state.get_current_mesh()
    yield
    jax_mesh_state.set_current_mesh(prev)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _probs(seed, T=16, E=4, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E), dtype=np.float32)
    if ties:
        # exact ties between experts 1 and 2 (first choice) and between
        # 0 and 3 (second choice)
        logits[:, 1] = logits[:, 2] = 3.0
        logits[:, 0] = logits[:, 3] = 1.0
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("k,capacity,ties", [
    (1, 8, False), (2, 8, False), (1, 2, False), (2, 4, False),
    (2, 8, True), (1, 4, True)],
    ids=["k1", "k2", "k1-overflow", "k2-overflow", "k2-ties", "k1-ties"])
def test_router_dispatch_matches_jax(k, capacity, ties):
    p = _probs(k * 10 + capacity, ties=ties)
    jd, jc, ja = jmoe._router_dispatch(jnp.asarray(p), k, capacity)
    d, c, a = moe._router_dispatch(torch.from_numpy(p), k, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)
    if ties:
        # the first choice of every token is expert 1, the lower of the
        # tie, and at k = 2 the second is expert 2
        first = d.numpy().any(-1)
        assert first[:, 1].sum() == min(16, capacity)
        assert not first[:, 0].any() and not first[:, 3].any()
        if k == 2:
            assert first[:, 2].sum() == min(16, capacity)
    if capacity < 16 * k / 4:
        # over capacity: some token-choices are dropped
        assert d.numpy().sum() < 16 * k


def _ffn_inputs(seed=0, E=4, H=16, I=32):
    layer = moe.MoEFFN(H, I, E, k=2, capacity_factor=1.0)
    params = layer.init(np.random.default_rng(seed))
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 12, H), dtype=np.float32)
    return layer, params, x


def test_moe_ffn_and_its_grads_match_jax():
    layer, params, x = _ffn_inputs()
    jlayer = jmoe.MoEFFN(16, 32, 4, k=2, capacity_factor=1.0)
    w = np.random.default_rng(9).standard_normal(x.shape, dtype=np.float32)

    def jloss(p, xx):
        y, aux = jlayer.apply(p, xx)
        return jnp.sum(y * w) + aux, (y, aux)

    (jl, (jy, ja)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    tp = params_from_numpy(params, "cpu")
    for leaf in tree_leaves(tp)[1]:
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = layer.apply(tp, tx)
    loss = (y * torch.from_numpy(w)).sum() + aux
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux.detach()), float(ja), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=TOL,
                               atol=TOL)
    jpaths, jleaves = tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    paths, leaves = tree_leaves(tp)
    assert jpaths == paths
    for path, got, want in zip(paths, leaves, jleaves):
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=TOL,
                                   atol=TOL, err_msg=str(path))


def test_moe_gpt2_loss_and_grads_match_jax():
    model, params = W.gpt2(**W.MOE)
    jmodel = GPT2LMHeadTPU(JConfig(**dict(W.TINY, **W.MOE)))
    batch = W.gpt2_batches(1, seed=3)[0]

    def jloss(p):
        return jmodel.apply(p, {"input_ids": jnp.asarray(
            batch["input_ids"])}, rng=None, train=True)

    jl, jg = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, params))
    tp = params_from_numpy(params, "cpu")
    for leaf in tree_leaves(tp)[1]:
        leaf.requires_grad_(True)
    loss = model.apply(tp, {"input_ids": torch.from_numpy(
        batch["input_ids"]).long()}, rng=None, train=True)
    loss.backward()
    assert model._last_moe_aux is not None
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    jpaths, jleaves = tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    paths, leaves = tree_leaves(tp)
    assert jpaths == paths
    for path, got, want in zip(paths, leaves, jleaves):
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=TOL,
                                   atol=TOL, err_msg=str(path))


def test_one_expert_at_k1_is_the_dense_ffn():
    dense = TransformerLayer(32, 4, causal=True, attn_dropout_ratio=0.0,
                             hidden_dropout_ratio=0.0, pre_layer_norm=True,
                             layer_norm_eps=1e-5)
    block = moe.MoETransformerLayer(32, 4, num_experts=1, k=1,
                                    attn_dropout_ratio=0.0,
                                    hidden_dropout_ratio=0.0)
    p = dense.init(4)
    mp = {k: p[k] for k in ("qkv", "attn_out", "ln_attn", "ln_mlp")}
    mp["moe"] = {"router": {"kernel": np.ones((32, 1), np.float32)},
                 "fc1": {k: v[None] for k, v in p["fc1"].items()},
                 "fc2": {k: v[None] for k, v in p["fc2"].items()}}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, 32), dtype=np.float32))
    with torch.no_grad():
        want = dense.apply(params_from_numpy(p, "cpu"), x)
        got, aux = block.apply(params_from_numpy(mp, "cpu"), x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert float(aux) == 1.0   # E · fraction · mean prob = 1 · 1 · 1


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    return run_ranks(W.moe_world, 4, tmp_path_factory.mktemp("moe"))


@pytest.mark.parametrize("name,dims", [
    ("moe_data", {"data": 2, "expert": 2}),
    ("moe_model", {"expert": 2, "model": 2})])
def test_expert_parallel_trajectories_match_the_jax_engine(moe_ranks, name,
                                                           dims):
    _, params = W.gpt2(**W.MOE)
    eng = jax_engine(GPT2LMHeadTPU(JConfig(**dict(W.TINY, **W.MOE))),
                     params, W.config(W.ADAM, dp=dims.get("data", 1)), dims)
    want = jax_train(eng, W.gpt2_batches(W.STEPS))
    got = [r[name] for r in moe_ranks]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        np.testing.assert_array_equal(r["master"], got[0]["master"])
    np.testing.assert_allclose(got[0]["losses"], want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[0]["master"], jax_master(eng), rtol=0,
                               atol=MASTER_ATOL)
    # the router (and every other replicated leaf) is the same on every
    # rank: its gradient comes out equal with no exchange
    a = got[0]["replicated"]
    assert any("router" in key for key in a)
    for r in got[1:]:
        for key in a:
            np.testing.assert_array_equal(r["replicated"][key], a[key])
