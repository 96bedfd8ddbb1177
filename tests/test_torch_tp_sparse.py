"""The block-sparse attention core above one ``model`` rank (ROADMAP
A18) against the JAX engine on the same mesh.

Two gloo ranks (:func:`tests.torch_tp_workers.sparse_model2_world`,
spawned once) train a tiny sparse GPT-2 whose Fixed layout differs per
head (``different_layout_per_head``, four global patterns) at ``{model:
2}``: each rank runs its two heads on its rows of the layout, cut once
and cached.  The JAX engine runs the same model on ``{model: 2}`` over
two virtual CPU devices, where GSPMD cuts the heads.  On the CPU both
take the gather path.

- Dropout 0: the losses within ``RTOL`` of the JAX engine's over 5
  steps and the whole master within ``MASTER_ATOL`` (the ranks' sums run
  in another order than XLA's); each rank's cached layout is its heads'
  rows of the whole one.
- Dropout 0.1 on the sparse core's context (and the rest of the layer):
  the model-2 run equals the port's own one-rank run within ``RTOL``,
  since each rank draws the whole layer's mask and keeps its heads'
  part.  A rank that drew a mask at its own heads' shape would drop
  other entries, and the two runs would part at the first step.
- In one process: a rank's attention core at ``{model: 2}`` equals its
  heads of the whole core (the CPU form of the card's head-range
  check).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JFixed
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu_torch.models.layers import TransformerLayer
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu_torch.parallel import Mesh, current_mesh
from deepspeed_tpu_torch.utils.params import (EXPERT, MODEL,
                                              params_from_numpy, tp_slice)

from . import torch_tp_workers as W
from .torch_dist import run_ranks

WORLD = 2
# losses against the JAX engine and the port's one-rank run (the dense
# model's tolerances, tests/test_torch_tensor_parallel.py)
RTOL = 1e-5
MASTER_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def restore_jax_current_mesh():
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


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    _, params = W.gpt2()
    mesh = jax_mesh({"model": WORLD}, devices=jax.devices("cpu")[:WORLD])
    model = GPT2LMHeadTPU(JConfig(**dict(
        W.TINY, attn_impl="sparse",
        sparsity_config=JFixed(**W.SPARSE_LAYOUT))))
    eng, *_ = jds.initialize(
        model=model, model_parameters=jax.tree_util.tree_map(jnp.asarray,
                                                             params),
        config=W.config(W.ADAM), mesh=mesh)
    it = iter(W.sparse_batches(W.STEPS))
    losses = [float(np.asarray(eng.train_batch(it)))
              for _ in range(W.STEPS)]
    return {"losses": losses,
            "master": eng.flat.gather_master_unpadded(eng.state["master"]),
            "ranks": run_ranks(W.sparse_model2_world, WORLD,
                               tmp_path_factory.mktemp("ranks"))}


def test_sparse_core_at_model2_matches_the_jax_engine(ref):
    got0, got1 = (r["sparse"] for r in ref["ranks"])
    assert got0["losses"] == got1["losses"]
    np.testing.assert_array_equal(got0["master"], got1["master"])
    np.testing.assert_allclose(got0["losses"], ref["losses"], rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(got0["master"], ref["master"], rtol=0,
                               atol=MASTER_ATOL)


def test_each_rank_runs_its_heads_rows_of_the_per_head_layout(ref):
    whole = FixedSparsityConfig(**W.SPARSE_LAYOUT).make_layout(W.SPARSE_SEQ)
    assert whole.shape[0] == W.TINY["num_heads"]
    assert len({whole[h].tobytes() for h in range(whole.shape[0])}) > 1
    for rank, r in enumerate(ref["ranks"]):
        heads = W.TINY["num_heads"] // WORLD
        key = str((W.SPARSE_SEQ, rank * heads, heads))
        assert set(r["layouts"]) == {str(W.SPARSE_SEQ), key}
        np.testing.assert_array_equal(r["layouts"][str(W.SPARSE_SEQ)], whole)
        np.testing.assert_array_equal(
            r["layouts"][key], whole[rank * heads:(rank + 1) * heads])


def test_sparse_dropout_at_model2_equals_one_rank(ref):
    model, params = W.sparse_gpt2(**W.DROPOUT)
    eng = W.engine(model, params, W.config(W.ADAM))
    want = W.train(eng, W.sparse_batches(W.STEPS))
    for r in ref["ranks"]:
        np.testing.assert_allclose(r["dropout"], want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_a_ranks_sparse_core_is_its_heads_of_the_whole_core(rate):
    """Rank r's attention core (QKV, the sparse core on its rows of the
    per-head layout, the context dropout cut from the whole mask) equals
    its heads' columns of the whole layer's core on the same input and
    generator seed."""
    layer = TransformerLayer(64, 4, causal=True, attn_impl="sparse",
                             attn_dropout_ratio=rate,
                             sparsity_config=FixedSparsityConfig(
                                 **W.SPARSE_LAYOUT))
    whole = layer.init(0)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, W.SPARSE_SEQ, 64)).astype(np.float32))

    def core(params, mesh):
        rng = torch.Generator().manual_seed(11)
        with current_mesh(mesh):
            return layer.attention_core(params, x, attn_rng=rng,
                                        deterministic=False)

    want = core(params_from_numpy(whole, "cpu"), None)
    for rank in range(WORLD):
        part = params_from_numpy(tp_slice(
            whole, TransformerLayer.partition_specs(),
            {MODEL: rank, EXPERT: 0}, {MODEL: WORLD}), "cpu")
        got = core(part, Mesh({"model": WORLD}, rank=rank))
        cols = slice(rank * 32, (rank + 1) * 32)
        torch.testing.assert_close(got, want[..., cols], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("impl", ["sparse", "ring"])
def test_context_dropout_cuts_the_whole_layers_mask(impl):
    """The sparse and ring cores' context dropout on a rank's heads
    ``[h0, h0 + heads)`` keeps the whole layer's mask on those heads, so
    model ranks drop what one rank drops (it drew a mask at the rank's
    own heads' shape before, the same bits on every rank)."""
    kw = ({"sparsity_config": FixedSparsityConfig(**W.SPARSE_LAYOUT)}
          if impl == "sparse" else {})
    layer = TransformerLayer(64, 4, causal=True, attn_impl=impl,
                             attn_dropout_ratio=0.1, **kw)
    ctx = torch.ones(2, 16, 4, 16)
    want = layer._context_dropout(ctx, torch.Generator().manual_seed(5),
                                  False)
    assert 0 < int((want == 0).sum()) < want.numel()
    for h0 in (0, 2):
        got = layer._context_dropout(ctx[:, :, h0:h0 + 2],
                                     torch.Generator().manual_seed(5),
                                     False, h0)
        torch.testing.assert_close(got, want[:, :, h0:h0 + 2], rtol=0,
                                   atol=0)
