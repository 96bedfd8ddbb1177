"""1-bit Adam and ``sparse_gradients`` above one ``model`` rank (ROADMAP
A18) against the JAX engine on the same mesh.

Four gloo ranks at ``{data: 2, model: 2}``
(:func:`tests.torch_tp_workers.onebit_sparse_grad_world`, spawned once)
against the JAX engine on the same mesh over four virtual CPU devices.

1-bit Adam (GPT-2, stage 0, ``freeze_step`` 3, 6 steps).  Each rank
compresses its own slices over its data group, the compression's scales
taken over the whole model (a leaf replicated over ``model`` counted
once); the JAX engine compresses the whole flat buffer, with one server
scale a data rank's chunk of it.  So:
- the warmup is dense Adam: its losses, and the loss of the first step
  after the freeze, which the warmup's master computes, within ``RTOL``;
- the compressed steps are the same algorithm on other chunks: the
  losses after them within ``COMPRESSED_RTOL`` (measured: see it);
- the leaves replicated over ``model`` stay bitwise equal on both model
  ranks through the compressed steps (a scale taken over one rank's
  slices alone would part them at the first);
- from the freeze on, no dense all-reduce: one all-to-all of packed
  signs a step, the error buffers sized for the rank's own slices.

A compressed-phase checkpoint loads back bitwise but for the error
buffers, which restart from zero (each rank's part of the model).

``sparse_gradients`` (a vocab-parallel embedding, ids in each rank's
vocab range, and a readout): the losses and the whole master within
``RTOL`` of the JAX engine's, and the embedding's rows cross the data
axis as an all-gather of (ids, rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu as jds
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu_torch.comm import compression

from . import torch_tp_workers as W
from .torch_dist import run_ranks

WORLD = 4
DIMS = {"data": 2, "model": 2}
RTOL = 1e-5
MASTER_ATOL = 1e-5
# the compressed steps against the JAX engine's: the same signs on
# other chunks, whose scales differ by the chunks' RMS, through a
# variance frozen after 3 steps (elements below eps take steps of up to
# lr·m/eps, which compound): measured 3.5e-5 after the first compressed
# update and 1.9e-3 after the second
COMPRESSED_RTOL = 2e-2


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


class JaxTinyVocab:
    """:class:`tests.torch_tp_workers.TinyVocabModel` in JAX."""

    def partition_specs(self, mesh):
        return {"emb": P("model", None), "w": P()}

    def sparse_gradient_paths(self):
        return ("emb",)

    def apply(self, params, batch, rng=None, train=True, **kw):
        x = jnp.take(params["emb"], batch["input_ids"], axis=0)
        return jnp.mean((x @ params["w"] - batch["y"]) ** 2)


def jax_run(model, params, cfg, batches, steps):
    mesh = jax_mesh(DIMS, devices=jax.devices("cpu")[:WORLD])
    eng, *_ = jds.initialize(
        model=model, model_parameters=jax.tree_util.tree_map(jnp.asarray,
                                                             params),
        config=dict(cfg), mesh=mesh)
    it = iter(batches)
    losses = [float(np.asarray(eng.train_batch(it))) for _ in range(steps)]
    return losses, eng.flat.gather_master_unpadded(eng.state["master"])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    _, params = W.gpt2()
    onebit = jax_run(GPT2LMHeadTPU(JConfig(**W.TINY)), params,
                     W.config(W.ONEBIT, stage=0, dp=2, clip=0.0),
                     W.gpt2_batches(W.ONEBIT_STEPS), W.ONEBIT_STEPS)
    sparse = jax_run(JaxTinyVocab(), W.TinyVocabModel().init(0),
                     W.vocab_config(2), W.vocab_batches(4), 4)
    return {"onebit": onebit, "sparse_grad": sparse,
            "ranks": run_ranks(W.onebit_sparse_grad_world, WORLD,
                               tmp_path_factory.mktemp("ranks"),
                               str(tmp_path_factory.mktemp("ckpt")))}


def test_onebit_at_data2_model2_matches_the_jax_engine(ref):
    want, _ = ref["onebit"]
    got = ref["ranks"][0]["onebit"]["losses"]
    for r in ref["ranks"][1:]:
        assert r["onebit"]["losses"] == got
    k = W.ONEBIT["params"]["freeze_step"] + 1
    np.testing.assert_allclose(got[:k], want[:k], rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, want, rtol=COMPRESSED_RTOL, atol=0)
    assert np.isfinite(got).all()


def test_onebit_keeps_replicated_leaves_equal_on_both_model_ranks(ref):
    """Ranks 0 and 1 are model ranks 0 and 1 of data rank 0 (model
    innermost); 2 and 3 those of data rank 1."""
    for a, b in ((0, 1), (2, 3), (0, 2)):
        ra = ref["ranks"][a]["onebit"]["replicated"]
        rb = ref["ranks"][b]["onebit"]["replicated"]
        assert set(ra) == set(rb) and "wpe" in ra
        for key in ra:
            np.testing.assert_array_equal(ra[key], rb[key], err_msg=key)


def test_onebit_compressed_steps_exchange_signs_of_the_ranks_slices(ref):
    freeze = W.ONEBIT["params"]["freeze_step"]
    for r in ref["ranks"]:
        got = r["onebit"]
        n = got["n_local"]
        n_pad = compression.padded_size(n, 2)
        assert got["errors"] == ((n_pad,), (n_pad // 2,))
        # a warmup step's all-reduces: the model axis's activations and
        # the dense fp32 gradient over data
        warm = got["calls"][freeze - 1][1]["psum"]
        for step, (calls, nbytes) in enumerate(got["calls"]):
            if step < freeze:
                assert "all_to_all" not in calls
                assert nbytes["psum"] >= 4 * n
                continue
            assert calls["all_to_all"] == 1
            assert nbytes["all_to_all"] <= n_pad // 8
            # the same activations' all-reduces without the gradient's
            # (the loss and the scales' two fp64 sums a phase remain)
            assert nbytes["psum"] <= warm - 4 * n + 64, (step, nbytes)


def test_onebit_checkpoint_above_one_model_rank_restarts_the_errors(ref):
    """A compressed-phase checkpoint at data 2 × model 2 holds the whole
    master and moments, which load back bitwise on every rank; the error
    buffers, each rank's own part of the model, restart from zero."""
    for r in ref["ranks"]:
        got = r["onebit"]["loaded"]
        assert got["errors_were_set"]
        assert got["master_equal"] and got["moments_equal"]
        assert got["errors_zero"]


def test_sparse_gradients_at_data2_model2_match_the_jax_engine(ref):
    want, want_master = ref["sparse_grad"]
    for r in ref["ranks"]:
        got = r["sparse_grad"]
        assert got["paths"] == ("emb",)
        np.testing.assert_allclose(got["losses"], want, rtol=RTOL, atol=0)
        np.testing.assert_allclose(got["master"], want_master, rtol=0,
                                   atol=MASTER_ATOL)
        for calls, _ in got["calls"]:
            assert calls["all_gather"] >= 2      # ids and rows
