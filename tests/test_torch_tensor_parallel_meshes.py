"""Tensor parallelism with the other axes: GPT-2 at ``{data: 2, model:
2}`` (ZeRO-2, Adam and Lamb, a clip that binds) and as a pipeline at
``pipe 2 × model 2`` (the layers of ``examples/train_torch_pipe.py``,
whose embedding and head are vocab-parallel), on 4 gloo ranks
(:func:`tests.torch_tp_workers.data_pipe_world`), against the JAX engine
and the JAX ``PipelineEngine`` on the same meshes: losses within
``RTOL`` over 5 steps, the whole master close, and every rank's losses
and gathered master the same (the pipeline gathers it onto rank 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu.models.layers import TransformerLayer as JLayer
from deepspeed_tpu.models.layers import cross_entropy_with_logits, layer_norm
from deepspeed_tpu.parallel import make_mesh as jax_mesh
from deepspeed_tpu.runtime.pipe import LayerSpec as JLayerSpec
from deepspeed_tpu.runtime.pipe import PipelineModule as JPipelineModule
from deepspeed_tpu.runtime.pipe import TiedLayerSpec as JTiedLayerSpec

from . import torch_tp_workers as W
from .test_torch_tensor_parallel import (MASTER_ATOL, RTOL, jax_engine,
                                         jax_master, jax_train)
from .torch_dist import run_ranks


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


@pytest.fixture(scope="module")
def save_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pipe_ckpt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, save_dir):
    return run_ranks(W.data_pipe_world, 4, tmp_path_factory.mktemp("tp4"),
                     save_dir)


def _same_on_every_rank(got, master=True):
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        if master:
            np.testing.assert_array_equal(r["master"], got[0]["master"])


@pytest.mark.parametrize("name,opt", [("adam", W.ADAM), ("lamb", W.LAMB)])
def test_data2_model2_matches_the_jax_engine(ranks, name, opt):
    _, params = W.gpt2()
    eng = jax_engine(GPT2LMHeadTPU(JConfig(**W.TINY)), params,
                     W.config(opt, dp=2), {"data": 2, "model": 2})
    want = jax_train(eng, W.gpt2_batches(W.STEPS))
    got = [r[name] for r in ranks]
    _same_on_every_rank(got)
    np.testing.assert_allclose(got[0]["losses"], want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[0]["master"], jax_master(eng), rtol=0,
                               atol=MASTER_ATOL)


class _Embedding:
    """The JAX side of the example's ``Embedding`` (token and position
    tables, the token one tied to the head)."""

    def __init__(self, vocab, hidden, max_pos):
        self.shapes = {"wte": (vocab, hidden), "wpe": (max_pos, hidden)}

    def init(self, rng):
        return {k: jnp.zeros(s, jnp.float32) for k, s in self.shapes.items()}

    def apply(self, params, ids):
        return (jnp.take(params["wte"], ids, axis=0)
                + params["wpe"][None, :ids.shape[1]])


class _FinalNorm:
    def __init__(self, hidden, eps):
        self.hidden, self.eps = hidden, eps

    def init(self, rng):
        return {"scale": jnp.ones((self.hidden,), jnp.float32),
                "bias": jnp.zeros((self.hidden,), jnp.float32)}

    def apply(self, params, x):
        return layer_norm(params, x, self.eps)


def _lm_head(params, x):
    return x @ params["wte"].T.astype(x.dtype)


def jax_pipe_module():
    t = W.TINY
    h, eps = t["hidden_size"], 1e-5
    embed = ("embed", _Embedding, t["vocab_size"], h,
             t["max_position_embeddings"])
    specs = ([JTiedLayerSpec(*embed, tied_weight_attr="wte")]
             + [JLayerSpec(JLayer, h, t["num_heads"], causal=True,
                           attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
                           pre_layer_norm=True, layer_norm_eps=eps)
                for _ in range(t["num_layers"])]
             + [JLayerSpec(_FinalNorm, h, eps),
                JTiedLayerSpec(*embed, forward_fn=_lm_head,
                               tied_weight_attr="wte")])
    return JPipelineModule(specs, loss_fn=cross_entropy_with_logits,
                           partition_method="type:TransformerLayer")


def test_pipe2_model2_matches_the_jax_pipeline_engine(ranks):
    mesh = jax_mesh({"pipe": 2, "model": 2}, devices=jax.devices("cpu")[:4])
    eng, *_ = jds.initialize(
        model=jax_pipe_module(), model_parameters=jax.tree_util.tree_map(
            jnp.asarray, W.pipe_params()), config=W.pipe_config(),
        mesh=mesh)
    want = [float(np.asarray(eng.train_batch(iter(W.pipe_batches()))))
            for _ in range(W.STEPS)]
    got = [r["pipe"] for r in ranks]
    # the stages' rows are gathered onto global rank 0 alone
    _same_on_every_rank(got, master=False)
    assert all(r["master"] is None for r in got[1:])
    np.testing.assert_allclose(got[0]["losses"], want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got[0]["master"],
                               eng.flat.gather_master_unpadded(
                                   eng.state["master"]),
                               rtol=0, atol=MASTER_ATOL)


def test_pipe2_model2_checkpoint_loads_at_one_stage(ranks, save_dir):
    """The pipe 2 × model 2 save is the whole tree: the one-stage
    pipeline engine at model 1 loads it, master bitwise the ranks'."""
    from deepspeed_tpu_torch import initialize

    module, _ = W.pipe_module()
    eng, *_ = initialize(model=module, model_parameters=W.pipe_params(),
                         config=W.pipe_config(), device="cpu")
    eng.load_checkpoint(save_dir, strict=True)
    np.testing.assert_array_equal(eng._gather_unpadded(eng.master),
                                  ranks[0]["pipe"]["master"])
