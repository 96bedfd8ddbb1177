"""Sequence parallelism of the port (the ``seq`` axis, ring attention)
through the engine, against the JAX engine on the same mesh.

The port runs on four gloo processes (:func:`tests.torch_seq_workers.seq_world`,
one spawn for the module) through ``initialize(mesh=make_mesh(...))``;
each rank takes its data rank's whole rows and the model cuts its
``seq`` chunk.  The JAX engine runs in this process on the same mesh
over the conftest's virtual CPU devices (its ring under
``jax.shard_map``).  fp32; losses within ``RTOL`` over 5 steps, the
whole master within ``MASTER_ATOL`` (the ranks sum in another order
than XLA), as the tensor-parallel tests hold them.

- GPT-2 (the JAX ring engine test's tiny model) at data 2 × seq 2
  (ZeRO-2, Adam, a clip that binds) and at seq 2 × model 2, against the
  JAX engine on the mesh and against the port's one-rank dense run;
  ZeRO-0 (one all-reduce over data × seq) and ZeRO-3 at data 2 × seq 2
  against the JAX ZeRO-2 run (the stage does not change the math); ``eval_batch``'s logits gathered over ``seq``
  and its loss the one-rank run's.
- BERT with a padding mask and the MLM gather over the whole row at
  data 2 × seq 2 (Lamb, ZeRO-1) against the JAX BERT with
  ``attn_impl="ring"``.
- The data 2 × seq 2 checkpoint, loaded at one rank in the port and in
  the JAX package: master bitwise the ranks' gathered one.
- In this process: each combination ROADMAP A19 refused builds on a
  ``seq`` mesh (it is trained in ``tests/test_torch_seq_compose.py``).

The JAX engines on these meshes are compiled afresh, bypassing the
persistent compilation cache the conftest sets: on this jaxlib the
``{"seq": 2, "model": 2}`` step loaded from that cache deadlocks in
XLA:CPU's collective rendezvous (a collective-permute and an all-reduce
entered in different orders by two devices), while the freshly compiled
one runs (ROADMAP C's caveats).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from jax.experimental.compilation_cache import compilation_cache
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models import BertConfig as JBertConfig
from deepspeed_tpu.models import BertForPreTrainingTPU
from deepspeed_tpu.models import GPT2Config as JConfig
from deepspeed_tpu.models import GPT2LMHeadTPU
from deepspeed_tpu_torch.parallel import Mesh

from . import torch_seq_workers as W
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


@contextlib.contextmanager
def fresh_compiles():
    """JAX compiles inside the block without the persistent cache."""
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)
        compilation_cache.reset_cache()


def jax_gpt2():
    return GPT2LMHeadTPU(JConfig(**dict(W.TINY, attn_impl="ring")))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX trajectories on the ranks' meshes and the port's ranks."""
    out = {}
    _, params = W.gpt2()
    with fresh_compiles():
        for name, dims, cfg in (
                ("gpt2_d2s2", {"data": 2, "seq": 2},
                 W.config(W.ADAM, dp=2)),
                ("gpt2_s2m2", {"seq": 2, "model": 2}, W.config(W.ADAM))):
            eng = jax_engine(jax_gpt2(), params, cfg, dims)
            out[name] = {"losses": jax_train(eng, W.gpt2_batches(W.STEPS)),
                         "master": jax_master(eng)}
        _, params = W.bert()
        eng = jax_engine(BertForPreTrainingTPU(JBertConfig(
            **dict(W.BERT_TINY, attn_impl="ring"))), params,
            W.config(W.LAMB, stage=1, dp=2), {"data": 2, "seq": 2})
        out["bert_d2s2"] = {"losses": jax_train(eng,
                                                W.bert_batches(W.STEPS)),
                            "master": jax_master(eng)}
    save_dir = str(tmp_path_factory.mktemp("seq_ckpt"))
    out["save_dir"] = save_dir
    out["ranks"] = run_ranks(W.seq_world, W.WORLD,
                             tmp_path_factory.mktemp("seq"), save_dir)
    return out


def _same_on_every_rank(got):
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]
        np.testing.assert_array_equal(r["master"], got[0]["master"])


@pytest.mark.parametrize("name", ["gpt2_d2s2", "gpt2_s2m2", "bert_d2s2",
                                  "zero0", "zero3"])
def test_seq_matches_the_jax_engine_on_the_same_mesh(ref, name):
    got = [r[name] for r in ref["ranks"]]
    want = ref["gpt2_d2s2" if name.startswith("zero") else name]
    _same_on_every_rank(got)
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(got[0]["master"], want["master"], rtol=0,
                               atol=MASTER_ATOL)


def test_seq_sum_moves_the_data_shard_only(ref):
    """Under ZeRO-2 at data 2 × seq 2 the seq ranks sum the gradient's
    data shard after the reduce-scatter, not the whole flat gradient:
    the steps' all-reduce bytes are one fp32 shard a step plus the
    stats and the loss normaliser's few scalars (at most 1 KiB a
    step)."""
    for r in ref["ranks"]:
        got = r["gpt2_d2s2"]
        shard = got["shard_bytes"]
        assert W.STEPS * shard <= got["psum_bytes"] \
            <= W.STEPS * (shard + 1024)


def _one_rank(attn_impl="auto"):
    model, params = W.gpt2(attn_impl)
    eng = W.engine(model, params, W.config(W.ADAM))
    return eng, W.train(eng, W.gpt2_batches(W.STEPS))


def test_seq_matches_the_port_one_rank_dense_run(ref):
    """The dense core at one rank on the global batch takes the same
    trajectory as the ring at data 2 × seq 2 and seq 2 × model 2."""
    _, want = _one_rank()
    for name in ("gpt2_d2s2", "gpt2_s2m2"):
        np.testing.assert_allclose(ref["ranks"][0][name]["losses"], want,
                                   rtol=RTOL, atol=0)


def test_eval_batch_gathers_the_logits_over_seq(ref):
    """``eval_batch`` returns the data rank's whole [b, s, vocab] logits
    on every seq rank (gathered over ``seq``) and the global loss (the
    seq ranks' partials summed, the data ranks averaged)."""
    eng, _ = _one_rank()
    batch = W.eval_batch()
    logits = eng.eval_batch({"input_ids": batch["input_ids"]}).numpy()
    loss = float(eng.eval_batch(batch))
    for r in ref["ranks"]:
        got = r["gpt2_d2s2"]
        d = got["dp_rank"]
        want = logits[d * 2:(d + 1) * 2]
        assert got["eval_logits"].shape == want.shape
        np.testing.assert_allclose(got["eval_logits"], want, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got["eval_loss"], loss, rtol=RTOL)


def test_checkpoint_at_data2_seq2_loads_at_one_rank_and_in_jax(ref):
    """The data 2 × seq 2 save is the JAX whole-tree layout, written by
    one seq rank: the port at one rank (dense core) and the JAX engine
    load it, master bitwise the ranks' gathered master."""
    want = ref["ranks"][0]["gpt2_d2s2"]["master"]
    model, params = W.gpt2("auto")
    eng = W.engine(model, params, W.config(W.ADAM))
    eng.load_checkpoint(ref["save_dir"], strict=True)
    np.testing.assert_array_equal(W.whole_master(eng), want)
    _, params = W.gpt2()
    jeng = jax_engine(GPT2LMHeadTPU(JConfig(**W.TINY)), params,
                      W.config(W.ADAM), {"data": 1})
    jeng.load_checkpoint(ref["save_dir"])
    np.testing.assert_array_equal(jax_master(jeng), want)


def _builds_to_its_first_collective(mesh, model_params, cfg):
    """``initialize`` on a mesh without process groups gets past every
    check and stops at its first collective."""
    model, params = model_params
    with pytest.raises(RuntimeError, match="process group"):
        tds.initialize(model=model, model_parameters=params, config=cfg,
                       mesh=mesh, device="cpu")


ONEBIT = {"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": 2}}


@pytest.mark.parametrize("case", [
    "dense_core", "sparse_core", "pipe", "expert", "moe", "onebit",
    "sparse_gradients"])
def test_what_does_not_compose_with_seq_raises_naming_a19(case):
    """Every combination A19 refused composes with ``seq`` since its
    slice (``tests/test_torch_seq_compose.py`` trains each on gloo ranks
    against the JAX engine): at ``initialize`` on a ``seq`` mesh of one
    process each gets past every check and stops at its first
    collective, which this mesh has no group for; so does offload above
    one rank (A9, ``tests/test_torch_offload_dp.py``)."""
    d2s2 = Mesh({"data": 2, "seq": 2})
    cfg = W.config(W.ADAM, dp=2)
    if case in ("dense_core", "sparse_core"):
        from deepspeed_tpu_torch.ops.sparse_attention import \
            FixedSparsityConfig
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
        kw = dict(W.TINY, attn_impl="auto" if case == "dense_core"
                  else "sparse")
        if case == "sparse_core":
            kw["sparsity_config"] = FixedSparsityConfig(num_heads=4,
                                                        block=16)
        model = GPT2LMHead(GPT2Config(**kw))
        _builds_to_its_first_collective(d2s2, (model, None), cfg)
    elif case == "pipe":
        from deepspeed_tpu_torch.runtime.pipe import PipelineModule

        from .torch_pipe_workers import gpt_like_specs, xent_loss
        module = PipelineModule(gpt_like_specs(), loss_fn=xent_loss,
                                partition_method="uniform")
        _builds_to_its_first_collective(
            Mesh({"pipe": 2, "seq": 2}), (module, None),
            {"train_micro_batch_size_per_gpu": 2,
             "gradient_accumulation_steps": 2,
             "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})
    elif case == "expert":
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
        model = GPT2LMHead(GPT2Config(**dict(W.TINY, attn_impl="ring",
                                             moe_experts=4)))
        _builds_to_its_first_collective(Mesh({"expert": 2, "seq": 2}),
                                        (model, None), W.config(W.ADAM))
    elif case == "moe":
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
        model = GPT2LMHead(GPT2Config(**dict(W.TINY, attn_impl="ring",
                                             moe_experts=4)))
        _builds_to_its_first_collective(d2s2, (model, None), cfg)
    elif case == "onebit":
        _builds_to_its_first_collective(d2s2, W.gpt2(),
                                        W.config(ONEBIT, stage=0, dp=2))
        offload = W.config(W.ADAM, dp=2,
                           zero_optimization={"stage": 2,
                                              "cpu_offload": True})
        _builds_to_its_first_collective(d2s2, W.gpt2(), offload)
    else:
        _builds_to_its_first_collective(
            d2s2, W.gpt2(), W.config(W.ADAM, stage=0, dp=2,
                                     sparse_gradients=True))
