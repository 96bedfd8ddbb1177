"""Activation checkpointing in the port against the JAX package's.

The ``activation_checkpointing`` config parses to the JAX package's
values; ``should_checkpoint_layer`` spaces ``number_checkpoints`` as
JAX does; the reference API's ``checkpoint(function, *args)`` gives the
function's value and gradient (1e-6 against JAX).  Remat on GPT-2 and
BERT (the last layer under the MLM gather too) and each memory knob of
the layer, fp32, dropout off: loss at 2e-5 and every gradient at 5e-4
against the JAX remat model (the flash tests' tolerances), and the
engine's trajectory with the config block at rtol 1e-5 against the JAX
engine's.  With dropout on, JAX's streams cannot be reproduced, so the
port is held to itself: remat, each memory knob, ``cpu_checkpointing``,
``partition_activations`` and ``number_checkpoints`` give a loss and
gradients BITWISE equal to the same run without them (the recompute
replays the layer's generator), dense and sparse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models.bert import BertConfig as JBert
from deepspeed_tpu.models.bert import BertForPreTrainingTPU
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2
from deepspeed_tpu.models.gpt2 import GPT2LMHeadTPU
from deepspeed_tpu.models.layers import TransformerLayer as JLayer
from deepspeed_tpu.parallel import make_mesh
from deepspeed_tpu.runtime.activation_checkpointing import \
    checkpointing as jck
from deepspeed_tpu.runtime.activation_checkpointing.config import \
    DeepSpeedActivationCheckpointingConfig as JActConfig
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining
from deepspeed_tpu_torch.models.bert import random_params as bert_params
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params as gpt2_params
from deepspeed_tpu_torch.models.layers import TransformerLayer
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ck
from deepspeed_tpu_torch.runtime.activation_checkpointing.config import \
    DeepSpeedActivationCheckpointingConfig
from deepspeed_tpu_torch.utils.params import params_from_numpy, tree_leaves

GPT2_TINY = dict(vocab_size=256, hidden_size=64, num_layers=3, num_heads=4,
                 max_position_embeddings=64)
BERT_TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=3,
                 num_attention_heads=4, max_position_embeddings=64)
GPT2_OFF = dict(embd_dropout=0.0, attn_dropout=0.0, resid_dropout=0.0)
BERT_OFF = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
SEQ = 32
KNOBS = ("gelu_checkpoint", "attn_dropout_checkpoint", "normalize_invertible")


@pytest.fixture(autouse=True)
def reset_module_configs():
    yield
    ck.configure(act_config=DeepSpeedActivationCheckpointingConfig({}))
    jck.configure(act_config=JActConfig({}))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gpt2_batch(seed, b=2):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, GPT2_TINY["vocab_size"],
                                     size=(b, SEQ))}


def bert_batch(seed, b=2, labels_per_row=6):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, BERT_TINY["vocab_size"], size=(b, SEQ))
    labels = np.full((b, SEQ), -100, np.int64)
    for r in range(b):
        pos = rng.permutation(SEQ)[:labels_per_row]
        labels[r, pos] = ids[r, pos]
    mask = np.ones((b, SEQ), np.int64)
    mask[-1, SEQ - 9:] = 0
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": (np.arange(SEQ)[None] >= SEQ // 2)
            .repeat(b, 0).astype(np.int64),
            "masked_lm_labels": labels,
            "next_sentence_labels": rng.randint(0, 2, size=(b,))}


def torch_loss_and_grads(model, params, batch, rng=None):
    tp = params_from_numpy(params, "cpu")
    for leaf in tree_leaves(tp)[1]:
        leaf.requires_grad_()
    loss = model.apply(tp, {k: torch.from_numpy(np.asarray(v))
                            for k, v in batch.items()}, rng=rng, train=True)
    loss.backward()
    paths, leaves = tree_leaves(tp)
    return loss.detach(), {"/".join(p): (torch.zeros_like(t) if t.grad is None
                                         else t.grad)
                           for p, t in zip(paths, leaves)}


def jax_loss_and_grads(jmodel, params, batch):
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.apply(p, jbatch, rng=None, train=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
    paths, leaves = tree_leaves(jax.tree_util.tree_map(np.asarray, grads))
    return float(loss), {"/".join(p): g for p, g in zip(paths, leaves)}


def assert_bitwise(got, want):
    (loss_a, grads_a), (loss_b, grads_b) = got, want
    assert torch.equal(loss_a, loss_b), (float(loss_a), float(loss_b))
    assert grads_a.keys() == grads_b.keys()
    for path, g in grads_a.items():
        assert torch.equal(g, grads_b[path]), path


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("block", [
    None, {}, {"partition_activations": True},
    {"cpu_checkpointing": True, "number_checkpoints": 4},
    {"partition_activations": True, "contiguous_memory_optimization": True,
     "cpu_checkpointing": True, "number_checkpoints": 2,
     "synchronize_checkpoint_boundary": True, "profile": True}],
    ids=["absent", "empty", "partition", "cpu_and_number", "every_key"])
def test_config_parses_as_the_jax_package_does(block):
    params = {} if block is None else {"activation_checkpointing": block}
    assert DeepSpeedActivationCheckpointingConfig(params).repr() \
        == JActConfig(params).repr()


@pytest.mark.parametrize("k,n", [(None, 8), (2, 8), (3, 24), (5, 12),
                                 (7, 10), (24, 24), (30, 24), (0, 4)])
def test_should_checkpoint_layer_spaces_as_jax(k, n):
    params = {"activation_checkpointing": {"number_checkpoints": k}}
    ours = DeepSpeedActivationCheckpointingConfig(params)
    theirs = JActConfig(params)
    got = [ck.should_checkpoint_layer(i, n, ours) for i in range(n)]
    assert got == [jck.should_checkpoint_layer(i, n, theirs)
                   for i in range(n)]
    if k == 2 and n == 8:
        assert sum(got) == 2 and got[0] and got[4]


def test_reference_api_checkpoint():
    """``deepspeed_tpu_torch.checkpointing.checkpoint(fn, *args)``: the
    value and gradient of ``fn``, and JAX's to 1e-6."""
    w_np = np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32)
    x_np = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
    w = torch.from_numpy(w_np)

    def layer(x):
        return torch.tanh(x @ w)

    x = torch.from_numpy(x_np).requires_grad_()
    out = tds.checkpointing.checkpoint(layer, x)
    assert torch.equal(out, layer(x))
    (g1,) = torch.autograd.grad(out.sum(), x)
    (g2,) = torch.autograd.grad(layer(x).sum(), x)
    assert torch.equal(g1, g2)
    jw = jnp.asarray(w_np)
    want = jax.grad(lambda v: jds.checkpointing.checkpoint(
        lambda u: jnp.tanh(u @ jw), v).sum())(jnp.asarray(x_np))
    np.testing.assert_allclose(g1.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_configure_sets_the_module_config_by_keyword():
    cfg = ck.configure(partition_activations=True, num_checkpoints=3,
                       checkpoint_in_cpu=True, contiguous_checkpointing=True,
                       synchronize=True, profile=True)
    assert ck.is_configured() and ck.get_config() is cfg
    assert cfg.repr() == dict(
        partition_activations=True, contiguous_memory_optimization=True,
        cpu_checkpointing=True, number_checkpoints=3,
        synchronize_checkpoint_boundary=True, profile=True)


# ------------------------------------------------------- against the JAX
def remat_models(name):
    """(JAX model, port model, params, batch) for remat against JAX."""
    if name == "gpt2":
        cfg = dict(GPT2_TINY, remat=True, **GPT2_OFF)
        params = gpt2_params(GPT2Config(**cfg), 3)
        return (GPT2LMHeadTPU(JGPT2(**cfg)), GPT2LMHead(GPT2Config(**cfg)),
                params, gpt2_batch(3))
    cfg = dict(BERT_TINY, remat=True, **BERT_OFF)
    if name == "bert_gather":
        cfg["max_predictions_per_seq"] = 8
    if name == "bert_knobs":
        cfg.update({knob: True for knob in KNOBS})
    params = bert_params(BertConfig(**cfg), 4)
    return (BertForPreTrainingTPU(JBert(**cfg)),
            BertForPreTraining(BertConfig(**cfg)), params, bert_batch(4))


@pytest.mark.parametrize("name", ["gpt2", "bert", "bert_gather",
                                  "bert_knobs"])
def test_remat_loss_and_grads_match_the_jax_remat_model(name):
    jmodel, model, params, batch = remat_models(name)
    want_loss, want = jax_loss_and_grads(jmodel, params, batch)
    got_loss, got = torch_loss_and_grads(model, params, batch)
    np.testing.assert_allclose(float(got_loss), want_loss, atol=2e-5,
                               rtol=2e-5)
    assert got.keys() == want.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[path], atol=5e-4,
                                   rtol=5e-4, err_msg=path)


@pytest.mark.parametrize("knob", KNOBS + ("all",))
@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
def test_memory_knobs_match_the_jax_layer(knob, pre_ln):
    """The layer's output and its gradients under each memory knob
    against the JAX layer under the same knob (the JAX tests
    ``test_transformer_memory_knobs`` and ``test_memory_knobs_preserve_loss``):
    2e-5 and 5e-4."""
    knobs = {k: True for k in KNOBS} if knob == "all" else {knob: True}
    kw = dict(hidden_size=32, heads=4, attn_dropout_ratio=0.0,
              hidden_dropout_ratio=0.0, pre_layer_norm=pre_ln, **knobs)
    jlayer = JLayer(**kw)
    params = jax.tree_util.tree_map(np.asarray,
                                    jlayer.init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(0).normal(size=(2, 16, 32)).astype(np.float32)
    want_out = np.asarray(jlayer.apply(params, jnp.asarray(x)))
    want = jax.grad(lambda p: jlayer.apply(p, jnp.asarray(x)).sum())(
        jax.tree_util.tree_map(jnp.asarray, params))
    tp = params_from_numpy(params, "cpu")
    for leaf in tree_leaves(tp)[1]:
        leaf.requires_grad_()
    out = TransformerLayer(**kw).apply(tp, torch.from_numpy(x))
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=2e-5,
                               rtol=2e-5)
    for path, leaf in zip(*tree_leaves(tp)):
        g_want = np.asarray(tree_leaves(want)[1][
            tree_leaves(want)[0].index(path)])
        np.testing.assert_allclose(leaf.grad.numpy(), g_want, atol=5e-4,
                                   rtol=5e-4, err_msg="/".join(path))


def bert_engine_config(extra=None):
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    config.update(extra or {})
    return config


def test_config_enables_remat_with_the_jax_engines_trajectory():
    """The ``activation_checkpointing`` block turns the model's remat on
    in both engines, and the port's trajectory follows the JAX engine's
    to rtol 1e-5 (dropout off)."""
    cfg = dict(BERT_TINY, max_predictions_per_seq=8, **BERT_OFF)
    params = bert_params(BertConfig(**cfg), 5)
    extra = {"activation_checkpointing": {"number_checkpoints": 2}}
    batches = [bert_batch(20 + i) for i in range(8)]
    jmodel = BertForPreTrainingTPU(JBert(**cfg))
    jengine, *_ = jds.initialize(
        model=jmodel, model_parameters=jax.tree_util.tree_map(
            jnp.asarray, params),
        config=bert_engine_config(extra),
        mesh=make_mesh({"data": 1}, devices=jax.devices("cpu")[:1]))
    model = BertForPreTraining(BertConfig(**cfg))
    engine, *_ = tds.initialize(model=model, model_parameters=params,
                                config=bert_engine_config(extra),
                                device="cpu")
    assert model.config.remat and jmodel.config.remat
    assert ck.get_config().number_checkpoints == 2
    it_j, it_t = iter(batches), iter(batches)
    want = [float(jengine.train_batch(it_j)) for _ in range(4)]
    got = [float(engine.train_batch(it_t)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# ------------------------------------------------ the port against itself
def count_checkpoints(monkeypatch):
    calls = []
    real = ck._torch_checkpoint

    def counting(fn, *args, **kwargs):
        calls.append(args[1].shape if len(args) > 1 else None)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(ck, "_torch_checkpoint", counting)
    return calls


@pytest.mark.parametrize("remat,number,expected", [
    (False, None, 0), (True, None, 3), (True, 2, 2), (True, 1, 1)])
def test_remat_and_number_checkpoints_drive_the_layers_recomputed(
        monkeypatch, remat, number, expected):
    """The JAX test counts remat equations in the traced program; here
    the checkpointed layers are counted: one per layer under remat,
    ``number_checkpoints`` of them when set, none without remat."""
    ck.configure(act_config=DeepSpeedActivationCheckpointingConfig(
        {"activation_checkpointing": {"number_checkpoints": number}}))
    calls = count_checkpoints(monkeypatch)
    cfg = GPT2Config(**dict(GPT2_TINY, remat=remat))
    torch_loss_and_grads(GPT2LMHead(cfg), gpt2_params(cfg, 0),
                         gpt2_batch(0), rng=3)
    assert len(calls) == expected


def run_with(model_name, changes, dropout=True, seed=11):
    """Loss and grads of a tiny model with dropout on (the port's own
    streams), with ``changes`` to its config."""
    if model_name.startswith("gpt2"):
        kw = dict(GPT2_TINY, **({} if dropout else GPT2_OFF))
        if model_name == "gpt2_sparse":
            from deepspeed_tpu_torch.ops.sparse_attention import \
                FixedSparsityConfig
            kw.update(attn_impl="sparse", sparsity_config=FixedSparsityConfig(
                num_heads=4, block=8, num_local_blocks=2,
                attention="unidirectional"))
        cfg = GPT2Config(**dict(kw, **changes))
        return torch_loss_and_grads(GPT2LMHead(cfg), gpt2_params(cfg, 1),
                                    gpt2_batch(seed), rng=seed)
    kw = dict(BERT_TINY, max_predictions_per_seq=8,
              **({} if dropout else BERT_OFF))
    cfg = BertConfig(**dict(kw, **changes))
    return torch_loss_and_grads(BertForPreTraining(cfg), bert_params(cfg, 1),
                                bert_batch(seed), rng=seed)


@pytest.mark.parametrize("model", ["gpt2", "bert", "gpt2_sparse"])
@pytest.mark.parametrize("knob", ("remat",) + KNOBS + ("all",))
def test_recompute_is_bitwise_the_run_without_it_under_dropout(model, knob):
    """Dropout on at every site: each recomputed region replays its
    generator, so loss and every gradient equal the run without it,
    bit for bit."""
    changes = ({k: True for k in ("remat",) + KNOBS} if knob == "all"
               else {knob: True})
    assert_bitwise(run_with(model, changes), run_with(model, {}))


@pytest.mark.parametrize("block", [
    {"cpu_checkpointing": True}, {"partition_activations": True},
    {"number_checkpoints": 2, "cpu_checkpointing": True}],
    ids=["cpu", "partition", "number_and_cpu"])
def test_config_knobs_are_bitwise_the_run_without_them(block):
    ck.configure(act_config=DeepSpeedActivationCheckpointingConfig(
        {"activation_checkpointing": block}))
    got = run_with("bert", {"remat": True})
    ck.configure(act_config=DeepSpeedActivationCheckpointingConfig({}))
    assert_bitwise(got, run_with("bert", {}))


def test_cpu_checkpointing_moves_the_layer_inputs_and_never_a_weight(
        monkeypatch):
    """Under ``cpu_checkpointing`` the saved-tensor hooks pack exactly
    the checkpointed layers' inputs ([b, s, h], one per layer) into host
    memory, and no parameter."""
    ck.configure(act_config=DeepSpeedActivationCheckpointingConfig(
        {"activation_checkpointing": {"cpu_checkpointing": True}}))
    packed = []
    real = ck._offload_hooks

    def recording(selected):
        hooks = real(selected)
        pack = hooks.pack_hook

        def record(t):
            out = pack(t)
            if out[0] is not None:
                packed.append((tuple(t.shape), t.is_leaf))
            return out

        hooks.pack_hook = record
        return hooks

    monkeypatch.setattr(ck, "_offload_hooks", recording)
    cfg = GPT2Config(**dict(GPT2_TINY, remat=True))
    torch_loss_and_grads(GPT2LMHead(cfg), gpt2_params(cfg, 0),
                         gpt2_batch(0), rng=3)
    assert packed == [((2, SEQ, 64), False)] * 3


def test_eval_under_remat_equals_eval_without():
    cfg = dict(GPT2_TINY, **GPT2_OFF)
    params = params_from_numpy(gpt2_params(GPT2Config(**cfg), 2), "cpu")
    ids = {"input_ids": torch.from_numpy(gpt2_batch(2)["input_ids"])}
    with torch.no_grad():
        a = GPT2LMHead(GPT2Config(**cfg)).apply(params, ids, train=False)
        b = GPT2LMHead(GPT2Config(**dict(cfg, remat=True))).apply(
            params, ids, train=False)
    assert torch.equal(a, b)


def test_engine_remat_trajectory_is_bitwise_with_dropout():
    """Four engine steps of BERT with dropout on: the config block's
    remat gives the trajectory and master of the run without it, bit
    for bit."""
    cfg = dict(BERT_TINY, max_predictions_per_seq=8)
    params = bert_params(BertConfig(**cfg), 6)
    batches = [bert_batch(40 + i) for i in range(8)]
    runs = []
    for extra in ({}, {"activation_checkpointing": {}}):
        engine, *_ = tds.initialize(
            model=BertForPreTraining(BertConfig(**cfg)),
            model_parameters=params, config=bert_engine_config(extra),
            device="cpu")
        it = iter(batches)
        losses = torch.stack([engine.train_batch(it) for _ in range(4)])
        runs.append((losses, engine.master.clone()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
