"""Progressive Layer Drop in the port against the JAX package's.

The schedule θ(t) equals the JAX ``ProgressiveLayerDrop``'s (rtol 1e-12:
the same float64 arithmetic); the engine's θ after every step follows
the JAX engine's trace (the same schedule, moved after each optimizer
step, not each micro-batch); the model keeps or passes through each
layer by a draw from a stream of its own, so PLD at θ = 1 is bitwise
the run without it with dropout on (under remat too), θ = 0 passes every
layer through, and one seed gives one result.  The θ ∈ {0, 1} losses
and gradients against the JAX model are in ``test_torch_bert.py``.
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
from deepspeed_tpu.parallel import make_mesh
from deepspeed_tpu.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as JPLD
from deepspeed_tpu_torch.models.bert import (BertConfig, BertForPreTraining,
                                             random_params)
from deepspeed_tpu_torch.models.layers import layer_norm
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop
from deepspeed_tpu_torch.utils.params import params_from_numpy, tree_leaves

TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=4,
            num_attention_heads=4, max_position_embeddings=64,
            max_predictions_per_seq=8)
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bert_batch(seed, b=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], size=(b, SEQ))
    labels = np.full((b, SEQ), -100, np.int64)
    for r in range(b):
        pos = rng.permutation(SEQ)[:6]
        labels[r, pos] = ids[r, pos]
    mask = np.ones((b, SEQ), np.int64)
    mask[-1, SEQ - 5:] = 0
    return {"input_ids": ids, "attention_mask": mask,
            "masked_lm_labels": labels,
            "next_sentence_labels": rng.randint(0, 2, size=(b,))}


@pytest.mark.parametrize("theta,gamma", [(0.5, 0.001), (0.5, 0.1),
                                         (0.9, 0.02), (1.0, 0.001)])
def test_schedule_matches_jax(theta, gamma):
    ours, theirs = ProgressiveLayerDrop(theta, gamma), JPLD(theta, gamma)
    assert ours.get_state() == theirs.get_state()
    for step in range(0, 3000, 37):
        ours.update_state(step)
        theirs.update_state(step)
        np.testing.assert_allclose(ours.get_theta(), theirs.get_theta(),
                                   rtol=1e-12)
        assert ours.get_state() == theirs.get_state()


def test_engine_theta_trace_matches_the_jax_engine():
    """Five steps at accumulation 2 on both engines under
    ``progressive_layer_drop`` {θ̄ 0.5, γ 0.1}: θ after every step is
    the JAX engine's, and the losses are finite."""
    cfg = dict(TINY, hidden_dropout_prob=0.1,
               attention_probs_dropout_prob=0.1)
    params = random_params(BertConfig(**cfg), 2)
    config = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                         "gamma": 0.1}}
    jengine, *_ = jds.initialize(
        model=BertForPreTrainingTPU(JBert(**cfg)),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        config=dict(config),
        mesh=make_mesh({"data": 1}, devices=jax.devices("cpu")[:1]))
    engine, *_ = tds.initialize(model=BertForPreTraining(BertConfig(**cfg)),
                                model_parameters=params, config=dict(config),
                                device="cpu")
    assert engine.progressive_layer_drop_enabled() \
        and jengine.progressive_layer_drop_enabled()
    batches = [bert_batch(10 + i) for i in range(10)]
    it_j, it_t = iter(batches), iter(batches)
    thetas, want, losses = [], [], []
    for _ in range(5):
        jengine.train_batch(it_j)
        losses.append(float(engine.train_batch(it_t)))
        want.append(jengine.progressive_layer_drop.get_theta())
        thetas.append(engine.progressive_layer_drop.get_theta())
    np.testing.assert_allclose(thetas, want, rtol=1e-12)
    assert thetas[0] < 1.0 and thetas == sorted(thetas, reverse=True)
    assert np.isfinite(losses).all()


def loss_and_grads(cfg, params, batch, theta, rng=5):
    tp = params_from_numpy(params, "cpu")
    for leaf in tree_leaves(tp)[1]:
        leaf.requires_grad_()
    loss = BertForPreTraining(cfg).apply(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, rng=rng,
        train=True, pld_theta=None if theta is None else torch.tensor(theta))
    loss.backward()
    # the token-type table, which the batch does not read, has no grad
    return loss.detach(), [torch.zeros_like(t) if t.grad is None else t.grad
                           for t in tree_leaves(tp)[1]]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_theta_one_is_bitwise_the_run_without_pld(remat):
    """With dropout on: PLD's keep draws come from streams of their own,
    so at θ = 1 (and above: θ is clipped) every layer is kept and every
    dropout mask is the one drawn without PLD.  Without the MLM gather:
    PLD turns the last layer's query gather off, so there its masks are
    drawn at the full sequence's shape, not the gathered rows'."""
    cfg = BertConfig(**dict(TINY, hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1, remat=remat,
                            max_predictions_per_seq=None))
    params = random_params(cfg, 3)
    batch = bert_batch(3)
    want_loss, want = loss_and_grads(cfg, params, batch, None)
    for theta in (1.0, 1.5):
        loss, grads = loss_and_grads(cfg, params, batch, theta)
        assert torch.equal(loss, want_loss)
        assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_theta_zero_passes_every_layer_through():
    """At θ = 0 (and below) the trunk's output is its embeddings' (dropout
    off); the pooler reads that."""
    cfg = BertConfig(**dict(TINY, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0))
    model = BertForPreTraining(cfg)
    params = params_from_numpy(random_params(cfg, 4), "cpu")
    ids = torch.from_numpy(bert_batch(4)["input_ids"])
    emb = params["bert"]["embeddings"]
    want = layer_norm(emb["ln"],
                      emb["word"][ids] + emb["position"][None, :SEQ],
                      cfg.layer_norm_eps)
    for theta in (0.0, -0.5):
        seq_out, _ = model.bert.encode(params["bert"], ids, rng=5,
                                       deterministic=False,
                                       pld_theta=torch.tensor(theta))
        assert torch.equal(seq_out, want)


def test_draws_are_seeded_and_drop_some_layers():
    """At θ = 0.5 a seed gives one loss; over seeds some runs drop layers
    (the loss leaves the θ = 1 one) and differ from each other."""
    cfg = BertConfig(**dict(TINY, hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0))
    params = random_params(cfg, 5)
    batch = bert_batch(5)
    full = float(loss_and_grads(cfg, params, batch, 1.0)[0])
    losses = [float(loss_and_grads(cfg, params, batch, 0.5, rng=r)[0])
              for r in range(8)]
    again = float(loss_and_grads(cfg, params, batch, 0.5, rng=0)[0])
    assert again == losses[0]
    assert any(x != full for x in losses) and len(set(losses)) > 2
