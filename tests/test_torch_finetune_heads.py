"""The port's BERT fine-tuning heads against the JAX package's.

``BertForQuestionAnsweringTPU`` (the BingBertSquad span head) and
``BertForSequenceClassificationTPU`` (GLUE) on the same JAX-initialized
weights carried across by ``params_from_numpy``, fp32, dropout off: the
loss at 2e-5 and every gradient at 5e-4 (the flash tests' tolerances),
with a padded mask, out-of-range span positions, integer and float
labels; logits at 1e-5.  Then both heads train a few engine steps on the
CPU (the JAX tests ``test_bert_qa_head_trains`` and
``test_bert_classifier_head_trains``), under remat too, and the
classifier's pooled dropout is seeded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.bert import BertConfig as JConfig
from deepspeed_tpu.models.bert import (
    BertForQuestionAnsweringTPU as JQA,
    BertForSequenceClassificationTPU as JCls)
import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import (BertConfig,
                                        BertForQuestionAnsweringTPU,
                                        BertForSequenceClassificationTPU)
from deepspeed_tpu_torch.utils.params import (params_from_numpy,
                                              params_to_numpy, tree_leaves)

TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def base_batch(seed, b=3):
    rng = np.random.RandomState(seed)
    mask = np.ones((b, SEQ), np.int64)
    mask[-1, SEQ - 11:] = 0
    return rng, {"input_ids": rng.randint(0, TINY["vocab_size"],
                                          size=(b, SEQ)),
                 "attention_mask": mask,
                 "token_type_ids": (np.arange(SEQ)[None] >= 12)
                 .repeat(b, 0).astype(np.int64)}


def qa_batch(seed, out_of_range=False):
    rng, batch = base_batch(seed)
    start = rng.randint(0, SEQ, size=3)
    end = rng.randint(0, SEQ, size=3)
    if out_of_range:   # truncated / unanswerable spans: ignored
        start[0], end[1] = SEQ + 3, -1
    batch.update(start_positions=start, end_positions=end)
    return batch


def cls_batch(seed, num_labels):
    rng, batch = base_batch(seed)
    batch["labels"] = (rng.randn(3).astype(np.float32) if num_labels == 1
                       else rng.randint(0, num_labels, size=3))
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) if v.dtype == np.float32
            else jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def jax_loss_and_grads(jmodel, params, batch):
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.apply(p, jax_batch(batch), rng=None, train=True))(
            jax.tree_util.tree_map(jnp.asarray, params))
    paths, leaves = tree_leaves(jax.tree_util.tree_map(np.asarray, grads))
    return float(loss), dict(zip(paths, leaves))


def torch_loss_and_grads(model, params, batch):
    tp = params_from_numpy(params, "cpu")
    for leaf in tree_leaves(tp)[1]:
        leaf.requires_grad_()
    loss = model.apply(tp, {k: torch.from_numpy(v) for k, v in
                            batch.items()}, rng=None, train=True)
    loss.backward()
    paths, leaves = tree_leaves(tp)
    return float(loss.detach()), {
        p: np.zeros(t.shape, np.float32) if t.grad is None
        else t.grad.numpy() for p, t in zip(paths, leaves)}


def models(name, changes=None):
    cfg = dict(TINY, **(changes or {}))
    if name == "qa":
        return JQA(JConfig(**cfg)), BertForQuestionAnsweringTPU(
            BertConfig(**cfg))
    labels = int(name.split("_")[1])
    return (JCls(JConfig(**cfg), num_labels=labels),
            BertForSequenceClassificationTPU(BertConfig(**cfg),
                                             num_labels=labels))


CASES = {
    # name: (head, batch maker, config changes)
    "qa": ("qa", lambda s: qa_batch(s), {}),
    "qa_out_of_range": ("qa", lambda s: qa_batch(s, True), {}),
    "qa_remat_pre_ln": ("qa", lambda s: qa_batch(s),
                        {"remat": True, "pre_layer_norm": True}),
    "cls_3_labels": ("cls_3", lambda s: cls_batch(s, 3), {}),
    "cls_2_labels_remat": ("cls_2", lambda s: cls_batch(s, 2),
                           {"remat": True}),
    "cls_regression": ("cls_1", lambda s: cls_batch(s, 1), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_head_loss_and_all_grads_match_jax(name):
    head, make, changes = CASES[name]
    jmodel, model = models(head, changes)
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(len(name))))
    batch = make(len(name))
    want_loss, want = jax_loss_and_grads(jmodel, params, batch)
    got_loss, got = torch_loss_and_grads(model, params, batch)
    np.testing.assert_allclose(got_loss, want_loss, atol=2e-5, rtol=2e-5)
    assert got.keys() == want.keys()
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], atol=5e-4, rtol=5e-4,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("head", ["qa", "cls_3"])
def test_logits_without_labels_match_jax(head):
    jmodel, model = models(head)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.init(jax.random.PRNGKey(9)))
    _, batch = base_batch(9)
    want = jmodel.apply(params, jax_batch(batch), train=False)
    got = model.apply(params_from_numpy(params, "cpu"),
                      {k: torch.from_numpy(v) for k, v in batch.items()},
                      train=False)
    if head == "qa":
        assert got[0].shape == got[1].shape == (3, SEQ)
        pairs = zip(got, want)
    else:
        assert got.shape == (3, 3)
        pairs = [(got, want)]
    for g, w in pairs:
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


def test_qa_needs_both_positions():
    model = BertForQuestionAnsweringTPU(BertConfig(**TINY))
    params = params_from_numpy(model.init(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in qa_batch(1).items()
             if k != "end_positions"}
    with pytest.raises(ValueError, match="end_positions"):
        model.apply(params, batch)


def test_init_has_the_jax_tree_shapes_and_carries_across_unchanged():
    """``init`` draws the JAX heads' trees (``qa_outputs``,
    ``classifier``), and ``params_from_numpy``/``params_to_numpy`` carry
    them across with their keys and values unchanged."""
    for jmodel, model in (models("qa"), models("cls_3")):
        ours = model.init(0)
        theirs = jax.tree_util.tree_map(
            np.asarray, jmodel.init(jax.random.PRNGKey(0)))
        assert [(p, x.shape, x.dtype) for p, x in zip(*tree_leaves(ours))] \
            == [(p, x.shape, x.dtype) for p, x in zip(*tree_leaves(theirs))]
        back = params_to_numpy(params_from_numpy(theirs, "cpu"))
        for (pa, a), (pb, b) in zip(zip(*tree_leaves(theirs)),
                                    zip(*tree_leaves(back))):
            assert pa == pb
            np.testing.assert_array_equal(a, b)


def test_classifier_pooled_dropout_is_seeded():
    """With dropout on, one seed gives one loss and another seed another;
    eval ignores the seed."""
    cfg = BertConfig(**dict(TINY, hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1))
    model = BertForSequenceClassificationTPU(cfg, num_labels=3)
    params = params_from_numpy(model.init(1), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in cls_batch(2, 3).items()}
    a, b, c = (float(model.apply(params, batch, rng=r, train=True))
               for r in (7, 7, 8))
    assert a == b and a != c
    assert float(model.apply(params, batch, rng=7, train=False)) == \
        float(model.apply(params, batch, rng=None, train=False))


@pytest.mark.parametrize("head", ["qa", "cls_3"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_head_trains_on_the_engine(head, remat):
    """Eight Adam steps on one batch, dropout 0.1: finite losses that
    fall (the JAX tests train the heads the same way)."""
    cfg = BertConfig(**dict(TINY, hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1, remat=remat))
    model = (BertForQuestionAnsweringTPU(cfg) if head == "qa"
             else BertForSequenceClassificationTPU(cfg, num_labels=3))
    engine, *_ = tds.initialize(
        model=model, config={"train_batch_size": 3, "steps_per_print": 10**9,
                             "optimizer": {"type": "Adam",
                                           "params": {"lr": 1e-3}}},
        device="cpu")
    batch = qa_batch(3) if head == "qa" else cls_batch(3, 3)
    losses = [float(engine.train_batch(iter([batch]))) for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
