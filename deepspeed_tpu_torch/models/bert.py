"""BERT, its pretraining head and its fine-tuning heads (port of
``deepspeed_tpu/models/bert.py``: ``BertConfig``, ``BertModel``,
``BertForPreTrainingTPU``, ``BertForQuestionAnsweringTPU``,
``BertForSequenceClassificationTPU``).

The bing_bert pretraining objective: masked-LM over a decoder tied to
the word embeddings plus next-sentence prediction on the pooled first
row.  ``apply(params, batch, rng, train)`` takes the bing_bert batch, a
dict of ``input_ids``, ``attention_mask`` (optional: 1 at visible
tokens), ``token_type_ids``, ``masked_lm_labels`` (-100 where unlabeled)
and ``next_sentence_labels``, and returns the scalar loss; an eval call
without labels returns the MLM logits.  The fine-tuning heads are the
BingBertSquad span head (start and end logits) and the GLUE-style
classifier on the pooled row.

With ``max_predictions_per_seq`` set, the MLM head gathers the first
``max_predictions_per_seq`` labeled positions of each row before the
vocab projection (unlabeled fill positions carry -100), and with the
dense attention core the last encoder layer runs at those rows and the
first only (``TransformerLayer.apply(positions=...)``); under sparse
attention or Progressive Layer Drop the encoder runs whole and the head
gathers after it, as in the JAX package.

``remat`` recomputes each layer (or ``number_checkpoints`` of them) in
backward, the last one under the MLM gather too.  Progressive Layer
Drop (``pld_theta``, the engine's keep probability θ) keeps each layer
of a training step with probability clip(θ, 0, 1) and passes its input
through otherwise: a select on a Bernoulli drawn on the device, so the
shapes stay static and the host never waits.

Parameters are a dict with the JAX package's keys
(``bert/embeddings/{word,position,token_type,ln}``,
``bert/encoder/layer_i``, ``bert/pooler``,
``cls/{transform,transform_ln,decoder_bias,seq_relationship}``,
``qa_outputs``, ``classifier``), so a JAX tree carried across by
:func:`~deepspeed_tpu_torch.utils.params.params_from_numpy` drops in.
Dropout draws from the GPT-2 port's generator streams: stream 0 drops the
embeddings, stream i+1 is layer i's, its sub-stream 17 draws layer i's
PLD keep, and stream L+1 (L layers) drops the classifier's pooled row.
"""

import numpy as np
import torch
from torch import nn

from ..runtime.activation_checkpointing import checkpointing as ds_ckpt
from .layers import (TransformerLayer, cross_entropy_with_logits, dense,
                     dropout, gelu, generator, layer_norm, mix_seed)

# the sub-stream of a layer's seed that draws its PLD keep (the JAX
# model's fold_in(layer_rng, 17)): the layer's dropout stream is not
# touched, so PLD on shifts no dropout mask
PLD_STREAM = 17


class BertConfig:
    def __init__(self, vocab_size=30528, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=None, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1, initializer_range=0.02,
                 pre_layer_norm=False, layer_norm_eps=1e-12, remat=False,
                 attn_impl="auto", sparsity_config=None,
                 gelu_checkpoint=False, attn_dropout_checkpoint=False,
                 normalize_invertible=False, max_predictions_per_seq=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.initializer_range = initializer_range
        self.pre_layer_norm = pre_layer_norm
        self.layer_norm_eps = layer_norm_eps
        self.remat = remat
        self.attn_impl = attn_impl
        self.sparsity_config = sparsity_config
        self.gelu_checkpoint = gelu_checkpoint
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.normalize_invertible = normalize_invertible
        # the MLM head gathers this many labeled positions per row (the
        # bing_bert data contract); rows with more labels lose the rest
        self.max_predictions_per_seq = max_predictions_per_seq

    @staticmethod
    def bert_base(**kw):
        return BertConfig(hidden_size=768, num_hidden_layers=12,
                          num_attention_heads=12, **kw)

    @staticmethod
    def bert_large(**kw):
        return BertConfig(hidden_size=1024, num_hidden_layers=24,
                          num_attention_heads=16, **kw)


class _Draw:
    """numpy draws shaped like the JAX package's initializers:
    normal(0, initializer_range) kernels and embeddings, zero biases,
    unit layernorm scales."""

    def __init__(self, config, seed):
        self.rng = np.random.default_rng(seed)
        self.std = np.float32(config.initializer_range)

    def normal(self, *shape):
        return self.rng.standard_normal(shape, dtype=np.float32) * self.std

    def dense(self, n_in, n_out):
        return {"kernel": self.normal(n_in, n_out),
                "bias": np.zeros((n_out,), np.float32)}

    @staticmethod
    def ln(n):
        return {"scale": np.ones((n,), np.float32),
                "bias": np.zeros((n,), np.float32)}


def _trunk_params(c, draw):
    h, inter = c.hidden_size, c.intermediate_size
    return {
        "embeddings": {"word": draw.normal(c.vocab_size, h),
                       "position": draw.normal(c.max_position_embeddings, h),
                       "token_type": draw.normal(c.type_vocab_size, h),
                       "ln": draw.ln(h)},
        "encoder": {f"layer_{i}": {"qkv": draw.dense(h, 3 * h),
                                   "attn_out": draw.dense(h, h),
                                   "fc1": draw.dense(h, inter),
                                   "fc2": draw.dense(inter, h),
                                   "ln_attn": draw.ln(h),
                                   "ln_mlp": draw.ln(h)}
                    for i in range(c.num_hidden_layers)},
        "pooler": draw.dense(h, h),
    }


def random_params(config, seed):
    """A numpy param tree of ``BertForPreTraining(config)``'s shapes and
    keys, drawn from a numpy generator seeded with ``seed``."""
    draw = _Draw(config, seed)
    h = config.hidden_size
    return {"bert": _trunk_params(config, draw),
            "cls": {"transform": draw.dense(h, h),
                    "transform_ln": draw.ln(h),
                    "decoder_bias": np.zeros((config.vocab_size,),
                                             np.float32),
                    "seq_relationship": draw.dense(h, 2)}}


def mlm_positions(labels, n_pred):
    """The first ``n_pred`` labeled positions of each row ([b, n_pred],
    int64), then the first unlabeled ones where a row has fewer labels:
    ``jax.lax.top_k`` of the 0/1 label mask, which breaks ties by the
    lower index, as a stable descending sort (``torch.topk`` promises no
    order among ties on CUDA)."""
    is_masked = (labels != -100).to(torch.int32)
    return torch.sort(is_masked, dim=1, descending=True,
                      stable=True).indices[:, :n_pred]


class BertModel:
    """Encoder trunk: embeddings, N transformer layers, the pooler."""

    def __init__(self, config):
        self.config = config
        self.layer = TransformerLayer(
            hidden_size=config.hidden_size,
            heads=config.num_attention_heads,
            intermediate_size=config.intermediate_size, causal=False,
            attn_dropout_ratio=config.attention_probs_dropout_prob,
            hidden_dropout_ratio=config.hidden_dropout_prob,
            pre_layer_norm=config.pre_layer_norm,
            initializer_range=config.initializer_range,
            layer_norm_eps=config.layer_norm_eps,
            attn_impl=config.attn_impl,
            sparsity_config=config.sparsity_config,
            gelu_checkpoint=config.gelu_checkpoint,
            attn_dropout_checkpoint=config.attn_dropout_checkpoint,
            normalize_invertible=config.normalize_invertible)

    def init(self, seed):
        """Random numpy trunk params (``random_params``' ``bert``
        subtree, drawn from its own generator)."""
        return _trunk_params(self.config, _Draw(self.config, seed))

    def encode(self, params, input_ids, attention_mask=None,
               token_type_ids=None, rng=None, deterministic=True,
               pld_theta=None, final_positions=None):
        """``(sequence output, pooled)``.  ``rng`` is an integer seed:
        stream 0 drops the embeddings and stream i+1 is layer i's
        generator, built inside the (possibly recomputed) layer.
        ``final_positions`` [b, K]: the LAST layer runs only at these rows
        (see ``TransformerLayer.apply``), so the sequence output is [b, K,
        hidden] and the pooler reads its row 0: callers put position 0
        first.  ``pld_theta`` (a 0-d tensor or a number) turns on
        Progressive Layer Drop in a training call and turns
        ``final_positions`` off: the keep-or-pass-through select needs
        one shape on both sides."""
        c = self.config
        s = input_ids.shape[1]
        emb = params["embeddings"]
        x = emb["word"][input_ids] + emb["position"][None, :s]
        if token_type_ids is not None:
            x = x + emb["token_type"][token_type_ids]
        x = layer_norm(emb["ln"], x, c.layer_norm_eps)
        train = rng is not None and not deterministic
        if train:
            x = dropout(generator(rng, 0, x.device), x,
                        c.hidden_dropout_prob, deterministic)
        if pld_theta is not None:
            final_positions = None
        pld = pld_theta is not None and train
        if pld:
            theta = torch.as_tensor(pld_theta, dtype=torch.float32,
                                    device=x.device).clamp(0.0, 1.0)

        def run_layer(lp, x, i, positions=None):
            layer_rng = generator(rng, i + 1, x.device) if train else None
            return self.layer.apply(lp, x, key_padding_mask=attention_mask,
                                    rng=layer_rng,
                                    deterministic=deterministic,
                                    positions=positions)

        ck_layer = ds_ckpt.checkpoint_wrapper(run_layer) if c.remat else None
        last = c.num_hidden_layers - 1
        for i in range(c.num_hidden_layers):
            fn = run_layer
            if ck_layer is not None and ds_ckpt.should_checkpoint_layer(
                    i, c.num_hidden_layers):
                fn = ck_layer
            y = fn(params["encoder"][f"layer_{i}"], x, i,
                   final_positions if i == last else None)
            if pld:
                # keep the layer with probability θ (jax.random.bernoulli:
                # a uniform below θ), else pass its input through
                u = torch.rand((), generator=generator(
                    mix_seed(rng, i + 1), PLD_STREAM, x.device),
                    device=x.device)
                y = torch.where(u < theta, y, x)
            x = y
        pooled = torch.tanh(dense(params["pooler"], x[:, 0]))
        return x, pooled


class BertForPreTraining(nn.Module):
    """MLM + NSP pretraining (``BertForPreTrainingTPU``) over a param
    dict: ``apply(params, batch, rng, train)`` as the JAX model's, with
    ``rng`` an integer seed (the engine's).  The compute dtype is the
    params' (the engine's bf16 compute copy under ``bf16.enabled``), so
    the JAX model's ``compute_dtype`` has no counterpart."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.bert = BertModel(config)

    def sparse_gradient_paths(self):
        """Leaves whose gradients are row-sparse (the engine's
        ``sparse_gradients``): none.  The MLM decoder ties to the word
        embeddings, so their gradient touches every vocab row, and the
        2-row token-type table cannot beat its own exchange (JAX
        ``bert.py:227-238``)."""
        return ()

    def init(self, seed):
        """Random numpy params (:func:`random_params`)."""
        return random_params(self.config, seed)

    def apply(self, params, batch, rng=None, train=True, pld_theta=None):
        c = self.config
        input_ids = batch["input_ids"]
        mlm_labels = batch.get("masked_lm_labels")
        n_pred = c.max_predictions_per_seq
        gather = bool(mlm_labels is not None and n_pred
                      and n_pred < input_ids.shape[1])
        final_positions = None
        if gather:
            pos = mlm_positions(mlm_labels, n_pred)
            mlm_labels = torch.take_along_dim(mlm_labels, pos, dim=1)
            # the last layer's query gather needs the dense bidirectional
            # core and one shape on both sides of PLD's select; else the
            # whole last layer runs and the head gathers after it
            if pld_theta is None and c.attn_impl == "auto":
                final_positions = torch.cat(
                    [torch.zeros_like(pos[:, :1]), pos], dim=1)
        seq_out, pooled = self.bert.encode(
            params["bert"], input_ids, batch.get("attention_mask"),
            batch.get("token_type_ids"), rng=rng, deterministic=not train,
            pld_theta=pld_theta, final_positions=final_positions)

        cls = params["cls"]
        head_in = seq_out
        if gather:
            head_in = (seq_out[:, 1:] if final_positions is not None
                       else torch.take_along_dim(seq_out, pos[..., None],
                                                 dim=1))
        h = gelu(dense(cls["transform"], head_in))
        h = layer_norm(cls["transform_ln"], h, c.layer_norm_eps)
        # the decoder is tied to the word embeddings
        logits = h @ params["bert"]["embeddings"]["word"].T.to(h.dtype) \
            + cls["decoder_bias"].to(h.dtype)
        if not train and mlm_labels is None:
            return logits
        loss = cross_entropy_with_logits(logits, mlm_labels)
        if "next_sentence_labels" in batch:
            nsp_logits = dense(cls["seq_relationship"], pooled)
            loss = loss + cross_entropy_with_logits(
                nsp_logits, batch["next_sentence_labels"])
        return loss


class BertForQuestionAnsweringTPU(nn.Module):
    """Extractive QA (SQuAD) head: start and end logits at every token
    (the reference's BingBertSquad model: BERT and a 2-output span
    classifier).  ``apply(params, batch, rng, train)`` takes ``input_ids``,
    ``attention_mask``, ``token_type_ids``, ``start_positions`` and
    ``end_positions`` and returns the mean of the start and end cross
    entropies; a position outside ``[0, seq)`` (a truncated or
    unanswerable span) contributes nothing.  Without positions it returns
    ``(start_logits, end_logits)``, each [b, s].  ``pld_theta`` is
    accepted and unused, as the JAX head ignores it."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        self.bert = BertModel(config)

    def sparse_gradient_paths(self):
        """The untied word and token-type embeddings: only the batch's
        token rows get gradient (JAX ``bert.py:330-333``)."""
        return ("bert/embeddings/word", "bert/embeddings/token_type")

    def init(self, seed):
        """Random numpy params: the trunk and ``qa_outputs`` [h, 2]."""
        draw = _Draw(self.config, seed)
        return {"bert": _trunk_params(self.config, draw),
                "qa_outputs": draw.dense(self.config.hidden_size, 2)}

    def apply(self, params, batch, rng=None, train=True, pld_theta=None):
        seq_out, _ = self.bert.encode(
            params["bert"], batch["input_ids"], batch.get("attention_mask"),
            batch.get("token_type_ids"), rng=rng, deterministic=not train)
        logits = dense(params["qa_outputs"], seq_out)   # [b, s, 2]
        start_logits, end_logits = logits[..., 0], logits[..., 1]
        given = ("start_positions" in batch) + ("end_positions" in batch)
        if given == 0:
            return start_logits, end_logits
        if given == 1:
            raise ValueError("QA batches must carry both start_positions "
                             "and end_positions")
        s_len = start_logits.shape[1]

        def ignore_out_of_range(pos):
            return torch.where((pos < 0) | (pos >= s_len), -100, pos)

        return 0.5 * (
            cross_entropy_with_logits(
                start_logits, ignore_out_of_range(batch["start_positions"]))
            + cross_entropy_with_logits(
                end_logits, ignore_out_of_range(batch["end_positions"])))


class BertForSequenceClassificationTPU(nn.Module):
    """Classification or regression on the pooled first row (GLUE).
    ``apply(params, batch, rng, train)`` takes ``input_ids``,
    ``attention_mask``, ``token_type_ids`` and ``labels``: integer labels
    give the cross entropy, float labels the mean squared error of the
    logits (squeezed where ``num_labels`` is 1, as STS-B).  Without labels
    it returns the [b, num_labels] logits.  In training the pooled row is
    dropped at ``hidden_dropout_prob`` first.  ``pld_theta`` is accepted
    and unused, as the JAX head ignores it."""

    def __init__(self, config, num_labels=2):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        self.bert = BertModel(config)

    def sparse_gradient_paths(self):
        """The untied word and token-type embeddings: only the batch's
        token rows get gradient (JAX ``bert.py:330-333``)."""
        return ("bert/embeddings/word", "bert/embeddings/token_type")

    def init(self, seed):
        """Random numpy params: the trunk and ``classifier`` [h,
        num_labels]."""
        draw = _Draw(self.config, seed)
        return {"bert": _trunk_params(self.config, draw),
                "classifier": draw.dense(self.config.hidden_size,
                                         self.num_labels)}

    def apply(self, params, batch, rng=None, train=True, pld_theta=None):
        c = self.config
        _, pooled = self.bert.encode(
            params["bert"], batch["input_ids"], batch.get("attention_mask"),
            batch.get("token_type_ids"), rng=rng, deterministic=not train)
        if rng is not None and train:
            pooled = dropout(generator(rng, c.num_hidden_layers + 1,
                                       pooled.device),
                             pooled, c.hidden_dropout_prob, False)
        logits = dense(params["classifier"], pooled)
        if "labels" not in batch:
            return logits
        labels = batch["labels"]
        if labels.is_floating_point():
            preds = logits[..., 0] if logits.shape[-1] == 1 else logits
            return ((preds.float() - labels.float()) ** 2).mean()
        return cross_entropy_with_logits(logits, labels)
