"""GPT-2 model family (port of ``deepspeed_tpu/models/gpt2.py``).

Decoder-only transformer with pre-layernorm blocks, causal attention and
a weight-tied LM head.  ``apply(params, batch, rng, train)`` is the
training loss of ``GPT2LMHeadTPU.apply`` (shifted labels with -100,
embedding dropout, a generator per layer, the tied head and the mean
token cross entropy); ``hidden`` and ``logits`` are its forward.
Serving and training share one block, :class:`TransformerLayer`.
Parameters are a dict with the JAX package's keys (``wte``, ``wpe``,
``blocks/layer_i/{qkv, attn_out, fc1, fc2, ln_attn, ln_mlp}``, ``ln_f``),
so a JAX tree carried across by
:func:`~deepspeed_tpu_torch.utils.params.params_from_numpy` drops in.
``attn_impl="sparse"`` with a ``sparsity_config`` runs the block-sparse
attention core (``ops/sparse_attention``) in every block, for sequences
as long as ``max_position_embeddings`` allows.  ``remat`` recomputes
each block (or ``number_checkpoints`` of them, from the
``activation_checkpointing`` config) in backward, and ``loss_chunk``
computes the LM-head loss over sequence chunks whose logits are
recomputed in backward, so the ``[b, s, vocab]`` logits are never held
whole.  ``moe_experts`` > 0 swaps the dense FFN of every
``moe_every``-th block for a routed-expert FFN (:mod:`.moe`) and adds
``moe_aux_coef`` × the blocks' mean Switch aux loss to the training
loss.  ``attn_impl="ring"`` runs the ring attention core, for sequence
parallelism.

Tensor parallelism (the current mesh's ``model`` axis): the params are
a rank's slices by :meth:`GPT2LMHead.partition_specs`; ``wte`` is
vocab-parallel, so the lookup sums the ranks' rows, the tied head makes
each rank's ``[b, s, V/m]`` slice of the logits, and the loss (whole or
chunked) takes the cross entropy over the slices without gathering them;
an eval call that returns logits gathers them whole.

Sequence parallelism (the current mesh's ``seq`` axis, any attention
core: the ring, or the gather form of the dense and sparse cores): the
model takes its data rank's whole ``[b, s]`` ids and
cuts its own chunk (:func:`~.layers.seq_chunk`), so positions and
labels are global by construction: the labels are shifted over the
whole sequence before the cut (the last position of chunk r is
labelled with the first token of chunk r+1, the global last with
-100), the ``wpe`` rows are the chunk's global positions, and the loss
(whole or chunked) is the chunk's partial sum over the global count
(:func:`~deepspeed_tpu_torch.comm.data_parallel_mean_count`).  An eval
call that returns logits gathers them over ``seq`` too.  MoE blocks
route whole sequences (:mod:`.moe`): each rank dispatches its chunk's
tokens and the aux loss counts once.
"""

import logging

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..comm import axis_size, copy_to, data_parallel_mean_count, gather_from
from ..parallel.mesh import MODEL_AXIS, SEQ_AXIS
from ..profiling.flops_profiler.profiler import named_scope
from ..runtime.activation_checkpointing import checkpointing as ds_ckpt
from ..utils.params import MODEL
from .layers import (TransformerLayer, dropout, generator, layer_norm,
                     seq_chunk, seq_offset, seq_stream_seed,
                     vocab_parallel_cross_entropy, vocab_parallel_embedding,
                     vocab_parallel_nll_sum)
from .moe import MoETransformerLayer

logger = logging.getLogger(__name__)


class GPT2Config:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_position_embeddings=1024,
                 embd_dropout=0.1, attn_dropout=0.1, resid_dropout=0.1,
                 initializer_range=0.02, layer_norm_eps=1e-5, remat=False,
                 attn_impl="auto", sparsity_config=None,
                 gelu_checkpoint=False, attn_dropout_checkpoint=False,
                 normalize_invertible=False, moe_experts=0, moe_every=2,
                 moe_k=2, moe_capacity_factor=1.25, moe_aux_coef=0.01,
                 loss_chunk=0):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_position_embeddings = max_position_embeddings
        self.embd_dropout = embd_dropout
        self.attn_dropout = attn_dropout
        self.resid_dropout = resid_dropout
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.remat = remat
        self.attn_impl = attn_impl
        self.sparsity_config = sparsity_config
        self.gelu_checkpoint = gelu_checkpoint
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.normalize_invertible = normalize_invertible
        self.moe_experts = moe_experts
        self.moe_every = moe_every
        self.moe_k = moe_k
        self.moe_capacity_factor = moe_capacity_factor
        self.moe_aux_coef = moe_aux_coef
        self.loss_chunk = loss_chunk

    @staticmethod
    def gpt2_small(**kw):
        return GPT2Config(hidden_size=768, num_layers=12, num_heads=12, **kw)

    @staticmethod
    def gpt2_medium(**kw):
        """GPT-2 345M (BASELINE config #3)."""
        return GPT2Config(hidden_size=1024, num_layers=24, num_heads=16, **kw)

    @staticmethod
    def gpt2_large(**kw):
        return GPT2Config(hidden_size=1280, num_layers=36, num_heads=20, **kw)

    @staticmethod
    def gpt2_xl(**kw):
        """GPT-2 1.5B (BASELINE config #4)."""
        return GPT2Config(hidden_size=1600, num_layers=48, num_heads=25, **kw)


def random_params(config, seed):
    """A numpy param tree of ``config``'s shapes, drawn the way the JAX
    package initializes (normal(0, initializer_range) kernels and
    embeddings, zero biases, unit layernorm scales) from a numpy
    generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    c = config
    h, inter = c.hidden_size, 4 * c.hidden_size

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(c.initializer_range)

    def dense_p(n_in, n_out):
        return {"kernel": normal(n_in, n_out),
                "bias": np.zeros((n_out,), np.float32)}

    def ln_p():
        return {"scale": np.ones((h,), np.float32),
                "bias": np.zeros((h,), np.float32)}

    def block(i):
        p = {"qkv": dense_p(h, 3 * h), "attn_out": dense_p(h, h)}
        if is_moe_layer(c, i):
            E = c.moe_experts
            p["moe"] = {"router": {"kernel": normal(h, E)},
                        "fc1": {"kernel": normal(E, h, inter),
                                "bias": np.zeros((E, inter), np.float32)},
                        "fc2": {"kernel": normal(E, inter, h),
                                "bias": np.zeros((E, h), np.float32)}}
        else:
            p["fc1"] = dense_p(h, inter)
            p["fc2"] = dense_p(inter, h)
        p["ln_attn"], p["ln_mlp"] = ln_p(), ln_p()
        return p

    return {
        "wte": normal(c.vocab_size, h),
        "wpe": normal(c.max_position_embeddings, h),
        "blocks": {f"layer_{i}": block(i) for i in range(c.num_layers)},
        "ln_f": ln_p(),
    }


def is_moe_layer(config, i):
    """Whether block ``i`` is a MoE block: every ``moe_every``-th, the
    last of each group (JAX ``gpt2.py:97-99``)."""
    c = config
    return bool(c.moe_experts) and i % c.moe_every == c.moe_every - 1


class GPT2LMHead(nn.Module):
    """GPT-2 LM head over a param dict.

    ``apply(params, batch, rng, train)`` gives the training loss (or the
    logits, for an eval batch without labels); ``hidden(params,
    input_ids)`` and ``logits(params, input_ids)`` take the param dict
    as the JAX model's methods do; ``forward(input_ids)`` uses the dict
    given at construction.  Attention goes through
    :func:`~deepspeed_tpu_torch.ops.transformer.attention.dot_product_attention`
    (or, under ``attn_impl="sparse"``, the block-sparse core), so on CUDA
    it runs the flash kernels, forward and backward."""

    def __init__(self, config, params=None):
        super().__init__()
        c = config
        self.config = config
        self.params = params
        self.layer = TransformerLayer(
            hidden_size=c.hidden_size, heads=c.num_heads, causal=True,
            attn_dropout_ratio=c.attn_dropout,
            hidden_dropout_ratio=c.resid_dropout, pre_layer_norm=True,
            initializer_range=c.initializer_range,
            layer_norm_eps=c.layer_norm_eps, attn_impl=c.attn_impl,
            sparsity_config=c.sparsity_config,
            gelu_checkpoint=c.gelu_checkpoint,
            attn_dropout_checkpoint=c.attn_dropout_checkpoint,
            normalize_invertible=c.normalize_invertible)
        self.moe_layer = None
        if c.moe_experts:
            self.moe_layer = MoETransformerLayer(
                hidden_size=c.hidden_size, heads=c.num_heads,
                num_experts=c.moe_experts, causal=True, k=c.moe_k,
                capacity_factor=c.moe_capacity_factor,
                attn_dropout_ratio=c.attn_dropout,
                hidden_dropout_ratio=c.resid_dropout,
                initializer_range=c.initializer_range,
                layer_norm_eps=c.layer_norm_eps, attn_impl=c.attn_impl,
                sparsity_config=c.sparsity_config,
                gelu_checkpoint=c.gelu_checkpoint,
                attn_dropout_checkpoint=c.attn_dropout_checkpoint,
                normalize_invertible=c.normalize_invertible)
        self._last_moe_aux = None

    def partition_specs(self, mesh=None):
        """The port's slicing of the params over ``model`` and
        ``expert`` (JAX ``gpt2.py:143-157``): ``wte`` vocab-parallel,
        each block's :meth:`TransformerLayer.partition_specs` (or the MoE
        block's), the rest replicated."""
        c = self.config
        layer = TransformerLayer.partition_specs()
        moe = MoETransformerLayer.partition_specs()
        return {"wte": (MODEL, None), "wpe": (None, None),
                "blocks": {f"layer_{i}": moe if is_moe_layer(c, i)
                           else layer for i in range(c.num_layers)},
                "ln_f": {"scale": (None,), "bias": (None,)}}

    def sparse_gradient_paths(self):
        """Leaves whose gradients are row-sparse (the engine's
        ``sparse_gradients``): none.  ``wte`` ties to the LM head, whose
        backward touches every vocab row, and every ``wpe`` row is
        touched each step (JAX ``gpt2.py:133-141``)."""
        return ()

    def init(self, seed):
        """Random numpy params (:func:`random_params`)."""
        return random_params(self.config, seed)

    def block(self, lp, x, rng=None, deterministic=True, attn_seed_rng=None):
        """One pre-LN transformer block (``TransformerLayer.apply``)."""
        return self.layer.apply(lp, x, rng=rng, deterministic=deterministic,
                                attn_seed_rng=attn_seed_rng)

    def hidden(self, params, input_ids, rng=None, deterministic=True):
        """Trunk + final layernorm -> [b, s, hidden] (under ``seq``, this
        rank's chunk of the whole ``[b, s]`` ids: [b, s/N, hidden]).
        ``rng`` is an integer seed: stream 0 drops the embeddings and
        stream i+1 is layer i's generator, built inside the (possibly
        recomputed) layer so a recompute draws the forward's masks."""
        c = self.config
        ids = seq_chunk(input_ids)
        p0 = seq_offset(input_ids.shape[1])
        x = vocab_parallel_embedding(params["wte"], ids) \
            + params["wpe"][None, p0:p0 + ids.shape[1]]
        train = rng is not None and not deterministic
        # the layers' streams before and after the seq mixing: under seq
        # the dense core draws its seed words from the first, every seq
        # rank alike
        step_rng, rng = rng, seq_stream_seed(rng)
        seq = axis_size(SEQ_AXIS) > 1
        if train:
            x = dropout(generator(rng, 0, x.device), x, c.embd_dropout,
                        deterministic)

        def run_layer(lp, x, i):
            layer_rng = generator(rng, i + 1, x.device) if train else None
            seed_rng = (generator(step_rng, i + 1, x.device)
                        if train and seq else None)
            if is_moe_layer(c, i):
                return self.moe_layer.apply(lp, x, rng=layer_rng,
                                            deterministic=deterministic,
                                            attn_seed_rng=seed_rng)
            return self.block(lp, x, layer_rng, deterministic, seed_rng)

        ck_layer = ds_ckpt.checkpoint_wrapper(run_layer) if c.remat else None
        aux = []
        for i in range(c.num_layers):
            fn = run_layer
            if ck_layer is not None and ds_ckpt.should_checkpoint_layer(
                    i, c.num_layers):
                fn = ck_layer
            # the JAX model's scope names (the flops profiler's table)
            with named_scope(f"layer_{i}_moe" if is_moe_layer(c, i)
                             else f"layer_{i}"):
                x = fn(params["blocks"][f"layer_{i}"], x, i)
            if is_moe_layer(c, i):
                x, a = x
                aux.append(a)
        self._last_moe_aux = sum(aux) / len(aux) if aux else None
        return layer_norm(params["ln_f"], x, c.layer_norm_eps)

    @staticmethod
    def _lm_head(params, x):
        """The tied LM head: under ``model`` this rank's ``[b, s, V/m]``
        slice of the logits."""
        return copy_to(x, MODEL_AXIS) @ params["wte"].T.to(x.dtype)

    def logits(self, params, input_ids, rng=None, deterministic=True):
        """The whole ``[b, s, vocab]`` logits (gathered over ``model``
        and ``seq``)."""
        return _whole_logits(self._lm_head(params, self.hidden(
            params, input_ids, rng, deterministic)))

    @staticmethod
    def _chunked_lm_loss(params, x, labels, chunk):
        """The tied LM head and the mean token cross entropy over
        sequence chunks of ``chunk`` positions (the JAX model's
        ``_chunked_lm_loss``, ``gpt2.py:229-258``).  Each chunk's
        ``[b, chunk, vocab]`` logits live only inside one checkpointed
        piece, which backward recomputes, so the full logits and their
        fp32 copy are never held: the largest tensors of the step."""
        w = params["wte"]
        x = copy_to(x, MODEL_AXIS)

        def one(xc, lc):
            return vocab_parallel_nll_sum(xc @ w.T.to(xc.dtype), lc)[0]

        total = sum(checkpoint(one, xc, lc, use_reentrant=False)
                    for xc, lc in zip(x.split(chunk, dim=1),
                                      labels.split(chunk, dim=1)))
        return total / data_parallel_mean_count((labels != -100).sum())

    def apply(self, params, batch, rng=None, train=True, pld_theta=None):
        """Training loss of ``batch`` (``{"input_ids"[, "labels"]}`` or
        the ids alone); labels default to the ids shifted left with -100
        at the end.  An eval call (``train=False``) without labels returns
        the logits.  Under ``loss_chunk`` the loss is the chunked head's,
        where the chunk divides the sequence; where it does not, the
        full-logits loss, with a warning, as in the JAX model.
        ``pld_theta`` (the engine's Progressive Layer Drop) is accepted
        and unused, as the JAX model ignores it."""
        c = self.config
        input_ids = batch["input_ids"] if isinstance(batch, dict) else batch
        has_labels = isinstance(batch, dict) and "labels" in batch
        want_logits = not train and not has_labels
        chunk = c.loss_chunk
        x = self.hidden(params, input_ids, rng=rng, deterministic=not train)
        if want_logits:
            return _whole_logits(self._lm_head(params, x))
        use_chunked = bool(chunk and x.shape[1] % chunk == 0)
        if chunk and not use_chunked:
            logger.warning(
                "loss_chunk=%s does not divide seq %s: falling back to the "
                "FULL-logits loss (the [b, s, vocab] tensor this knob exists "
                "to avoid WILL be materialized); pick a divisor",
                chunk, x.shape[1])
        if has_labels:
            labels = batch["labels"]
        else:
            labels = torch.cat(
                [input_ids[:, 1:], torch.full((input_ids.shape[0], 1), -100,
                                              dtype=input_ids.dtype,
                                              device=input_ids.device)],
                dim=1)
        # shifted over the whole sequence, then this seq rank's chunk
        labels = seq_chunk(labels)
        if use_chunked:
            loss = self._chunked_lm_loss(params, x, labels, int(chunk))
        else:
            loss = vocab_parallel_cross_entropy(self._lm_head(params, x),
                                                labels, ignore_index=-100)
        if train and self._last_moe_aux is not None:
            # the Switch load-balancing loss, a training-only regularizer
            # (JAX gpt2.py:291-294)
            loss = loss + c.moe_aux_coef * self._last_moe_aux
        return loss

    def forward(self, input_ids):
        return self.logits(self.params, input_ids)


def _whole_logits(logits):
    """A rank's ``[b, s/N, V/m]`` logits gathered over ``model`` (vocab)
    and ``seq`` (positions): the whole ``[b, s, V]``."""
    return gather_from(gather_from(logits, MODEL_AXIS), SEQ_AXIS, dim=1)
