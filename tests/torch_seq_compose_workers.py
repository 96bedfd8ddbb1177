"""The rank functions of the port's sequence-parallel composition tests
(``tests/test_torch_seq_compose.py``).

Each runs on one gloo rank of :func:`tests.torch_dist.run_ranks` (this
module imports neither jax nor the JAX package) and returns numpy arrays
and plain values.  The inputs are made here from numpy seeds, so the
parent test makes the same ones and holds the results against the JAX
package on the same mesh.
"""

import numpy as np
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.bert import (BertConfig,
                                             BertForPreTraining,
                                             BertForQuestionAnsweringTPU,
                                             BertForSequenceClassificationTPU)
from deepspeed_tpu_torch.models.bert import random_params as bert_params
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHead,
                                             random_params)
from deepspeed_tpu_torch.models.layers import (TransformerLayer,
                                               cross_entropy_with_logits)
from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
from deepspeed_tpu_torch.parallel import make_mesh
from deepspeed_tpu_torch.runtime.pipe import (LayerSpec, PipelineModule,
                                              TiedLayerSpec)

from . import torch_pipe_workers as P
from .torch_seq_workers import (ADAM, BERT_TINY, LAMB, ROWS, SEQ, STEPS,
                                TINY, bert_batches, config, engine,
                                gpt2_batches, train, whole_master)

WORLD = 4
# the sparse core's layout: 16-row blocks of the 64-position sequence,
# two block rows a seq rank
SPARSE = dict(num_heads=TINY["num_heads"], block=16,
              attention="unidirectional")
MOE = dict(moe_experts=4, moe_every=2, moe_k=2)
# tests/torch_tp_workers.py's 1-bit Adam, without clipping (it binds on
# the warmup only): 3 dense steps, then the compressed ones
ONEBIT = {"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": 3}}
# the fine-tuning heads: every rank keeps its data rank's rows
HEAD_LABELS = 3
# the pipeline stacks: the GPT-like one of tests/torch_pipe_workers.py
# (4 positions) and one with a port TransformerLayer on each stage (8)
PIPE_HEADS = 2
PIPE_LAYER = dict(causal=True, attn_dropout_ratio=0.0,
                  hidden_dropout_ratio=0.0, pre_layer_norm=True)
PIPE_WIDTH = {"gpt": 4, "attn": 8}
# a share of the labels -100, so the seq chunks count different numbers
IGNORED = 0.3


def gpt2(attn_impl="auto", sparse=False, **kw):
    extra = dict(attn_impl="sparse" if sparse else attn_impl, **kw)
    if sparse:
        extra["sparsity_config"] = FixedSparsityConfig(**SPARSE)
    cfg = GPT2Config(**dict(TINY, **extra))
    return GPT2LMHead(cfg), random_params(cfg, 0)


def bert_config():
    return BertConfig(**dict(BERT_TINY, attn_impl="auto"))


def head_params(seed=3):
    """The fine-tuning heads' whole params: the pretraining trunk's draw
    and a head kernel from a numpy seed."""
    trunk = bert_params(bert_config(), seed)["bert"]
    rng = np.random.default_rng(seed + 1)
    h = BERT_TINY["hidden_size"]

    def head(n):
        return {"kernel": (rng.standard_normal((h, n)) * 0.02)
                .astype(np.float32), "bias": np.zeros((n,), np.float32)}

    return {"qa": {"bert": trunk, "qa_outputs": head(2)},
            "cls": {"bert": trunk, "classifier": head(HEAD_LABELS)}}


def head_batches(kind, n, seed=4, rows=ROWS):
    """QA (span positions, one out of range) or classification batches
    with a padded last row."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = np.ones((rows, SEQ), np.int32)
        mask[-1, SEQ - 10:] = 0
        batch = {"input_ids": rng.integers(0, BERT_TINY["vocab_size"],
                                           size=(rows, SEQ)).astype(np.int32),
                 "attention_mask": mask,
                 "token_type_ids": (np.arange(SEQ)[None] >= SEQ // 2)
                 .repeat(rows, 0).astype(np.int32)}
        if kind == "qa":
            start = rng.integers(0, SEQ, size=rows).astype(np.int32)
            end = rng.integers(0, SEQ, size=rows).astype(np.int32)
            start[0] = SEQ + 3
            batch.update(start_positions=start, end_positions=end)
        else:
            batch["labels"] = rng.integers(0, HEAD_LABELS,
                                           size=rows).astype(np.int32)
        out.append(batch)
    return out


def head_model(kind):
    return (BertForQuestionAnsweringTPU(bert_config()) if kind == "qa"
            else BertForSequenceClassificationTPU(bert_config(),
                                                  num_labels=HEAD_LABELS))


def attention_specs():
    """Embedding, then (TransformerLayer, Linear) twice, then the tied
    head: a port attention layer on each of two uniform stages."""
    def block():
        return [LayerSpec(TransformerLayer, P.HIDDEN, PIPE_HEADS,
                          **PIPE_LAYER), LayerSpec(P.Linear, P.HIDDEN,
                                                   P.HIDDEN)]
    return ([TiedLayerSpec("emb", P.Embed, P.VOCAB, P.HIDDEN,
                           tied_weight_attr="table")]
            + block() + block()
            + [TiedLayerSpec("emb", P.Embed, P.VOCAB, P.HIDDEN,
                             forward_fn=P.lm_head, tied_weight_attr="table")])


def pipe_data(kind, seed=0):
    """The stack's micro-batches: token ids and next-token labels with
    about ``IGNORED`` of them -100."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(P.MICRO_BATCHES):
        x, y = (rng.integers(0, P.VOCAB, size=(P.MB_SIZE, PIPE_WIDTH[kind]))
                .astype(np.int32) for _ in range(2))
        y[rng.random(y.shape) < IGNORED] = -100
        out.append((x, y))
    return out


def _run(model, params, cfg, mesh, batches):
    eng = engine(model, params, cfg, mesh)
    return {"losses": train(eng, batches), "master": whole_master(eng)}


# ----------------------------------------------------------- engines
def compose_world(rank, world, seed, pipe_weights):
    """Every engine case on one world of 4 ranks (see the parent
    tests)."""
    out = {}
    d2s2 = make_mesh({"data": 2, "seq": 2})
    cfg = config(ADAM, dp=2)
    out["gpt2_dense"] = _run(*gpt2(), cfg, d2s2, gpt2_batches(STEPS))
    out["gpt2_attn_dropout"] = _run(*gpt2(attn_dropout=0.1), cfg, d2s2,
                                    gpt2_batches(STEPS))
    comm.counter.reset()
    out["gpt2_sparse"] = _run(*gpt2(sparse=True), cfg, d2s2,
                              gpt2_batches(STEPS))
    out["bert_dense"] = _run(BertForPreTraining(bert_config()),
                             bert_params(bert_config(), 3),
                             config(LAMB, stage=1, dp=2), d2s2,
                             bert_batches(STEPS))
    heads = head_params()
    for kind in ("qa", "cls"):
        out[f"bert_{kind}"] = _run(head_model(kind), heads[kind],
                                   config(ADAM, stage=1, dp=2), d2s2,
                                   head_batches(kind, STEPS))
        eng = engine(head_model(kind), heads[kind], config(ADAM, dp=2),
                     d2s2)
        batch = head_batches(kind, 1, seed=9)[0]
        dr = eng.dp_rank
        rows = {k: v[dr * 2:(dr + 1) * 2] for k, v in batch.items()
                if k in ("input_ids", "attention_mask", "token_type_ids")}
        got = eng.eval_batch(rows)
        out[f"bert_{kind}"]["eval"] = [np.asarray(t) for t in (
            got if isinstance(got, tuple) else (got,))]
    out["sgrad"] = _run(head_model("qa"), heads["qa"],
                        config(ADAM, stage=0, dp=2, sparse_gradients=True),
                        d2s2, head_batches("qa", STEPS))
    out["onebit"] = _run(*gpt2(), config(ONEBIT, stage=0, dp=2, clip=0.0),
                         d2s2, gpt2_batches(STEPS))
    out["moe_d2s2"] = _run(*gpt2(**MOE), cfg, d2s2, gpt2_batches(STEPS))
    e2s2 = make_mesh({"expert": 2, "seq": 2})
    out["moe_e2s2"] = _run(*gpt2(**MOE), config(ADAM), e2s2,
                           gpt2_batches(STEPS))
    out["pipe"] = {}
    specs = {"gpt": P.gpt_like_specs, "attn": attention_specs}
    for kind in ("gpt", "attn"):
        for name, dims, dp in (("p2s2", {"pipe": 2, "seq": 2}, 1),
                               ("p2d2", {"pipe": 2, "data": 2}, 2)):
            module = PipelineModule(specs[kind](),
                                    loss_fn=cross_entropy_with_logits,
                                    partition_method="uniform")
            eng, *_ = tds.initialize(model=module,
                                     model_parameters=pipe_weights[kind],
                                     config=P.config(dp),
                                     mesh=make_mesh(dims), device="cpu")
            out["pipe"][f"{kind}_{name}"] = {
                "losses": P.train(eng, pipe_data(kind))}
    return out


def dense_data2(rank, world, seed):
    """The GPT-2 dense core at ``{data: 2}`` (two ranks), under Adam
    (without and with attention dropout) and under 1-bit Adam: the runs
    the ``{data: 2, seq: 2}`` ones must match."""
    mesh = make_mesh({"data": 2})
    return {"adam": _run(*gpt2(), config(ADAM, dp=2), mesh,
                         gpt2_batches(STEPS)),
            "attn_dropout": _run(*gpt2(attn_dropout=0.1),
                                 config(ADAM, dp=2), mesh,
                                 gpt2_batches(STEPS)),
            "onebit": _run(*gpt2(), config(ONEBIT, stage=0, dp=2,
                                           clip=0.0), mesh,
                           gpt2_batches(STEPS))}


# ------------------------------------------------------------- the op
def seq_rows_of(x, n, r):
    """Rank ``r`` of ``n``'s chunk along dim 1."""
    sl = x.shape[1] // n
    return x[:, r * sl:(r + 1) * sl]


def torch_inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, h, d))
                             .astype(np.float32)) for _ in range(4)]

