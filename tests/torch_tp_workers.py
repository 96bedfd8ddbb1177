"""The rank functions of the port's tensor- and expert-parallel tests.

Each runs on one gloo rank of :func:`tests.torch_dist.run_ranks` (this
module imports neither jax nor the JAX package) and returns numpy
arrays and plain values.  The inputs are made here from numpy seeds, so
the parent test makes the same ones with the same helpers and holds the
results against the JAX engine on the same mesh, or against the port at
one rank.
"""

import os
import sys

import numpy as np

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining
from deepspeed_tpu_torch.models.bert import random_params as bert_params
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.parallel import make_mesh
from deepspeed_tpu_torch.utils.params import tree_leaves
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ck

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))
import train_torch_pipe as pipe_example  # noqa: E402

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)
MOE = dict(moe_experts=4, moe_every=2, moe_k=2)
BERT_TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=64, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0, max_predictions_per_seq=6)
DROPOUT = dict(embd_dropout=0.1, attn_dropout=0.1, resid_dropout=0.1)
ROWS = 4          # rows of a global batch
SEQ = 32
STEPS = 5
RESUME_STEPS = 2
# a clip that binds on the tiny models; Adam's eps keeps it visible
CLIP = 0.05
ADAM = {"type": "Adam", "params": {"lr": 3e-3, "eps": 1e-3}}
LAMB = {"type": "Lamb", "params": {"lr": 3e-3}}
# GPT-2 as a pipeline (the example's layers) over 2 stages
PIPE_MICRO_BATCHES = 2


def config(opt, stage=2, dp=1, clip=CLIP, **extra):
    cfg = {"train_batch_size": ROWS,
           "train_micro_batch_size_per_gpu": ROWS // dp,
           "gradient_clipping": clip, "steps_per_print": 10 ** 9,
           "optimizer": dict(opt), "zero_optimization": {"stage": stage}}
    cfg.update(extra)
    return cfg


def gpt2_batches(n, seed=1, rows=ROWS):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, TINY["vocab_size"],
                                       size=(rows, SEQ)).astype(np.int32)}
            for _ in range(n)]


def bert_batches(n, seed=2, rows=ROWS):
    """BERT pretraining batches with a few MLM labels a row and a padded
    last row (the MLM gather path: the last layer at the labeled rows)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, BERT_TINY["vocab_size"],
                           size=(rows, SEQ)).astype(np.int32)
        labels = np.full((rows, SEQ), -100, np.int32)
        for r in range(rows):
            pos = rng.permutation(SEQ)[:2 + r]
            labels[r, pos] = ids[r, pos]
        mask = np.ones((rows, SEQ), np.int32)
        mask[-1, SEQ - 5:] = 0
        out.append({"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": (np.arange(SEQ)[None] >= SEQ // 2)
                    .repeat(rows, 0).astype(np.int32),
                    "masked_lm_labels": labels,
                    "next_sentence_labels": rng.integers(0, 2, size=rows)
                    .astype(np.int32)})
    return out


def rank_rows(batch, dp_rank, dp):
    """A data rank's contiguous rows of a global batch."""
    def cut(x):
        per = x.shape[0] // dp
        return x[dp_rank * per:(dp_rank + 1) * per]

    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return type(batch)(cut(v) for v in batch)


def gpt2(**kw):
    cfg = GPT2Config(**dict(TINY, **kw))
    return GPT2LMHead(cfg), random_params(cfg, 0)


def bert():
    cfg = BertConfig(**BERT_TINY)
    return BertForPreTraining(cfg), bert_params(cfg, 3)


def engine(model, params, cfg, mesh=None):
    eng, *_ = tds.initialize(model=model, model_parameters=params,
                             config=cfg, mesh=mesh, device="cpu")
    return eng


def train(eng, batches, steps=STEPS):
    dp, r = eng.dp_world_size, eng.dp_rank
    it = iter([rank_rows(b, r, dp) for b in batches])
    return [float(eng.train_batch(it)) for _ in range(steps)]


def whole_master(eng):
    """The whole model's unpadded master (a collective)."""
    return eng._gather_unpadded(eng.master)


def replicated_leaves(eng):
    """This rank's master leaves that no axis cuts, by path (the data
    ranks' rows gathered: a collective)."""
    params = eng.flat.unflatten_params(eng.flat.canonical_master(eng.master))
    paths, leaves = tree_leaves(params)
    return {"/".join(map(str, p)): leaf.detach().numpy().copy()
            for p, leaf, spec in zip(paths, leaves, eng._leaf_specs)
            if not spec or all(e is None for e in spec)}


# ------------------------------------------------------------ model = 2
def model2_world(rank, world, seed, save_dir, jax_dir):
    """Every ``{model: 2}`` case on one world of 2 ranks."""
    mesh = make_mesh({"model": world})
    out = {}
    for name, opt in (("adam", ADAM), ("lamb", LAMB)):
        model, params = gpt2()
        eng = engine(model, params, config(opt), mesh)
        out[name] = {"losses": train(eng, gpt2_batches(STEPS)),
                     "master": whole_master(eng),
                     "replicated": replicated_leaves(eng)}
        if name == "adam":
            eng.save_checkpoint(save_dir, sync=True)
            eng.wait_checkpoint(save_dir)
            ids = gpt2_batches(1, seed=9)[0]
            out["eval_logits"] = eng.eval_batch(ids).numpy()
    # ZeRO-3 composes: each rank's flat is its own slices
    model, params = gpt2()
    eng = engine(model, params, config(ADAM, stage=3), mesh)
    out["zero3"] = {"losses": train(eng, gpt2_batches(STEPS)),
                    "master": whole_master(eng)}
    model, params = bert()
    eng = engine(model, params, config(LAMB, stage=1), mesh)
    out["bert"] = {"losses": train(eng, bert_batches(STEPS)),
                   "master": whole_master(eng),
                   "eval": float(eng.eval_batch(bert_batches(1, seed=5)[0])),
                   "logits": eng.eval_batch({
                       k: v for k, v in bert_batches(1, seed=6)[0].items()
                       if k != "masked_lm_labels"}).numpy()}
    model, params = gpt2(**DROPOUT)
    eng = engine(model, params, config(ADAM), mesh)
    out["dropout"] = train(eng, gpt2_batches(STEPS))
    model, params = gpt2(loss_chunk=8)
    eng = engine(model, params, config(ADAM), mesh)
    out["chunk"] = train(eng, gpt2_batches(STEPS))
    out["remat"] = {}
    for part in (False, True):
        ck.partition_stats.update(full_bytes=0, kept_bytes=0)
        model, params = gpt2(remat=True, **DROPOUT)
        eng = engine(model, params, config(
            ADAM, activation_checkpointing={
                "partition_activations": part}), mesh)
        out["remat"][part] = {"losses": train(eng, gpt2_batches(STEPS)),
                              "master": whole_master(eng),
                              "stats": dict(ck.partition_stats)}
    # the JAX engine's checkpoint at model 2, then two more steps
    model, params = gpt2()
    eng = engine(model, params, config(ADAM), mesh)
    eng.load_checkpoint(jax_dir, strict=True)
    out["resumed"] = {"master": whole_master(eng),
                      "losses": train(eng, gpt2_batches(
                          RESUME_STEPS, seed=4), RESUME_STEPS)}
    return out


# ---------------------------------------------- data x model, pipe x model
def pipe_module():
    cfg = GPT2Config(**TINY)
    return pipe_example.gpt2_pipeline_module(cfg), cfg


def pipe_params():
    model, params = gpt2()
    return pipe_example.pipe_params_from_gpt2(params)


def pipe_batches(seed=1):
    """``PIPE_MICRO_BATCHES`` micro-batches of ``(ids, labels)``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"],
                       size=(ROWS, SEQ)).astype(np.int64)
    labels = np.concatenate([ids[:, 1:], np.full((ROWS, 1), -100)], 1)
    per = ROWS // PIPE_MICRO_BATCHES
    return [(ids[i * per:(i + 1) * per], labels[i * per:(i + 1) * per])
            for i in range(PIPE_MICRO_BATCHES)]


def pipe_config(opt=ADAM, stage=1):
    return {"train_micro_batch_size_per_gpu": ROWS // PIPE_MICRO_BATCHES,
            "gradient_accumulation_steps": PIPE_MICRO_BATCHES,
            "gradient_clipping": CLIP, "steps_per_print": 10 ** 9,
            "optimizer": dict(opt), "zero_optimization": {"stage": stage}}


def data_pipe_world(rank, world, seed, save_dir):
    """``{data: 2, model: 2}`` GPT-2 (Adam, Lamb) and ``pipe 2 x model
    2`` GPT-2 on one world of 4 ranks; the pipeline's checkpoint goes to
    ``save_dir``."""
    out = {}
    mesh = make_mesh({"data": 2, "model": 2})
    for name, opt in (("adam", ADAM), ("lamb", LAMB)):
        model, params = gpt2()
        eng = engine(model, params, config(opt, dp=2), mesh)
        out[name] = {"losses": train(eng, gpt2_batches(STEPS)),
                     "master": whole_master(eng)}
    mesh = make_mesh({"pipe": 2, "model": 2})
    module, _ = pipe_module()
    eng, *_ = tds.initialize(model=module, model_parameters=pipe_params(),
                             config=pipe_config(), mesh=mesh, device="cpu")
    out["pipe"] = {"losses": [float(eng.train_batch(iter(pipe_batches())))
                              for _ in range(STEPS)],
                   "master": eng._gather_unpadded(eng.master)}
    eng.save_checkpoint(save_dir, sync=True)
    eng.wait_checkpoint(save_dir)
    return out


def moe_world(rank, world, seed):
    """The MoE GPT-2 at ``{data: 2, expert: 2}`` and ``{expert: 2,
    model: 2}`` on one world of 4 ranks."""
    out = {}
    for name, dims in (("moe_data", {"data": 2, "expert": 2}),
                       ("moe_model", {"expert": 2, "model": 2})):
        mesh = make_mesh(dims)
        model, params = gpt2(**MOE)
        eng = engine(model, params, config(ADAM, dp=dims.get("data", 1)),
                     mesh)
        out[name] = {"losses": train(eng, gpt2_batches(STEPS)),
                     "master": whole_master(eng),
                     "replicated": replicated_leaves(eng)}
    return out


# ------------------------------ the sparse core, 1-bit Adam and
# sparse_gradients above one model rank
SPARSE_SEQ = 64
# one global pattern a head: a per-head layout, which each model rank
# cuts to its heads' rows
SPARSE_LAYOUT = dict(num_heads=TINY["num_heads"], block=8,
                     different_layout_per_head=True, num_local_blocks=4,
                     num_global_blocks=1, num_different_global_patterns=4,
                     attention="unidirectional")
ONEBIT = {"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": 3}}
ONEBIT_STEPS = 6


def sparse_gpt2(**kw):
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    return gpt2(attn_impl="sparse",
                sparsity_config=FixedSparsityConfig(**SPARSE_LAYOUT), **kw)


def sparse_batches(n, seed=1, rows=ROWS):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, TINY["vocab_size"],
                                       size=(rows, SPARSE_SEQ))
             .astype(np.int32)} for _ in range(n)]


def sparse_model2_world(rank, world, seed):
    """Sparse GPT-2 with a per-head layout at ``{model: 2}``: dropout 0
    (against the JAX engine) and 0.1 (against the port at one rank)."""
    mesh = make_mesh({"model": world})
    model, params = sparse_gpt2()
    eng = engine(model, params, config(ADAM), mesh)
    out = {"sparse": {"losses": train(eng, sparse_batches(STEPS)),
                      "master": whole_master(eng)}}
    # the layouts the layer ran: the rank's heads' rows of the per-head
    # layout, cut once and cached beside the whole one
    cache = model.layer._layout_cache
    out["layouts"] = {str(k): np.asarray(v) for k, v in cache.items()}
    model, params = sparse_gpt2(**DROPOUT)
    eng = engine(model, params, config(ADAM), mesh)
    out["dropout"] = train(eng, sparse_batches(STEPS))
    return out


class TinyVocabModel:
    """An embedding cut over ``model`` by vocab rows and a linear
    readout: the smallest model whose vocab-parallel embedding gradient
    is row-sparse, ids in each rank's vocab range (the JAX tests'
    ``TinyEmbModel`` with a partition spec)."""

    VOCAB, HID, SEQ = 64, 8, 4

    def init(self, seed):
        rng = np.random.default_rng(seed)
        return {"emb": (rng.normal(size=(self.VOCAB, self.HID)) * 0.1)
                .astype(np.float32),
                "w": (rng.normal(size=(self.HID,)) * 0.1).astype(np.float32)}

    def partition_specs(self, mesh=None):
        from deepspeed_tpu_torch.utils.params import MODEL
        return {"emb": (MODEL, None), "w": (None,)}

    def sparse_gradient_paths(self):
        return ("emb",)

    def apply(self, params, batch, rng=None, train=True, **kw):
        import torch
        from deepspeed_tpu_torch.models.layers import \
            vocab_parallel_embedding
        x = vocab_parallel_embedding(params["emb"], batch["input_ids"])
        return torch.mean((x @ params["w"] - batch["y"]) ** 2)


def vocab_batches(n, rows=ROWS * 2):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, TinyVocabModel.VOCAB,
                                       size=(rows, TinyVocabModel.SEQ))
             .astype(np.int32),
             "y": rng.normal(size=(rows, TinyVocabModel.SEQ))
             .astype(np.float32)} for _ in range(n)]


def vocab_config(dp):
    return {"train_batch_size": ROWS * 2,
            "train_micro_batch_size_per_gpu": ROWS * 2 // dp,
            "steps_per_print": 10 ** 9,
            "optimizer": {"type": "Adam", "params": {"lr": 0.01}},
            "sparse_gradients": True, "zero_optimization": {"stage": 0}}


def counted_train(eng, batches, steps):
    """Losses, and each step's collectives by verb (calls, bytes)."""
    from deepspeed_tpu_torch import comm
    dp, r = eng.dp_world_size, eng.dp_rank
    it = iter([rank_rows(b, r, dp) for b in batches])
    losses, calls = [], []
    for _ in range(steps):
        comm.counter.reset()
        losses.append(float(eng.train_batch(it)))
        calls.append((dict(comm.counter.calls), dict(comm.counter.bytes)))
    return losses, calls


def onebit_sparse_grad_world(rank, world, seed, save_dir):
    """``{data: 2, model: 2}``: GPT-2 under OneBitAdam through
    ``freeze_step`` (then saved to ``save_dir`` and loaded into a fresh
    engine), and the vocab-parallel embedding under
    ``sparse_gradients``."""
    mesh = make_mesh({"data": 2, "model": 2})
    model, params = gpt2()
    eng = engine(model, params, config(ONEBIT, stage=0, dp=2, clip=0.0),
                 mesh)
    losses, calls = counted_train(eng, gpt2_batches(ONEBIT_STEPS),
                                  ONEBIT_STEPS)
    st = eng.opt_state
    out = {"onebit": {"losses": losses, "calls": calls,
                      "master": whole_master(eng),
                      "replicated": replicated_leaves(eng),
                      "n_local": eng.master.numel(),
                      "errors": (tuple(st.worker_error.shape),
                                 tuple(st.server_error.shape))}}
    eng.save_checkpoint(save_dir, sync=True)
    eng.wait_checkpoint(save_dir)
    model, params = gpt2()
    fresh = engine(model, params, config(ONEBIT, stage=0, dp=2, clip=0.0),
                   mesh)
    fresh.load_checkpoint(save_dir, strict=True)
    # unpadded: 1-bit Adam writes into the flat buffers' padding, which
    # a checkpoint does not hold (ROADMAP C's caveat)
    out["onebit"]["loaded"] = {
        "master_equal": bool(np.array_equal(whole_master(fresh),
                                            whole_master(eng))),
        "moments_equal": bool(np.array_equal(
            fresh._gather_unpadded(fresh.opt_state.exp_avg),
            eng._gather_unpadded(st.exp_avg))),
        "errors_zero": not bool(fresh.opt_state.worker_error.any()
                                or fresh.opt_state.server_error.any()),
        "errors_were_set": bool(st.worker_error.any())}
    vocab = TinyVocabModel()
    eng = engine(vocab, vocab.init(0), vocab_config(2), mesh)
    losses, calls = counted_train(eng, vocab_batches(4), 4)
    out["sparse_grad"] = {"losses": losses, "calls": calls,
                          "master": whole_master(eng),
                          "paths": eng.sparse_gradient_paths()}
    return out
