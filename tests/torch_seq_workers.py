"""The rank functions of the port's sequence-parallel tests.

Each runs on one gloo rank of :func:`tests.torch_dist.run_ranks` (this
module imports neither jax nor the JAX package) and returns numpy
arrays and plain values.  The inputs are made here from numpy seeds, so
the parent test makes the same ones with the same helpers and holds the
results against the JAX package on the same mesh, or against the port
in one process.
"""

import numpy as np
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining
from deepspeed_tpu_torch.models.bert import random_params as bert_params
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.models.layers import recomputed
from deepspeed_tpu_torch.ops.transformer.ring_attention import (
    RingFlashAttention, ring_attention, visible_keys)
from deepspeed_tpu_torch.parallel import make_mesh

WORLD = 4
# the tiny GPT-2 of the JAX package's ring engine test
TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)
BERT_TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=64, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0, max_predictions_per_seq=6)
ROWS = 4          # rows of a global batch
SEQ = 64
STEPS = 5
CLIP = 0.05       # binds on the tiny model: the norm goes through the stats
ADAM = {"type": "Adam", "params": {"lr": 3e-3, "eps": 1e-3}}
LAMB = {"type": "Lamb", "params": {"lr": 3e-3}}
# the op's cases: (name, mesh dims, batch, causal, key mask, scale)
OP_SHAPE = dict(s=32, h=2, d=8)
OP_CASES = (
    ("seq4_bidir", {"seq": 4}, 2, False, None, None),
    ("seq4_causal", {"seq": 4}, 2, True, None, None),
    ("seq4_padded_chunk", {"seq": 4}, 2, False, "chunk", None),
    ("seq4_padded_row", {"seq": 4}, 2, False, "row", None),
    ("seq4_scale", {"seq": 4}, 2, True, None, 0.05),
    ("data2_seq2", {"data": 2, "seq": 2}, 4, False, "chunk", None),
    ("data2_seq2_causal", {"data": 2, "seq": 2}, 4, True, None, None),
)


def config(opt, stage=2, dp=1, clip=CLIP, **extra):
    cfg = {"train_batch_size": ROWS,
           "train_micro_batch_size_per_gpu": ROWS // dp,
           "gradient_clipping": clip, "steps_per_print": 10 ** 9,
           "optimizer": dict(opt), "zero_optimization": {"stage": stage}}
    cfg.update(extra)
    return cfg


def op_inputs(b, s, h, d, key_mask, seed=0):
    """q, k, v, the gradient of the output and the additive key mask
    (None, the last quarter of the keys padded, or row 1 padded whole)
    as numpy fp32."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    kpm = None
    if key_mask == "chunk":
        kpm = np.zeros((b, s), np.float32)
        kpm[:, 3 * s // 4:] = -1e9
    elif key_mask == "row":
        kpm = np.zeros((b, s), np.float32)
        kpm[1] = -1e9
    return q, k, v, g, kpm


def gpt2_batches(n, seed=1, rows=ROWS):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, TINY["vocab_size"],
                                       size=(rows, SEQ)).astype(np.int32)}
            for _ in range(n)]


def eval_batch():
    """A GPT-2 batch with its labels given (the ids shifted left, -100
    at the end), so ``eval_batch`` returns the loss."""
    ids = gpt2_batches(1, seed=9)[0]["input_ids"]
    labels = np.concatenate([ids[:, 1:], np.full((ids.shape[0], 1), -100,
                                                 np.int32)], axis=1)
    return {"input_ids": ids, "labels": labels}


def bert_batches(n, seed=2, rows=ROWS):
    """BERT pretraining batches: MLM labels spread over the whole row
    (row r has 3 + 3r of them, so rows past the first hold more than
    ``max_predictions_per_seq``: the later ones are dropped over the
    whole row), token types and a padded last row."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, BERT_TINY["vocab_size"],
                           size=(rows, SEQ)).astype(np.int32)
        labels = np.full((rows, SEQ), -100, np.int32)
        for r in range(rows):
            pos = rng.permutation(SEQ)[:3 + 3 * r]
            labels[r, pos] = ids[r, pos]
        mask = np.ones((rows, SEQ), np.int32)
        mask[-1, SEQ - 12:] = 0
        out.append({"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": (np.arange(SEQ)[None] >= SEQ // 2)
                    .repeat(rows, 0).astype(np.int32),
                    "masked_lm_labels": labels,
                    "next_sentence_labels": rng.integers(0, 2, size=rows)
                    .astype(np.int32)})
    return out


def rank_rows(batch, dp_rank, dp):
    """A data rank's contiguous rows of a global batch (every seq rank
    of it takes the same rows)."""
    def cut(x):
        per = x.shape[0] // dp
        return x[dp_rank * per:(dp_rank + 1) * per]

    return {k: cut(v) for k, v in batch.items()}


def gpt2(attn_impl="ring"):
    cfg = GPT2Config(**dict(TINY, attn_impl=attn_impl))
    return GPT2LMHead(cfg), random_params(cfg, 0)


def bert(attn_impl="ring"):
    cfg = BertConfig(**dict(BERT_TINY, attn_impl=attn_impl))
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


# ------------------------------------------------------------- the op
def _op_case(mesh, b, causal, key_mask, scale):
    """This rank's chunk of the case's out and of dq, dk, dv (the
    per-pair kernels' plain versions here), by :class:`RingFlashAttention`
    on a pre-scaled q and by :func:`ring_attention` recomputed in backward
    (as a layer under ``remat`` runs it: the recompute rotates the
    chunks again)."""
    n, r = mesh.size("seq"), mesh.index("seq")
    dp, dr = mesh.size("data"), mesh.index("data")
    q, k, v, g, kpm = op_inputs(b, **OP_SHAPE, key_mask=key_mask)
    sl, rows = OP_SHAPE["s"] // n, b // dp

    def cut(x):
        return torch.from_numpy(np.ascontiguousarray(
            x[dr * rows:(dr + 1) * rows, r * sl:(r + 1) * sl]))

    out = {}
    for path in ("recomputed", "flash"):
        qkv = [cut(x).requires_grad_() for x in (q, k, v)]
        mask = None if kpm is None else cut(kpm)
        if path == "recomputed":
            o = recomputed(lambda *a: ring_attention(
                *a, mesh=mesh, causal=causal, key_padding_mask=mask,
                scale=scale))(*qkv)
        else:
            qq = qkv[0]
            if scale is not None:
                qq = qq * (scale * OP_SHAPE["d"] ** 0.5)
            o = RingFlashAttention.apply(qq, qkv[1], qkv[2],
                                         visible_keys(mask), causal, mesh,
                                         "seq")
        grads = torch.autograd.grad(o, qkv, cut(g))
        out[path] = [o.detach().numpy()] + [x.numpy() for x in grads]
    return out


def op_world(rank, world, seed):
    """Every case of the op on one world of 4 ranks."""
    got = {}
    meshes = {}
    for name, dims, b, causal, key_mask, scale in OP_CASES:
        key = tuple(sorted(dims.items()))
        if key not in meshes:
            meshes[key] = make_mesh(dims)
        got[name] = _op_case(meshes[key], b, causal, key_mask, scale)
    return got


# ----------------------------------------------------------- engines
def seq_world(rank, world, seed, save_dir):
    """Every engine case on one world of 4 ranks: GPT-2 at data 2 × seq
    2 (ZeRO-2, ZeRO-0 and ZeRO-3, Adam, a binding clip; a checkpoint
    saved; eval), GPT-2 at seq 2 × model 2 and BERT at data 2 × seq 2 (Lamb,
    ZeRO-1)."""
    out = {}
    d2s2 = make_mesh({"data": 2, "seq": 2})
    model, params = gpt2()
    eng = engine(model, params, config(ADAM, dp=2), d2s2)
    comm.counter.reset()
    out["gpt2_d2s2"] = {"losses": train(eng, gpt2_batches(STEPS)),
                        "psum_bytes": comm.counter.bytes.get("psum", 0),
                        "shard_bytes": (eng._gshard.numel()
                                        * eng._gshard.element_size()),
                        "master": whole_master(eng),
                        "seq_rank": eng.sp_rank, "dp_rank": eng.dp_rank}
    eng.save_checkpoint(save_dir, sync=True)
    eng.wait_checkpoint(save_dir)
    batch = rank_rows(eval_batch(), eng.dp_rank, 2)
    out["gpt2_d2s2"]["eval_logits"] = eng.eval_batch(
        {"input_ids": batch["input_ids"]}).numpy()
    out["gpt2_d2s2"]["eval_loss"] = float(eng.eval_batch(batch))

    for stage in (0, 3):
        model, params = gpt2()
        eng = engine(model, params, config(ADAM, stage=stage, dp=2), d2s2)
        out[f"zero{stage}"] = {"losses": train(eng, gpt2_batches(STEPS)),
                               "master": whole_master(eng)}

    s2m2 = make_mesh({"seq": 2, "model": 2})
    model, params = gpt2()
    eng = engine(model, params, config(ADAM), s2m2)
    out["gpt2_s2m2"] = {"losses": train(eng, gpt2_batches(STEPS)),
                        "master": whole_master(eng)}

    model, params = bert()
    eng = engine(model, params, config(LAMB, stage=1, dp=2), d2s2)
    out["bert_d2s2"] = {"losses": train(eng, bert_batches(STEPS)),
                        "master": whole_master(eng)}
    return out
