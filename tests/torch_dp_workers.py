"""The rank functions of the port's data-parallel tests.

Each runs on one gloo rank of :func:`tests.torch_dist.run_ranks` (this
module imports neither jax nor the JAX package, so the spawned ranks
stay light) and returns numpy arrays and plain values.  The inputs are
made here from numpy seeds, so the parent test, which holds the results
against the JAX engine or against the port at one rank, makes the same
ones with the same helpers.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.bert import BertConfig, BertForPreTraining
from deepspeed_tpu_torch.models.bert import random_params as bert_params
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead, \
    random_params
from deepspeed_tpu_torch.parallel import (DATA_AXIS, Mesh, MeshGrid,
                                          make_mesh)
from deepspeed_tpu_torch.runtime import csr_tensor
from deepspeed_tpu_torch.runtime import engine as engine_module

from .torch_simple_model import SimpleModel, random_batches

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            max_position_embeddings=64, embd_dropout=0.0, attn_dropout=0.0,
            resid_dropout=0.0)
BERT_TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=64, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
HIDDEN = 16
MICRO = 2        # rows a rank takes per micro-batch
STEPS = 10

# (model, ZeRO stage, optimizer, accumulation, clipping): every stage,
# optimizer and accumulation for each model, clipping on
TRAJECTORY_CASES = {
    "gpt2": [(0, "Adam", 1, 1.0), (1, "Lamb", 2, 1.0), (2, "Adam", 2, 1.0),
             (2, "Lamb", 1, 1.0)],
    "simple": [(0, "Lamb", 2, 1.0), (1, "Adam", 1, 1.0), (2, "Lamb", 2, 1.0),
               (2, "Adam", 1, 1.0)],
}


def dp_config(stage, opt, acc, clip, world, micro=MICRO, **extra):
    cfg = {"train_batch_size": micro * acc * world,
           "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": acc, "gradient_clipping": clip,
           "steps_per_print": 10 ** 9,
           "optimizer": {"type": opt, "params": {"lr": 3e-3}},
           "zero_optimization": {"stage": stage}}
    cfg.update(extra)
    return cfg


def gpt2_batches(n, rows, seq=32, seed=1):
    """``n`` global micro-batches of ``rows`` rows."""
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, size=(rows, seq))
             .astype(np.int32)} for _ in range(n)]


def simple_batches(n, rows, seed=1):
    return random_batches(n, rows, HIDDEN, seed=seed)


def model_and_params(kind):
    if kind == "gpt2":
        return GPT2LMHead(GPT2Config(**TINY)), \
            random_params(GPT2Config(**TINY), seed=0)
    if kind == "bert":
        return BertForPreTraining(BertConfig(**BERT_TINY)), \
            bert_params(BertConfig(**BERT_TINY), seed=3)
    model = SimpleModel(HIDDEN, nlayers=2)
    return model, model.init(0)


def rank_slice(batch, rank, world):
    """Rank ``rank``'s contiguous rows of a global batch (a dict or a
    tuple of arrays)."""
    def cut(x):
        per = x.shape[0] // world
        return x[rank * per:(rank + 1) * per]

    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return type(batch)(cut(v) for v in batch)


def global_batches(kind, n, world, seed=1):
    rows = MICRO * world
    return gpt2_batches(n, rows, seed=seed) if kind == "gpt2" \
        else simple_batches(n, rows, seed=seed)


def port_engine(kind, config, mesh, device="cpu", model_kw=None):
    model, params = model_and_params(kind)
    if model_kw:
        model = GPT2LMHead(GPT2Config(**dict(TINY, **model_kw)))
    engine, *_ = tds.initialize(model=model, model_parameters=params,
                                config=config, mesh=mesh, device=device)
    return engine


def state(engine):
    """The unpadded master and moments (gathered over the ranks) and the
    optimizer step."""
    flat, opt = engine.flat, engine.opt_state
    return {"master": flat.gather_master_unpadded(engine.master),
            "exp_avg": flat.gather_master_unpadded(opt.exp_avg),
            "exp_avg_sq": flat.gather_master_unpadded(opt.exp_avg_sq),
            "step": int(opt.step)}


# --------------------------------------------------------- trajectories
def trajectories(rank, world, seed, kind):
    """Every case of ``TRAJECTORY_CASES[kind]``: ``STEPS`` steps on this
    rank's slices of the global batches; the returned losses are the
    engine's (the mean over every rank's micro-batches)."""
    mesh = make_mesh({DATA_AXIS: world})
    out = {}
    for case in TRAJECTORY_CASES[kind]:
        stage, opt, acc, clip = case
        engine = port_engine(kind, dp_config(stage, opt, acc, clip, world),
                             mesh)
        it = iter([rank_slice(b, rank, world)
                   for b in global_batches(kind, STEPS * acc, world)])
        losses = [float(engine.train_batch(it)) for _ in range(STEPS)]
        out[case] = {"losses": losses, **state(engine)}
    return out


FP16 = {"enabled": True, "initial_scale_power": 8, "loss_scale_window": 3,
        "hysteresis": 2, "min_loss_scale": 1}
POISON_STEP = 3


def fp16_batches(world):
    """SimpleModel's global batches with an inf in row 0 (rank 0's
    slice) at step ``POISON_STEP``."""
    batches = simple_batches(STEPS, MICRO * world)
    x, y = batches[POISON_STEP]
    x = x.copy()
    x[0, 0] = np.float32(np.inf)
    batches[POISON_STEP] = (x, y)
    return batches


def fp16_trace(rank, world, seed):
    """ZeRO-2 fp16 under the dynamic scaler at dp=``world``: losses, the
    scale after every step and the skipped count after every step."""
    mesh = make_mesh({DATA_AXIS: world})
    engine = port_engine("simple", dp_config(2, "Adam", 1, 0.0, world,
                                             fp16=dict(FP16)), mesh)
    losses, scales, skipped = [], [], []
    for batch in fp16_batches(world):
        losses.append(float(engine.train_batch(
            iter([rank_slice(batch, rank, world)]))))
        scales.append(float(engine.loss_scale))
        skipped.append(int(engine.skipped_steps))
    return {"losses": losses, "scales": scales, "skipped": skipped,
            "master": state(engine)["master"]}


# ---------------------------------------------------- port against itself
def bert_batches(n, rows, seq=32, seed=2):
    """BERT pretraining batches whose rows carry different numbers of
    MLM labels (row r: 1 + 2r), so the two halves of a batch count
    different labels, and a padded last row."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 128, size=(rows, seq)).astype(np.int32)
        labels = np.full((rows, seq), -100, np.int32)
        for r in range(rows):
            pos = rng.permutation(seq)[:1 + 2 * r]
            labels[r, pos] = ids[r, pos]
        mask = np.ones((rows, seq), np.int32)
        mask[-1, seq - 5:] = 0
        out.append({"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": (np.arange(seq)[None] >= seq // 2)
                    .repeat(rows, 0).astype(np.int32),
                    "masked_lm_labels": labels,
                    "next_sentence_labels": rng.integers(0, 2, size=rows)
                    .astype(np.int32)})
    return out


SELF_STEPS = 3
DROPOUT = dict(embd_dropout=0.1, attn_dropout=0.1, resid_dropout=0.1)


def one_rank_meshes(world):
    """A mesh of one rank for every rank, each on its own gloo group
    (``new_group`` is collective: every rank makes every group)."""
    groups = [dist.new_group([r]) for r in range(world)]
    return Mesh({DATA_AXIS: 1}, groups={DATA_AXIS: groups[dist.get_rank()]})


# (ZeRO stage, accumulation) of the bf16 runs on a mesh of one rank,
# which sum the micro-batches' gradients in fp32 as the engine without a
# mesh does
ONE_RANK_BF16 = [(1, 2), (2, 2)]


def one_rank_bf16(stage, acc, mesh):
    """SimpleModel in bf16 at ZeRO ``stage`` with accumulation ``acc``
    on ``mesh`` (None: the engine without one), ``SELF_STEPS`` steps:
    losses and master."""
    engine = port_engine("simple", dp_config(stage, "Adam", acc, 1.0, 1,
                                             bf16={"enabled": True}), mesh)
    it = iter(simple_batches(SELF_STEPS * acc, MICRO))
    return {"losses": [float(engine.train_batch(it))
                       for _ in range(SELF_STEPS)],
            "master": engine.master.numpy().copy()}


def lone_eval_slice():
    """Rank 0's slice of the BERT batch that rank 0 evaluates alone."""
    return rank_slice(bert_batches(1, MICRO * 2, seed=5)[0], 0, 2)


def self_consistency(rank, world, seed):
    """(a) BERT at ZeRO-2 on this rank's slices of batches whose halves
    count different MLM labels: losses and master, and before them rank
    0's loss of its slice of a batch computed by rank 0 alone through
    the model, which must issue no collective; (b) a forward with
    dropout on the SAME batch on every rank: the local loss; (c) GPT-2
    with dropout at ZeRO-2, and SimpleModel in bf16 at ZeRO-1 and 2 with
    accumulation (:data:`ONE_RANK_BF16`), on a mesh of one rank (this
    rank's own gloo group): losses and master, for the engine without a
    mesh."""
    out = {}
    mesh = make_mesh({DATA_AXIS: world})
    engine = port_engine("bert", dp_config(2, "Lamb", 1, 1.0, world), mesh)
    if rank == 0:
        batch = {k: torch.from_numpy(v) for k, v in lone_eval_slice().items()}
        out["lone_loss"] = float(engine.module.apply(engine.params, batch,
                                                     train=False))
    dist.barrier()
    it = iter([rank_slice(b, rank, world)
               for b in bert_batches(SELF_STEPS, MICRO * world)])
    out["bert_losses"] = [float(engine.train_batch(it))
                          for _ in range(SELF_STEPS)]
    out["bert_master"] = state(engine)["master"]
    out["bert_eval"] = float(engine.eval_batch(rank_slice(
        bert_batches(1, MICRO * world, seed=7)[0], rank, world)))

    engine = port_engine("gpt2", dp_config(2, "Adam", 1, 0.0, world), mesh,
                         model_kw=DROPOUT)
    out["dropout_loss"] = float(engine.forward(gpt2_batches(1, MICRO)[0]))

    one = one_rank_meshes(world)
    engine = port_engine("gpt2", dp_config(2, "Adam", 1, 1.0, 1), one,
                         model_kw=DROPOUT)
    it = iter(gpt2_batches(SELF_STEPS, MICRO))
    out["one_rank_losses"] = [float(engine.train_batch(it))
                              for _ in range(SELF_STEPS)]
    out["one_rank_master"] = engine.master.numpy().copy()
    for stage, acc in ONE_RANK_BF16:
        out[("bf16", stage, acc)] = one_rank_bf16(stage, acc, one)
    return out


# ----------------------------------------------------------- checkpoints
CKPT_STAGE = 2


def gpt2_samples(n=48, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": row}
            for row in rng.integers(0, 256, size=(n, 32)).astype(np.int32)]


def ckpt_config(world, micro=MICRO):
    return dp_config(CKPT_STAGE, "Adam", 1, 0.0, world, micro=micro,
                     scheduler={"type": "WarmupLR",
                                "params": {"warmup_min_lr": 0.0,
                                           "warmup_max_lr": 3e-3,
                                           "warmup_num_steps": 6}})


def loader_engine(world, mesh, micro=MICRO, data_seed=0):
    model, params = model_and_params("gpt2")
    engine, *_ = tds.initialize(model=model, model_parameters=params,
                                config=ckpt_config(world, micro), mesh=mesh,
                                device="cpu",
                                training_data=gpt2_samples(seed=data_seed))
    return engine


def checkpoints(rank, world, seed, jax_dir, dp1_dir, out_dir):
    """(a) load the JAX dp=2 checkpoint in ``jax_dir``: the state; then
    2 steps and a save into ``out_dir/port``: the state saved; (b) load
    the port's dp=1 checkpoint in ``dp1_dir`` and take 3 steps: losses;
    (c) from step 0, 3 steps, a save into ``out_dir/resume``, 3 more:
    the last 3 losses.  Every engine trains from its dataloader."""
    mesh = make_mesh({DATA_AXIS: world})
    out = {}
    engine = loader_engine(world, mesh)
    engine.load_checkpoint(jax_dir, strict=True)
    out["loaded"] = state(engine)
    for _ in range(2):
        engine.train_batch()
    out["cursor"] = engine.training_dataloader.state_dict()
    engine.save_checkpoint(os.path.join(out_dir, "port"))
    engine.wait_checkpoint()
    out["saved"] = state(engine)

    engine = loader_engine(world, mesh)
    engine.load_checkpoint(dp1_dir, strict=True)
    out["from_dp1_losses"] = [float(engine.train_batch()) for _ in range(3)]

    engine = loader_engine(world, mesh)
    for _ in range(3):
        engine.train_batch()
    engine.save_checkpoint(os.path.join(out_dir, "resume"), sync=True)
    engine.wait_checkpoint()
    out["resume_losses"] = [float(engine.train_batch()) for _ in range(3)]
    out["files"] = sorted(os.listdir(os.path.join(out_dir, "resume")))
    return out


# ------------------------------------------------ collectives and CSR
def csr_dense(rows=64, cols=8, touched=(3, 17, 42), seed=0):
    rng = np.random.default_rng(seed)
    d = np.zeros((rows, cols), np.float32)
    for r in touched:
        d[r] = rng.normal(size=cols)
    return d


class TinyEmbModel:
    """Embedding and a linear readout: the smallest model whose
    word-embedding gradient is row-sparse (the JAX tests'
    ``TinyEmbModel``)."""

    VOCAB, HID, SEQ = 64, 8, 4

    def init(self, seed):
        rng = np.random.default_rng(seed)
        return {"emb": (rng.normal(size=(self.VOCAB, self.HID)) * 0.1)
                .astype(np.float32),
                "w": (rng.normal(size=(self.HID,)) * 0.1).astype(np.float32)}

    def sparse_gradient_paths(self):
        return ("emb",)

    def apply(self, params, batch, rng=None, train=True, **kw):
        x = params["emb"][batch["input_ids"]]
        pred = x @ params["w"]
        return torch.mean((pred - batch["y"]) ** 2)


class TinyTiedModel(TinyEmbModel):
    """The readout ties to the embedding, so its gradient is dense:
    declaring it sparse is a model bug the engine must make loud."""

    def apply(self, params, batch, rng=None, train=True, **kw):
        x = params["emb"][batch["input_ids"]]
        return torch.mean((x @ params["emb"].T) ** 2)


def emb_batches(n, rows):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, TinyEmbModel.VOCAB,
                                       size=(rows, TinyEmbModel.SEQ))
             .astype(np.int32),
             "y": rng.normal(size=(rows, TinyEmbModel.SEQ))
             .astype(np.float32)} for _ in range(n)]


def train_emb(model, sparse, mesh, rank, world, steps=4, rows=8):
    config = {"train_batch_size": rows, "steps_per_print": 10 ** 9,
              "optimizer": {"type": "Adam", "params": {"lr": 0.01}},
              "sparse_gradients": sparse}
    engine, *_ = tds.initialize(model=model,
                                model_parameters=model.init(0),
                                config=config, mesh=mesh, device="cpu")
    losses = [float(engine.train_batch(iter([rank_slice(b, rank, world)])))
              for b in emb_batches(steps, rows)]
    return losses, engine.master.numpy().copy()


def collectives(rank, world, seed):
    """The comm verbs, the CSR exchange and the engine's
    ``sparse_gradients`` path on ``world`` ranks."""
    mesh = make_mesh({DATA_AXIS: -1})
    out = {"inferred": mesh.shape[DATA_AXIS],
           "process_info": (mesh.size(DATA_AXIS), mesh.index(DATA_AXIS))}
    x = torch.tensor([float(rank)])
    out["psum"] = comm.psum(x, DATA_AXIS, mesh).numpy()
    out["pmean"] = comm.pmean(x, DATA_AXIS, mesh).numpy()
    out["pmax"] = comm.pmax(x, DATA_AXIS, mesh).numpy()
    out["pmin"] = comm.pmin(x, DATA_AXIS, mesh).numpy()
    out["axis_index"] = comm.axis_index(DATA_AXIS, mesh)
    out["axis_size"] = comm.axis_size(DATA_AXIS, mesh)
    full = torch.arange(16, dtype=torch.float32)
    local = comm.reduce_scatter(full, DATA_AXIS, mesh=mesh)
    out["scattered"] = local.numpy()
    out["roundtrip"] = comm.all_gather(local, DATA_AXIS, mesh=mesh).numpy()
    out["stacked"] = comm.all_gather(local, DATA_AXIS, tiled=False,
                                     mesh=mesh).numpy()
    inplace = full.clone()
    comm.psum(inplace, DATA_AXIS, mesh, out=inplace)
    out["psum_inplace"] = inplace.numpy()
    # rank r sends [100 r + 2 i, 100 r + 2 i + 1] to rank i
    chunks = (100 * rank + torch.arange(2 * world)).float()
    out["a2a"] = comm.all_to_all(chunks, DATA_AXIS, 0, 0, mesh=mesh).numpy()
    out["a2a_stacked"] = comm.all_to_all(
        chunks.view(1, world, 2), DATA_AXIS, 1, 0, tiled=False,
        mesh=mesh).numpy()
    out["a2a_u8"] = comm.all_to_all(chunks.to(torch.uint8), DATA_AXIS, 0, 0,
                                    mesh=mesh).numpy()
    piece, handle = comm.reduce_scatter(full, DATA_AXIS, mesh=mesh,
                                        async_op=True)
    handle.wait()
    out["async_rs"] = piece.numpy()
    gathered, handle = comm.all_gather(piece, DATA_AXIS, mesh=mesh,
                                       async_op=True)
    handle.wait()
    out["async_ag"] = gathered.numpy()

    d = csr_dense(touched=(rank, 2 * rank + 1, 50), seed=rank)
    csr = csr_tensor.CSRTensor.from_dense(torch.from_numpy(d), max_rows=4)
    out["csr_local"] = (csr.indices.numpy(), csr.values.numpy())
    out["csr_sum"] = csr_tensor.csr_allreduce(csr, DATA_AXIS, mesh).numpy()

    # an mpu in place of the mesh: a MeshGrid, and a Megatron-style one
    # whose data-parallel group is a process group
    class WorldMpu:
        def get_data_parallel_world_size(self):
            return dist.get_world_size()

        def get_data_parallel_rank(self):
            return dist.get_rank()

        def get_data_parallel_group(self):
            return dist.group.WORLD

        def get_model_parallel_world_size(self):
            return 1

    batches = [rank_slice(b, rank, world)
               for b in simple_batches(2, MICRO * world)]
    config = dp_config(2, "Adam", 1, 1.0, world)
    for name, kw in (("mesh", {"mesh": mesh}),
                     ("grid", {"mpu": MeshGrid(mesh)}),
                     ("mpu", {"mpu": WorldMpu()})):
        model, params = model_and_params("simple")
        engine, *_ = tds.initialize(model=model, model_parameters=params,
                                    config=config, device="cpu", **kw)
        out[f"{name}_dp"] = engine.dp_world_size
        out[f"{name}_losses"] = [float(engine.train_batch(iter([b])))
                                 for b in batches]

    calls = []
    real = engine_module.csr_allreduce

    def spy(c, axis_name, mesh=None):
        calls.append((c.nnz, c.dense_shape))
        return real(c, axis_name, mesh)

    engine_module.csr_allreduce = spy
    try:
        out["dense"] = train_emb(TinyEmbModel(), False, mesh, rank, world)
        out["dense_calls"] = list(calls)
        out["sparse"] = train_emb(TinyEmbModel(), True, mesh, rank, world)
        out["sparse_calls"] = list(calls)
        _, tied = train_emb(TinyTiedModel(), True, mesh, rank, world,
                            steps=1)
        out["tied_nan"] = bool(np.isnan(tied).any())
    finally:
        engine_module.csr_allreduce = real
    return out


# ---------------------------------------------------------------- rollback
def rollback(rank, world, seed, out_dir):
    """Resilience at dp=``world`` (policy rollback, patience 2): 2 steps,
    a save, then NaN inputs in rank 0's slice only for 2 steps, which
    every rank skips and then rolls back from; 4 clean steps after.  A
    fault-free run beside it gives the reference losses."""
    mesh = make_mesh({DATA_AXIS: world})
    config = dp_config(0, "Adam", 1, 0.0, world, resilience={
        "enabled": True, "policy": "rollback", "divergence_patience": 2,
        "max_rollbacks": 1})
    clean = [rank_slice(b, rank, world)
             for b in simple_batches(6, MICRO * world, seed=3)]
    ref = port_engine("simple", config, mesh)
    for b in clean[:2]:
        ref.train_batch(iter([b]))
    ref_losses = [float(ref.train_batch(iter([b]))) for b in clean[2:]]

    engine = port_engine("simple", config, mesh)
    for b in clean[:2]:
        engine.train_batch(iter([b]))
    engine.save_checkpoint(out_dir, sync=True)
    engine.wait_checkpoint()
    bad = []
    for b in clean[2:4]:
        x, y = b
        if rank == 0:
            x = np.full_like(x, np.nan)
        bad.append((x, y))
    nan_losses = [float(engine.train_batch(iter([b]))) for b in bad]
    out = {"nan_losses": nan_losses,
           "rollbacks": engine._rollback_mgr.rollbacks_used,
           "steps_after_rollback": engine.global_steps,
           "skipped_after_rollback": engine.skipped_steps}
    out["losses"] = [float(engine.train_batch(iter([b]))) for b in clean[2:]]
    out["ref_losses"] = ref_losses
    return out
